"""Vanilla HNSW index: batched build + batched search.

Counterpart of hnswlib::HierarchicalNSW (reference hnswalg.h) and
the HnswStrategy pipeline (hnsw_strategy.h:15-61). The index holds dense
per-level adjacency (LevelGraph) plus the vector array on device.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..config import HnswConfig, SearchConfig
from ..graph import search as gs
from ..graph.build import HnswBuilder
from ..graph.types import LevelGraph
from ..ops import distance


@functools.partial(
    jax.jit,
    static_argnames=("max_level", "ef", "k", "max_iters", "metric", "pop_width"),
)
def _search_jit(adjs, entry, vectors, vn, q, *, max_level, ef, k, max_iters,
                metric, pop_width=1, allowed=None):
    return gs.level_search(
        adjs, entry, vectors, vn, q,
        max_level=max_level, ef=ef, k=k, max_iters=max_iters,
        metric=metric,
        precision=jax.lax.Precision.HIGHEST,
        pop_width=pop_width,
        allowed=allowed,
    )


@jax.jit
def _row_deg(a: jnp.ndarray) -> jnp.ndarray:
    return jnp.sum((a >= 0).astype(jnp.int32), axis=1)


def _compact_rows(a: np.ndarray) -> np.ndarray:
    """Left-compact -1 holes in each row (keeps fetch-width semantics)."""
    n, w = a.shape
    key = np.where(a >= 0, 0, 1)
    order = np.argsort(key, axis=1, kind="stable")
    return np.take_along_axis(a, order, axis=1)


# NND's exact-kNN candidate sets over-prune via the RNG rule on clustered
# data at scale (kNN recall plateaus ~0.75 at 1M — README self-build notes);
# the reference-faithful insertion build (hnswalg.h:1248-1376 semantics)
# stays servable. Auto-selection keeps NND's speed where it is safe.
AUTO_NND_MAX_N = 200_000


def resolve_build_strategy(strategy: str, n: int) -> str:
    """Resolve "auto" to a concrete build strategy for an n-point build:
    NN-descent below AUTO_NND_MAX_N, insertion rounds at scale."""
    if strategy != "auto":
        return strategy
    return "nnd" if n < AUTO_NND_MAX_N else "insert"


class HnswIndex:
    """Build-once, query-many vanilla HNSW.

    strategy="auto" (default): NN-descent below AUTO_NND_MAX_N points,
    insertion rounds at scale (resolve_build_strategy).
    strategy="nnd": NN-descent kNN graph + heuristic
    prune/symmetrize (graph/build.py build_by_nnd) — all-batched device work.
    strategy="insert": reference-faithful bulk-synchronous insertion rounds
    mirroring hnswalg.h addPoint.
    """

    def __init__(self, cfg: HnswConfig, search_cfg: SearchConfig | None = None,
                 max_batch: int = 4096, strategy: str = "auto",
                 nnd_opts: dict | None = None):
        self.cfg = cfg
        self.scfg = search_cfg or SearchConfig(ef=cfg.ef_search)
        self.max_batch = max_batch
        self.strategy = strategy
        self.nnd_opts = nnd_opts or {}
        self.graph: LevelGraph | None = None
        self.levels: np.ndarray | None = None
        self.vectors = None
        self.vn = None

    def build(self, vectors: np.ndarray, verbose: bool = False) -> None:
        self.vectors = jnp.asarray(np.asarray(vectors, np.float32))
        if self.cfg.store_dtype == "bfloat16":
            self.vectors = self.vectors.astype(jnp.bfloat16)
        self.vn = distance.sq_norms(self.vectors)
        strategy = resolve_build_strategy(
            self.strategy, int(np.asarray(vectors).shape[0])
        )
        if strategy == "nnd":
            from ..graph.build import build_by_nnd

            self.graph, self.levels = build_by_nnd(
                self.cfg, np.asarray(vectors), verbose=verbose,
                **self.nnd_opts,
            )
        else:
            builder = HnswBuilder(self.cfg, self.max_batch)
            self.graph, self.levels = builder.build(vectors, verbose=verbose)
            # adopt the builder's host mirror (byte-identical to the device
            # adjacency): host_adj() then never needs the D2H pull
            self._adj_np = builder.adj_np

    def _grow_capacity(self, n_new: int, lmax_new: int, bucket: int = 16384):
        """Grow vectors/adjacency/levels to a capacity bucket >= n_new.
        Buckets keep the insert-path program shapes stable across updates
        (each new shape compiles a program); padding
        rows carry level -1 and no edges — unreachable by any traversal."""
        from ..graph.build import _pad_to

        cap_cur = int(self.vectors.shape[0])
        cap_new = -(-max(n_new, cap_cur) // bucket) * bucket
        adj_np = self.host_adj()
        lmax_old = self.graph.max_level
        caps = [self.cfg.maxM0] + [self.cfg.maxM] * max(lmax_new, lmax_old)
        if cap_new > cap_cur:
            pad = cap_new - cap_cur
            self.vectors = jnp.concatenate([
                self.vectors,
                jnp.zeros((pad, self.vectors.shape[1]), self.vectors.dtype),
            ])
            self.levels = _pad_to(
                np.asarray(self.levels, np.int32), cap_new, fill=-1
            )
            adj_np = [_pad_to(a, cap_new) for a in adj_np]
        adj_dev = []
        for l in range(max(lmax_new, lmax_old) + 1):
            if l <= lmax_old:
                d = self.graph.adjs[l]
                if d.shape[0] < cap_new:  # device-side growth, no re-upload
                    d = jnp.concatenate([
                        d, jnp.full((cap_new - d.shape[0], d.shape[1]), -1,
                                    jnp.int32),
                    ])
                else:
                    # device copy: the fused insert apply DONATES its
                    # adjacency input, which would invalidate the buffer
                    # self.graph.adjs still references (queries may run
                    # concurrently against the pre-update graph)
                    d = d.copy()
            else:
                d = jnp.full((cap_new, caps[l]), -1, jnp.int32)
                adj_np.append(np.full((cap_new, caps[l]), -1, np.int32))
            adj_dev.append(d)
        self._adj_np = adj_np
        return adj_np, adj_dev

    def add_points(self, new_vectors: np.ndarray,
                   verbose: bool = False) -> np.ndarray:
        """Incremental insertion into the existing graph (reference addPoint
        loop, hnsw_slim_server.cc:128-135). In-place on capacity-bucketed
        arrays: only the batch crosses from host to device and program
        shapes stay stable across updates. Returns the ids of every vanilla
        row the insert wrote (new nodes + reverse-connect targets) — the
        working set for the incremental slim re-prune."""
        from ..graph.build import sample_levels

        import os
        import time as _time

        timing = os.environ.get("SLIM_TIMING")
        marks = []
        t0 = _time.perf_counter()

        new_np = np.asarray(new_vectors, np.float32)
        b = len(new_np)
        n_old = self.graph.n
        n_new = n_old + b
        new_levels = sample_levels(b, self.cfg.mult, self.cfg.seed + n_old)
        lmax_old = self.graph.max_level
        lmax = max(lmax_old, int(new_levels.max(initial=0)))

        adj_np, adj_dev = self._grow_capacity(n_new, lmax)
        if timing:
            marks.append(("grow", _time.perf_counter() - t0))
            t0 = _time.perf_counter()
        ids = np.arange(n_old, n_new)
        self.levels = np.asarray(self.levels, np.int32).copy()
        self.levels[ids] = new_levels
        self.vectors = self.vectors.at[jnp.asarray(ids)].set(
            jnp.asarray(new_np).astype(self.vectors.dtype)
        )
        self.vn = distance.sq_norms(self.vectors)
        if timing:
            self.vn.block_until_ready()
            marks.append(("vecs", _time.perf_counter() - t0))
            t0 = _time.perf_counter()

        from ..graph.build import _next_pow2, _pad_to

        # pow2 pad bucket sized to the update (a 1000-vector /updateIndex
        # batch pads to 1024, not the build's 4096 — 4x less search work);
        # the bucket set stays small so compiled shapes are reused
        pad = min(self.max_batch, max(512, _next_pow2(b)))
        builder = HnswBuilder(self.cfg, self.max_batch, pad_batch=pad)
        # row degrees from the (hole-free) adjacency: every writer keeps
        # rows left-compacted, so occupancy == count of non-(-1) entries
        deg_dev = [_row_deg(a) for a in adj_dev]
        entry = int(np.asarray(self.graph.entry))
        cur_maxlevel = lmax_old
        done = n_old
        collect: dict[int, list[np.ndarray]] = {}
        while done < n_new:
            bsz = min(builder._batch_size(done), n_new - done)
            batch_ids = np.arange(done, done + bsz)
            builder._insert_batch_bulk(
                batch_ids, self.levels, entry, cur_maxlevel, self.vectors,
                self.vn, adj_dev, deg_dev, lmax, collect=collect,
            )
            for p in batch_ids:  # enterpoint update (hnswalg.h:1369-1374)
                if self.levels[p] > cur_maxlevel:
                    cur_maxlevel = int(self.levels[p])
                    entry = int(p)
            done += bsz
        builder._check_overflow_monitor(verbose)
        if timing:
            marks.append(("insert_batches", _time.perf_counter() - t0))
            t0 = _time.perf_counter()
        # ONE host-mirror sync per level over every touched row (inserted
        # ids + reverse-connect targets): gather the post-apply rows, write
        # them into the numpy mirror the server/incremental paths consume
        touched = [np.zeros(0, np.int64)]
        for l, parts in collect.items():
            rows = np.unique(np.concatenate(parts))
            touched.append(rows)
            rp = _pad_to(rows, _next_pow2(max(len(rows), 32)),
                         fill=int(rows[0]))
            got = np.asarray(adj_dev[l][jnp.asarray(rp)])
            adj_np[l][rows] = got[: len(rows)]
        self.graph = LevelGraph(
            adjs=tuple(adj_dev),
            level=jnp.asarray(self.levels),
            entry=jnp.asarray(np.int32(entry)),
            max_level=lmax,
            n_real=n_new,
        )
        if timing:
            marks.append(("mirror_sync", _time.perf_counter() - t0))
            print("  add_points timing: " + " ".join(
                f"{k}={v:.2f}s" for k, v in marks
            ), flush=True)
        return np.unique(np.concatenate(touched))

    def replace_points(self, slots: np.ndarray, new_vectors: np.ndarray,
                       verbose: bool = False) -> tuple[np.ndarray, np.ndarray]:
        """Reuse deleted slots for new vectors (replace_deleted=true,
        hnswalg.h addPoint replace path / hnsw_slim_server_patch.cc:268-270):
        sever every edge touching the slot, overwrite its vector, then
        re-insert it through the normal batched insert machinery.
        Returns (touched_row_ids, level_changed_ids)."""
        from ..graph.build import HnswBuilder, sample_levels

        slots = np.asarray(slots, np.int64)
        assert len(slots) == len(new_vectors)
        new_dev = jnp.asarray(np.asarray(new_vectors, np.float32)).astype(
            self.vectors.dtype
        )
        # in-place device update: only the batch is uploaded
        self.vectors = self.vectors.at[jnp.asarray(slots)].set(new_dev)
        levels_arr = np.asarray(self.levels).copy()
        slot_set = set(slots.tolist())
        touched = [slots]

        host_adj = getattr(self, "_adj_np", None)
        adj_np, adj_dev = [], []
        for l, a_dev in enumerate(self.graph.adjs):
            a = (host_adj[l].copy() if host_adj is not None
                 else np.asarray(a_dev))
            a[slots] = -1  # out-edges
            mask = np.isin(a, slots)  # in-edges
            in_rows = np.nonzero(mask.any(axis=1))[0]
            touched.append(in_rows.astype(np.int64))
            a[mask] = -1
            a = _compact_rows(a)
            adj_np.append(a)
            # ship only the severed rows to the device copy (pow2-padded so
            # the scatter shape — and its compiled program — is stable)
            from ..graph.build import _next_pow2, _pad_to

            upd = np.unique(np.concatenate([slots, in_rows]))
            upd_pad = _pad_to(upd.astype(np.int64), _next_pow2(len(upd)),
                              fill=int(upd[0])) if len(upd) else upd
            adj_dev.append(
                a_dev.at[jnp.asarray(upd_pad)].set(jnp.asarray(a[upd_pad]))
            )
        # fresh levels for reused slots (getRandomLevel per insert).
        # Intentional deviation from the reference replace path (which accepts
        # any sampled level): levels are clamped to the current max_level so a
        # reused slot never raises the graph's top level / becomes enterpoint.
        # Growing a new top level would reallocate every per-level adjacency
        # array (a fresh compiled scatter program per growth); the clamp hits
        # with probability ~1/32 per replaced point x P(level > lmax) — at
        # lmax >= 3 that is < 1e-4 of replacements, with no measurable recall
        # effect (upper levels only accelerate descent; the entrypoint still
        # covers the graph).
        old_levels = levels_arr[slots].copy()
        levels_arr[slots] = sample_levels(
            len(slots), self.cfg.mult, self.cfg.seed + int(slots[0])
        )
        lmax = self.graph.max_level
        levels_arr[slots] = np.minimum(levels_arr[slots], lmax)
        level_changed = slots[levels_arr[slots] != old_levels]

        self.vn = distance.sq_norms(self.vectors)
        builder = HnswBuilder(self.cfg, self.max_batch)
        entry = int(np.asarray(self.graph.entry))
        cur_maxlevel = lmax
        if entry in slot_set:  # enterpoint was replaced: promote another node
            top = np.nonzero(levels_arr == levels_arr.max())[0]
            entry = int(top[0])
            cur_maxlevel = int(levels_arr[entry])
        for s in range(0, len(slots), self.max_batch):
            ids = slots[s : s + self.max_batch]
            touched.append(builder._insert_batch(
                ids, levels_arr, entry, cur_maxlevel, self.vectors, self.vn,
                adj_np, adj_dev, lmax,
            ))
        self.levels = levels_arr
        self._adj_np = adj_np
        self.graph = LevelGraph(
            adjs=tuple(adj_dev),  # kept in sync by _insert_batch
            level=jnp.asarray(levels_arr),
            entry=jnp.asarray(np.int32(entry)),
            max_level=lmax,
            n_real=self.graph.n,  # replacement never changes the count
        )
        return np.unique(np.concatenate(touched)), level_changed

    def host_adj(self) -> list[np.ndarray]:
        """Host mirror of the per-level adjacency (lazy; kept in sync by
        add_points/replace_points so servers never re-download the graph)."""
        if getattr(self, "_adj_np", None) is None:
            self._adj_np = [np.asarray(a) for a in self.graph.adjs]
        return self._adj_np

    def set_ef(self, ef: int) -> None:
        import dataclasses

        self.scfg = dataclasses.replace(self.scfg, ef=ef)

    def search(self, queries: np.ndarray, k: int,
               filter_mask: np.ndarray | None = None):
        """(dists f32[B, k], ids i32[B, k]) approximate top-k, ascending.

        filter_mask bool[N]: in-kernel BaseFilterFunctor (hnswlib.h:124-133)
        — traverse everything, return only allowed ids, keep searching until
        k allowed results are buffered (see graph/search.FilterTrack)."""
        g = self.graph
        ef = max(self.scfg.ef, k)
        allowed = None
        max_iters = self.scfg.iters()
        if filter_mask is not None:
            allowed = jnp.asarray(np.asarray(filter_mask, bool))
            density = max(float(np.mean(np.asarray(filter_mask, bool))), 0.05)
            max_iters = int(max_iters / density) + 8
        out = _search_jit(
            g.adjs, g.entry, self.vectors, self.vn,
            jnp.asarray(np.asarray(queries, np.float32)),
            max_level=g.max_level, ef=ef, k=k,
            max_iters=max_iters,
            metric=self.cfg.metric, pop_width=self.scfg.pop_width,
            allowed=allowed,
        )
        # ONE device->host transfer for all outputs (each separate
        # np.asarray costs its own sync round-trip)
        d, i, hops, dcomp = jax.device_get(out)
        # metric_hops / metric_distance_computations (hnswalg.h:66-67)
        self.last_stats = {
            "hops": int(hops.sum()),
            "distance_computations": int(dcomp.sum()),
        }
        return d, i

    def check_integrity(self) -> dict:
        """Structural invariants (hnswalg.h checkIntegrity :1501-1531):
        ids in range, no self loops, no duplicate edges, degree within caps."""
        g = self.graph
        n = g.n  # logical count; arrays may be capacity-padded beyond it
        levels = np.asarray(g.level)
        inbound = np.zeros(n, np.int64)
        for l, adj in enumerate(g.adjs):
            a = np.asarray(adj)
            valid = a >= 0
            assert not valid[n:].any(), f"level {l}: edge on padding row"
            assert a[valid].max(initial=0) < n, f"level {l}: id out of range"
            rows = np.arange(len(a))[:, None]
            assert not (a == rows)[valid].any(), f"level {l}: self loop"
            # edges only for nodes of sufficient level
            assert not valid[levels < l].any(), f"level {l}: edge on low node"
            for v in np.nonzero(valid.any(axis=1))[0][:1000]:
                row = a[v][a[v] >= 0]
                assert len(set(row.tolist())) == len(row), f"dup edge at {v}@{l}"
            np.add.at(inbound, a[valid], 1)
        return {
            "min_in": int(inbound[: n].min()),
            "max_in": int(inbound.max()),
            "connections": int(inbound.sum()),
        }
