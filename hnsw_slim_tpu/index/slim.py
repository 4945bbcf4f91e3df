"""HNSW-Slim index: pruned CHAL graph + threshold-aware search.

Counterpart of HierarchicalNSWSlim (reference hnswalg_slim.h) and
the HnswSlimStrategy pipeline (hnsw_slim_strategy.h:34-120): build (or take) a
vanilla HNSW, run the two-stage pruning conversion, then serve batched
queries with greedy descent above the threshold level and beam search at and
below it.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..config import HnswConfig, SearchConfig, SlimConfig
from ..graph import search as gs
from ..graph.prune import convert_to_slim
from ..graph.types import ChalGraph
from .hnsw import HnswIndex


def _timed_call(search_fn, queries, k):
    import time as _time

    t0 = _time.perf_counter()
    search_fn(queries, k=k)
    return _time.perf_counter() - t0


@functools.partial(
    jax.jit,
    static_argnames=(
        "max_level", "threshold_level", "cap0", "cap", "ef", "k",
        "max_iters", "metric", "pop_width", "stages", "scan_width",
        "seed_width", "seed_strata",
    ),
)
def _chal_search_jit(nbr, lvl_off, entry, vectors, vn, q, *, max_level,
                     threshold_level, cap0, cap, ef, k, max_iters,
                     metric, pop_width=1, dense0=None, dense_up=None,
                     rank_up=None, allowed=None, stages=(), scan_width=0,
                     seed_width=0, up_vecs=None, up_ids=None,
                     seed_strata=0):
    return gs.chal_search(
        nbr, lvl_off, entry, vectors, vn, q,
        max_level=max_level, threshold_level=threshold_level,
        cap0=cap0, cap=cap, ef=ef, k=k, max_iters=max_iters,
        metric=metric,
        precision=jax.lax.Precision.HIGHEST,
        pop_width=pop_width,
        dense0=dense0,
        dense_up=dense_up,
        rank_up=rank_up,
        allowed=allowed,
        stages=stages,
        scan_width=scan_width,
        seed_width=seed_width,
        up_vecs=up_vecs,
        up_ids=up_ids,
        seed_strata=seed_strata,
    )


@functools.partial(
    jax.jit,
    static_argnames=(
        "max_level", "threshold_level", "cap0", "cap", "ef_max", "k",
        "max_iters", "metric", "pop_width", "stages", "scan_width",
        "seed_width", "seed_strata",
    ),
)
def _chal_search_dyn_jit(nbr, lvl_off, entry, vectors, vn, q, ef_eff, *,
                         max_level, threshold_level, cap0, cap, ef_max, k,
                         max_iters, metric, pop_width=1, dense0=None,
                         dense_up=None, rank_up=None, stages=(),
                         scan_width=0, seed_width=0, up_vecs=None,
                         up_ids=None, seed_strata=0):
    return gs.chal_search(
        nbr, lvl_off, entry, vectors, vn, q,
        max_level=max_level, threshold_level=threshold_level,
        cap0=cap0, cap=cap, ef=ef_max, k=k, max_iters=max_iters,
        metric=metric,
        precision=jax.lax.Precision.HIGHEST,
        pop_width=pop_width,
        ef_eff=ef_eff,
        dense0=dense0,
        dense_up=dense_up,
        rank_up=rank_up,
        stages=stages,
        scan_width=scan_width,
        seed_width=seed_width,
        up_vecs=up_vecs,
        up_ids=up_ids,
        seed_strata=seed_strata,
    )


class HnswSlimIndex:
    """Pruned (Slim) index. Single-writer: mutation happens through
    whole-graph conversion, like the reference (hnswalg_slim.h:149-152)."""

    def __init__(self, metric: str = "l2", search_cfg: SearchConfig | None = None):
        self.metric = metric
        self.scfg = search_cfg or SearchConfig()
        self.graph: ChalGraph | None = None
        self.vectors = None
        self.vn = None
        self.dense0 = None  # optional dense level-0 serving layout
        # optional dense upper-level serving layout: rank_up i32[N_pad]
        # (append-only row rank among level>=1 nodes, -1 below) +
        # dense_up[l-1] i32[R_pad, cap] rows for level l (see search.
        # make_rank_fetch). host_chal: host numpy mirror {nbr,lvl_off,level}
        # — when set, host-side consumers (patches, checkpoints, integrity)
        # read it instead of pulling device arrays
        self.dense_up: tuple | None = None
        self.rank_up = None
        self._rank_np: np.ndarray | None = None
        self._n_up = 0
        self.host_chal: dict | None = None
        # exact-seed table (seed_width > 1): vectors + ids of all level>=1
        # nodes, keyed by graph identity so /updateIndex growth rebuilds it
        self.up_vecs = None
        self.up_ids = None
        self._up_for = None

    def densify_level0(self) -> int:
        """Explode the level-0 CHAL slices into a dense [N, cap0] row array.
        Serving from dense rows turns the per-hop neighbor fetch into one
        row transaction (+~25%% QPS at 1M) at the cost of cap0*4 bytes/node
        of extra HBM (the CHAL arrays remain the persisted format)."""
        import numpy as np

        from ..persist.patch import _level_rows

        c = self._host_chal()
        n_pad = int(self.graph.level.shape[0])  # incl. node padding, so the
        # serving shape stays stable across /updateIndex growth
        n = min(n_pad, len(c["lvl_off"]))
        rows = np.full((n_pad, self.graph.cap0), -1, np.int32)
        rows[:n] = _level_rows(c, 0, n, self.graph.cap0)
        self.dense0 = jnp.asarray(rows)
        return int(self.dense0.nbytes)

    def update_dense0(self, host_chal: dict, ids) -> None:
        """Refresh dense level-0 rows for `ids` in place (pow2-bucketed row
        scatter) instead of rebuilding + re-uploading the full [N, cap0]
        array — 256 MB of H2D per /updateIndex at 1M when only ~1e4 rows
        changed. Falls back to densify_level0 when the node-padding bucket
        grew (dense0's shape must track the padded graph)."""
        import numpy as np

        from ..graph.build import _next_pow2, _pad_to
        from ..persist.patch import _subset_rows

        n_pad = int(self.graph.level.shape[0])
        if self.dense0 is None or int(self.dense0.shape[0]) != n_pad:
            self.densify_level0()
            return
        ids = np.unique(np.asarray(ids, np.int64))
        ids = ids[(ids >= 0) & (ids < len(host_chal["lvl_off"]))]
        if not len(ids):
            return
        rows = _subset_rows(host_chal, 0, ids, self.graph.cap0)
        cap = max(1024, _next_pow2(len(ids)))
        ids_pad = _pad_to(ids.astype(np.int32), cap, fill=int(ids[0]))
        # pad rows by duplicating row 0 so the duplicated id scatters the
        # same value (duplicate writes in one scatter are benign only then)
        rows_pad = np.broadcast_to(
            rows[0], (cap, rows.shape[1])
        ).copy()
        rows_pad[: len(ids)] = rows
        self.dense0 = self.dense0.at[jnp.asarray(ids_pad)].set(
            jnp.asarray(rows_pad.astype(np.int32))
        )

    def _host_chal(self) -> dict:
        from ..persist.patch import to_np

        return self.host_chal if self.host_chal is not None else to_np(
            self.graph
        )

    def densify_upper(self, bucket: int = 4096) -> int:
        """Build the dense upper-level serving layout: one rank indirection
        (i32[N_pad], -1 for level-0-only nodes) + per-level dense rows
        i32[R_pad, cap]. Upper levels hold ~1/30 of the nodes, so the whole
        layout is a few MB at 1M — and the per-hop fetch becomes one row
        transaction instead of per-edge scalar gathers from the flat CHAL
        array. Ranks are append-only so /updateIndex maintains the layout
        with O(touched) scatters (update_dense_upper)."""
        c = self._host_chal()
        from ..persist.patch import _subset_rows

        n_pad = int(self.graph.level.shape[0])
        lvl = np.full(n_pad, -1, np.int32)
        lvl[: len(c["level"])] = c["level"]
        up_ids = np.nonzero(lvl >= 1)[0]
        rank = np.full(n_pad, -1, np.int32)
        rank[up_ids] = np.arange(len(up_ids), dtype=np.int32)
        r_pad = -(-max(len(up_ids), 1) // bucket) * bucket
        dense = []
        for l in range(1, self.graph.max_level + 1):
            rows = np.full((r_pad, self.graph.cap), -1, np.int32)
            sel = lvl[up_ids] >= l
            if sel.any():
                rows[rank[up_ids[sel]]] = _subset_rows(
                    c, l, up_ids[sel], self.graph.cap
                )
            dense.append(jnp.asarray(rows))
        self._rank_np = rank
        self._n_up = len(up_ids)
        self.rank_up = jnp.asarray(rank)
        self.dense_up = tuple(dense)
        return int(sum(d.nbytes for d in dense)) + int(self.rank_up.nbytes)

    def update_dense_upper(self, host_chal: dict, ids) -> None:
        """Refresh dense upper rows for `ids` in place: new level>=1 nodes
        get appended ranks (scatter), changed rows scatter at their existing
        ranks. Falls back to a full densify_upper when the graph's node
        padding, max_level, or the rank capacity bucket changed."""
        from ..graph.build import _next_pow2, _pad_to
        from ..persist.patch import _subset_rows

        n_pad = int(self.graph.level.shape[0])
        lmax = self.graph.max_level
        if (
            self.dense_up is None
            or self._rank_np is None
            or len(self._rank_np) != n_pad
            or len(self.dense_up) != lmax
        ):
            self.densify_upper()
            return
        lvl_np = host_chal["level"]
        ids = np.unique(np.asarray(ids, np.int64))
        ids = ids[(ids >= 0) & (ids < len(lvl_np))]
        if not len(ids):
            return
        up = ids[lvl_np[ids] >= 1]
        # slot reuse resamples levels: a node that dropped below level 1
        # must lose its rank (else its stale dense rows stay reachable)
        down = ids[(lvl_np[ids] < 1) & (self._rank_np[ids] >= 0)]
        if len(down):
            self._rank_np[down] = -1
            cap = max(256, _next_pow2(len(down)))
            d_pad = _pad_to(down.astype(np.int32), cap, fill=int(down[0]))
            self.rank_up = self.rank_up.at[jnp.asarray(d_pad)].set(
                jnp.int32(-1)
            )
        if not len(up):
            return
        fresh = up[self._rank_np[up] < 0]
        if len(fresh):
            r_cap = int(self.dense_up[0].shape[0])
            if self._n_up + len(fresh) > r_cap:
                self.densify_upper()
                return
            self._rank_np[fresh] = np.arange(
                self._n_up, self._n_up + len(fresh), dtype=np.int32
            )
            self._n_up += len(fresh)
            cap = max(256, _next_pow2(len(fresh)))
            f_pad = _pad_to(fresh.astype(np.int32), cap, fill=int(fresh[0]))
            self.rank_up = self.rank_up.at[jnp.asarray(f_pad)].set(
                jnp.asarray(_pad_to(
                    self._rank_np[fresh], cap,
                    fill=int(self._rank_np[fresh][0]),
                ))
            )
        for l in range(1, lmax + 1):
            # refresh rows for nodes at this level, CLEAR rows for ranked
            # nodes whose (possibly lowered) level no longer reaches it
            sel = up
            rows = np.full((len(sel), self.graph.cap), -1, np.int32)
            at_l = lvl_np[sel] >= l
            if at_l.any():
                rows[at_l] = _subset_rows(
                    host_chal, l, sel[at_l], self.graph.cap
                )
            ranks = self._rank_np[sel]
            cap = max(256, _next_pow2(len(sel)))
            r_pad = _pad_to(ranks, cap, fill=int(ranks[0]))
            rows_pad = np.broadcast_to(rows[0], (cap, rows.shape[1])).copy()
            rows_pad[: len(sel)] = rows
            self.dense_up = (
                self.dense_up[: l - 1]
                + (self.dense_up[l - 1].at[jnp.asarray(r_pad)].set(
                    jnp.asarray(rows_pad)
                ),)
                + self.dense_up[l:]
            )

    @classmethod
    def from_hnsw(
        cls,
        hnsw: HnswIndex,
        slim_cfg: SlimConfig,
        search_cfg: SearchConfig | None = None,
        count_level0_hubs: bool = False,
        verbose: bool = False,
    ) -> "HnswSlimIndex":
        """convertFromHNSW (hnswalg_slim.h:867-1108)."""
        idx = cls(metric=hnsw.cfg.metric, search_cfg=search_cfg)
        idx.vectors = hnsw.vectors
        idx.vn = hnsw.vn
        idx.graph = convert_to_slim(
            hnsw.graph, hnsw.vectors, hnsw.vn, slim_cfg,
            metric=hnsw.cfg.metric, count_level0_hubs=count_level0_hubs,
            verbose=verbose,
        )
        return idx

    @classmethod
    def build(
        cls,
        vectors: np.ndarray,
        hnsw_cfg: HnswConfig | None = None,
        slim_cfg: SlimConfig | None = None,
        max_batch: int = 4096,
        verbose: bool = False,
    ) -> "HnswSlimIndex":
        """Full HnswSlimStrategy pipeline: build HNSW then convert."""
        hnsw = HnswIndex(hnsw_cfg or HnswConfig(), max_batch=max_batch)
        hnsw.build(vectors, verbose=verbose)
        return cls.from_hnsw(hnsw, slim_cfg or SlimConfig.from_ratios(),
                             verbose=verbose)

    def set_ef(self, ef: int) -> None:
        import dataclasses

        self.scfg = dataclasses.replace(self.scfg, ef=ef)

    def autotune(self, ef: int, **kw) -> dict:
        """Per-graph serve-time knob calibration — see autotune_index."""
        return autotune_index(self, ef, **kw)

    def _seed_table(self):
        """(up_vecs f32[n_up_pad, d], up_ids i32[n_up_pad]) over all
        level>=1 nodes — the one-matmul exact upper seed (chal_search
        seed_width). ~N/32 rows; rebuilt when the graph object changes."""
        if self.up_ids is None or self._up_for is not id(self.graph):
            lv = (
                self.host_chal["level"] if self.host_chal is not None
                else np.asarray(self.graph.level)
            )
            ids = np.nonzero(np.asarray(lv) >= 1)[0].astype(np.int32)
            pad = max(64, 1 << max(0, len(ids) - 1).bit_length())
            idp = np.full(pad, -1, np.int32)
            idp[: len(ids)] = ids
            self.up_ids = jnp.asarray(idp)
            self.up_vecs = jax.block_until_ready(
                self.vectors[jnp.asarray(np.maximum(idp, 0))]
            )
            self._up_for = id(self.graph)
        return self.up_vecs, self.up_ids

    def search(self, queries: np.ndarray, k: int,
               filter_mask: np.ndarray | None = None,
               entry: jnp.ndarray | None = None):
        """(dists f32[B,k], ids i32[B,k]) — searchKnn (hnswalg_slim.h:2030).

        filter_mask bool[N]: BaseFilterFunctor semantics (hnswlib.h:124-133)
        — disallowed ids are traversed but never returned. Filtering runs
        in-kernel on an allowed-only result track whose worst entry sets the
        termination bound, so every query returns k allowed ids whenever k
        allowed nodes are reachable (no post-hoc under-fill).

        entry: optional per-query entry points i32[B] (multi-component union
        graphs, parallel/flat_union.py); default = the graph enterpoint."""
        g = self.graph
        ent = g.entry if entry is None else entry
        ef = max(self.scfg.ef, k)
        b = int(np.asarray(queries).shape[0])
        stages = tuple(
            b // f for f in self.scfg.straggler_stages if b // f >= 32
        )
        up_vecs = up_ids = None
        if self.scfg.seed_width > 1 and g.threshold_level == 0 \
                and g.max_level >= 1:
            up_vecs, up_ids = self._seed_table()
        if self.scfg.dynamic_ef and filter_mask is None:
            out = _chal_search_dyn_jit(
                g.nbr, g.lvl_off, ent, self.vectors, self.vn,
                jnp.asarray(np.asarray(queries, np.float32)),
                jnp.int32(min(ef, self.scfg.ef_max)),
                max_level=g.max_level, threshold_level=g.threshold_level,
                cap0=g.cap0, cap=g.cap, ef_max=self.scfg.ef_max,
                k=k,
                max_iters=self.scfg.iters(),
                metric=self.metric, pop_width=self.scfg.pop_width,
                dense0=self.dense0, dense_up=self.dense_up,
                rank_up=self.rank_up,
                stages=stages, scan_width=self.scfg.scan_width,
                seed_width=self.scfg.seed_width,
                up_vecs=up_vecs, up_ids=up_ids,
                seed_strata=self.scfg.seed_strata,
            )
            # ONE device->host transfer for all four outputs: each separate
            # np.asarray is its own sync round-trip
            d, i, hops, dcomp = jax.device_get(out)
            self.last_stats = {
                "hops": int(hops.sum()),
                "distance_computations": int(dcomp.sum()),
            }
            return d, i
        allowed = None
        max_iters = self.scfg.iters()
        if filter_mask is not None:
            allowed = jnp.asarray(np.asarray(filter_mask, bool))
            # heavy filtering needs more hops to fill the allowed-only track;
            # scale the lockstep iteration cap by the disallowed density
            density = max(float(np.mean(np.asarray(filter_mask, bool))), 0.05)
            max_iters = int(max_iters / density) + 8
        out = _chal_search_jit(
            g.nbr, g.lvl_off, ent, self.vectors, self.vn,
            jnp.asarray(np.asarray(queries, np.float32)),
            max_level=g.max_level, threshold_level=g.threshold_level,
            cap0=g.cap0, cap=g.cap, ef=ef, k=k,
            max_iters=max_iters,
            metric=self.metric, pop_width=self.scfg.pop_width,
            dense0=self.dense0, dense_up=self.dense_up,
            rank_up=self.rank_up,
            allowed=allowed,
            stages=stages, scan_width=self.scfg.scan_width,
            seed_width=self.scfg.seed_width,
            up_vecs=up_vecs, up_ids=up_ids,
            seed_strata=self.scfg.seed_strata,
        )
        # ONE device->host transfer (see dynamic_ef branch note)
        d, i, hops, dcomp = jax.device_get(out)
        # metric_hops / metric_distance_computations (hnswalg_slim.h:70-71)
        self.last_stats = {
            "hops": int(hops.sum()),
            "distance_computations": int(dcomp.sum()),
        }
        return d, i

    def search_async(self, queries, k: int):
        """Dispatch one search without the device->host sync; returns the
        device output tuple (d, ids, hops, dcomp). Steady-state serving
        overlaps the host round-trip of batch k with the device compute of
        batch k+1 — jax.device_get the result when needed."""
        g = self.graph
        ef = max(self.scfg.ef, k)
        b = int(np.asarray(queries).shape[0])
        stages = tuple(
            b // f for f in self.scfg.straggler_stages if b // f >= 32
        )
        return _chal_search_jit(
            g.nbr, g.lvl_off, g.entry, self.vectors, self.vn,
            jnp.asarray(np.asarray(queries, np.float32)),
            max_level=g.max_level, threshold_level=g.threshold_level,
            cap0=g.cap0, cap=g.cap, ef=ef, k=k,
            max_iters=self.scfg.iters(),
            metric=self.metric, pop_width=self.scfg.pop_width,
            dense0=self.dense0, dense_up=self.dense_up,
            rank_up=self.rank_up,
            stages=stages, scan_width=self.scfg.scan_width,
        )

    def index_size(self) -> int:
        """Graph-only bytes in the reference's accounting
        (hnswalg_slim.h:2435-2443)."""
        if self.host_chal is not None:
            # host-resident CHAL: the device graph carries placeholder
            # nbr/lvl_off (serving runs on dense0/dense_up); account from
            # the host mirror with the same formula as chal_bytes
            c = self.host_chal
            levels = c["level"]
            real = levels >= 0
            total = int((c["lvl_off"][:, -1] - c["lvl_off"][:, 0]).sum())
            return int(16 * int(real.sum()) + 2 * int(levels[real].sum())
                       + 4 * total)
        return self.graph.chal_bytes()

    def check_integrity(self) -> dict:
        """hnswalg_slim.h checkIntegrity :2387-2433 + the hierarchical
        membership rule: a level-l neighbor must itself be a level-l node
        unless l == threshold_level. Walks EVERY node at every level (the
        reference does too) — vectorized over dense level rows instead of a
        per-node loop, so 1M nodes check in milliseconds."""
        from ..persist.patch import _level_rows

        g = self.graph
        n = g.n
        c = self._host_chal()
        levels = c["level"]
        off = c["lvl_off"]
        total_edges = 0
        for l in range(g.max_level + 1):
            cap_l = g.cap0 if l == 0 else g.cap
            sizes = off[:, l + 1] - off[:, l]
            assert (sizes >= 0).all()
            assert sizes.max(initial=0) <= cap_l, f"level {l} over cap"
            assert not (sizes[levels < l] > 0).any(), "slice on low node"
            rows = _level_rows(c, l, n, cap_l)  # [N, cap_l] sorted, -1 pad
            valid = rows >= 0
            ids = rows[valid]
            assert (ids < n).all(), f"id out of range @{l}"
            assert not (rows == np.arange(n)[:, None]).any(), f"self loop @{l}"
            dup = valid[:, 1:] & (rows[:, 1:] == rows[:, :-1])
            assert not dup.any(), f"dup edge @{l}"
            if l != g.threshold_level:
                assert (levels[ids] == l).all(), f"membership rule @{l}"
            total_edges += int(sizes.sum())
        return {"edges": total_edges, "bytes": g.chal_bytes()}


def autotune_index(idx, ef: int, k: int = 10, sample: int = 256,
             recall_slack: float = 0.002, queries=None, gt=None,
             configs=None, verbose: bool = False) -> dict:
    """Serve-time kernel-knob calibration for one index/graph at one ef.

    Replaces the hand-tuned per-ef (pop_width, scan_width) table that was
    overfit to one bench graph (the same knobs that tuned the 1M
    reference graph dropped an 8M union graph's recall
    0.999->0.78, and made recall(ef) non-monotone mid-curve). Sweeps a
    small config grid on `sample` probe queries against exact GT computed
    on-device, then keeps the fastest config whose recall is within
    `recall_slack` of the best observed — the lossless reference-semantics
    config (pop 8, no scan cap) is always in the grid, so calibrated
    recall can never fall below it. Sets idx.scfg and returns the report.

    Probe queries default to blends of stored vectors (0.85*a + 0.15*b):
    near-manifold, never exactly a stored point. Pass queries/gt to
    calibrate on a real sample instead. Results are cached per (ef, k).
    """
    import dataclasses
    import time as _time

    cache = getattr(idx, "_autotune_cache", None)
    if cache is None:
        cache = idx._autotune_cache = {}
    key = (ef, k)
    if key in cache:
        idx.scfg = dataclasses.replace(
            idx.scfg, ef=ef, **cache[key]["knobs"]
        )
        return cache[key]

    from .bruteforce import exact_topk

    g = idx.graph
    n = g.n
    vecs = getattr(idx, "vectors", None)
    if vecs is not None:
        vnv = idx.vn
    else:
        # SlimQ stores no raw vectors; probe/GT against the external
        # rerank dataset (hnsw_slimq_strategy.h:145 setDataset)
        if getattr(idx, "_dataset_dev", None) is None:
            idx._dataset_dev = jnp.asarray(
                np.asarray(idx.dataset, np.float32)
            )
        vecs = idx._dataset_dev
        vnv = jnp.sum(vecs.astype(jnp.float32) ** 2, axis=1)
    if queries is None:
        # deterministic near-manifold probes: blend pairs of stored rows
        idx_a = (np.arange(sample, dtype=np.int64) * 2654435761) % n
        idx_b = (idx_a * 40503 + 12345) % n
        va = np.asarray(vecs[jnp.asarray(idx_a.astype(np.int32))])
        vb = np.asarray(vecs[jnp.asarray(idx_b.astype(np.int32))])
        queries = (0.85 * va + 0.15 * vb).astype(np.float32)
    queries = np.asarray(queries, np.float32)
    if gt is None:
        _, gt = exact_topk(
            vecs, vnv, jnp.asarray(queries), k=k,
            metric=idx.metric, n_valid=n,
        )
        gt = np.asarray(gt)
        # union indexes search in a remapped id space (FlatUnionIndex
        # returns original global ids); move GT into the same space
        gids = getattr(idx, "gids", None)
        if gids is not None:
            gt = np.asarray(gids)[gt]
    gt = np.asarray(gt)

    if configs is None:
        # (pop_width, scan_width): first entry = lossless reference
        # semantics (every candidate lane survives to the merge). The tight
        # scan lanes (96-192) are where high-ef speed lives: the buffer
        # merge sorts ef+scan lanes, so scan ~= a small multiple of the pop
        # window beats scan ~= 2*ef by 3-4x once ef >= 192 (tune_095 sweep:
        # pop 16 / scan 96-128 took the 1M 0.95 point 886 -> 5460+ qps).
        configs = [(8, 0), (16, 0)]
        if ef > 96:
            configs += [(16, 96), (16, 128), (16, 192)]
    # dedupe configs whose effective scan lane count is identical
    # (scan >= pop*cap0 or >= the auto width changes nothing)
    w0 = g.cap0
    seen, uniq = set(), []
    for pop, scan in configs:
        eff = min(pop * w0, scan or max(2 * ef, 128))
        if (pop, eff) not in seen:
            seen.add((pop, eff))
            uniq.append((pop, scan))
    configs = uniq
    report, results = [], []
    saved = idx.scfg
    for pop, scan in configs:
        idx.scfg = dataclasses.replace(
            saved, ef=ef, pop_width=pop, scan_width=scan
        )
        _, ids = idx.search(queries, k=k)  # compile + warm
        dt = min(
            _timed_call(idx.search, queries, k) for _ in range(2)
        )
        rec = sum(
            len(set(a.tolist()) & set(b.tolist()))
            for a, b in zip(np.asarray(ids), gt)
        ) / gt.size
        report.append({"pop_width": pop, "scan_width": scan,
                       "recall": round(rec, 4),
                       "qps": round(len(queries) / dt, 1)})
        results.append((rec, dt, pop, scan))
        if verbose:
            print(f"  autotune ef={ef} pop={pop} scan={scan}: "
                  f"recall={rec:.4f} qps={len(queries)/dt:.0f}",
                  flush=True)
    best_rec = max(r for r, *_ in results)
    ok = [r for r in results if r[0] >= best_rec - recall_slack]
    _, _, pop, scan = min(ok, key=lambda r: r[1])
    knobs = {"pop_width": pop, "scan_width": scan}
    idx.scfg = dataclasses.replace(saved, ef=ef, **knobs)
    out = {"knobs": knobs, "grid": report, "probe_recall": best_rec}
    cache[key] = out
    return out
