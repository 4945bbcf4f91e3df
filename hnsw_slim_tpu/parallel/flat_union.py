"""Single-device serving of independently built shards: flat union graph.

The 100M recipe (SURVEY §7 step 9 / reference Table 7) builds shards
independently; on a multi-chip mesh ShardedSlimIndex serves them with an
all_gather merge. This module serves the SAME shard set on ONE chip: the
disjoint shard graphs are concatenated into a single ChalGraph (local ids
remapped to a flat id space), each query is replicated once per shard with
that shard's entry point, and the per-shard top-k are merged with one sort.
Everything reuses the tuned chal_search kernel (staged straggler compaction,
dense level-0 layout), so one chip serves N x S vectors at roughly 1/S the
single-shard QPS.

Reference analog: one HierarchicalNSWSlim over the whole set
(hnswalg_slim.h:2030-2131) — the union graph differs only in having S entry
components instead of one.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from ..config import SearchConfig
from ..graph.types import ChalGraph


class FlatUnionIndex:
    """Union-of-shards Slim index served from one device."""

    def __init__(self, metric: str = "l2",
                 search_cfg: SearchConfig | None = None):
        self.metric = metric
        self.scfg = search_cfg or SearchConfig()
        self.graph: ChalGraph | None = None
        self.entries: np.ndarray | None = None  # i32[S] flat entry ids
        self.gids = None  # i32[S*n_per] flat id -> original global id
        self.vectors = None
        self.vn = None
        self._slim = None

    @classmethod
    def from_indexes(cls, shard_indexes, metric: str = "l2",
                     search_cfg: SearchConfig | None = None,
                     store_dtype: str = "float32") -> "FlatUnionIndex":
        """shard_indexes: list of (HnswSlimIndex, global_ids i32[n_per])."""
        from ..index.slim import HnswSlimIndex

        out = cls(metric=metric, search_cfg=search_cfg)
        s = len(shard_indexes)
        graphs = [g.graph for g, _ in shard_indexes]
        n_per = graphs[0].n
        assert all(g.n == n_per for g in graphs), "equal shard sizes required"
        lmax = max(g.max_level for g in graphs)
        dim = int(np.asarray(shard_indexes[0][0].vectors).shape[1])

        levels = np.zeros((s, n_per), np.int32)
        off = np.zeros((s, n_per, lmax + 2), np.int64)
        entries = np.zeros(s, np.int32)
        gid = np.zeros((s, n_per), np.int32)
        nbr_parts = []
        edge_base = 0
        vecs = np.zeros((s, n_per, dim), np.float32)
        for i, (g, gids) in enumerate(shard_indexes):
            gr = g.graph
            o = np.asarray(gr.lvl_off, np.int64)[:n_per]
            n_edges = int(o[-1, -1])
            # remap neighbor ids into the flat space (shard i base = i*n_per)
            ids = np.asarray(gr.nbr)[:n_edges].astype(np.int64)
            nbr_parts.append(np.where(ids >= 0, ids + i * n_per, -1))
            off[i, :, : o.shape[1]] = o + edge_base
            off[i, :, o.shape[1] :] = (o[:, -1:] + edge_base)
            levels[i] = np.asarray(gr.level)[:n_per]
            entries[i] = int(np.asarray(gr.entry)) + i * n_per
            gid[i] = gids
            vecs[i] = np.asarray(g.vectors)[:n_per]
            edge_base += n_edges

        flat = np.concatenate(nbr_parts)
        e_pad = max(1024, 1 << (len(flat) - 1).bit_length())
        nbr = np.full(e_pad, -1, np.int64)
        nbr[: len(flat)] = flat
        g0 = graphs[0]
        out.graph = ChalGraph(
            nbr=jnp.asarray(nbr.astype(np.int32)),
            lvl_off=jnp.asarray(off.reshape(s * n_per, -1).astype(np.int32)),
            level=jnp.asarray(levels.reshape(-1)),
            entry=jnp.asarray(entries[0]),
            max_level=lmax,
            threshold_level=g0.threshold_level,
            cap0=g0.cap0,
            cap=g0.cap,
        )
        out.entries = entries
        out.gids = gid.reshape(-1)
        if store_dtype == "bfloat16":
            # convert HOST-side and upload bf16 directly: an f32 device
            # intermediate at 16M is 8.2 GB of HBM (and 2x the H2D bytes)
            # that the store never needs
            import ml_dtypes

            v = jnp.asarray(
                vecs.reshape(s * n_per, dim).astype(ml_dtypes.bfloat16))
        else:
            v = jnp.asarray(vecs.reshape(s * n_per, dim))
        out.vectors = v
        from ..ops import distance

        out.vn = distance.sq_norms(out.vectors)
        out._wrap()
        return out

    def _wrap(self):
        from ..index.slim import HnswSlimIndex

        slim = HnswSlimIndex(metric=self.metric, search_cfg=self.scfg)
        slim.graph = self.graph
        slim.vectors = self.vectors
        slim.vn = self.vn
        self._slim = slim
        # shard-stratified exact-seed table: per-shard segments of equal
        # padded width U so the kernel can take top-(seed_width/S) PER
        # SHARD (seed_strata) — a union of disconnected components is only
        # reachable through seeds. Built host-side once; the vectors slice
        # reuses the (possibly bf16) store.
        lv = np.asarray(self.graph.level)
        s = len(self.entries)
        n_per = len(lv) // s
        per = [
            np.nonzero(lv[i * n_per: (i + 1) * n_per] >= 1)[0] + i * n_per
            for i in range(s)
        ]
        u = max(64, 1 << max(0, max(len(p) for p in per) - 1).bit_length())
        idp = np.full((s, u), -1, np.int32)
        for i, p in enumerate(per):
            idp[i, : len(p)] = p
        idp = idp.reshape(-1)
        slim.up_ids = jnp.asarray(idp)
        slim.up_vecs = self.vectors[jnp.asarray(np.maximum(idp, 0))]
        slim._up_for = id(self.graph)
        self._strata = s

    def densify_level0(self) -> int:
        self._slim.scfg = self.scfg
        return self._slim.densify_level0()

    def densify_upper(self) -> int:
        self._slim.scfg = self.scfg
        return self._slim.densify_upper()

    def set_ef(self, ef: int) -> None:
        self.scfg = dataclasses.replace(self.scfg, ef=ef)

    def autotune(self, ef: int, **kw) -> dict:
        """Per-graph serve-time knob calibration (index/slim.autotune_index).
        Calibrating on the union graph itself is what makes the knobs safe:
        the r2 hand-tuned 1M table dropped union recall 0.999->0.78 here."""
        from ..index.slim import autotune_index

        return autotune_index(self, ef, **kw)

    def hbm_bytes(self) -> int:
        t = (self.vectors.nbytes + self.graph.nbr.nbytes
             + self.graph.lvl_off.nbytes + self.vn.nbytes)
        if self._slim.dense0 is not None:
            t += self._slim.dense0.nbytes
        if self._slim.dense_up is not None:
            t += self._slim.rank_up.nbytes
            t += sum(d.nbytes for d in self._slim.dense_up)
        return int(t)

    def index_size(self) -> int:
        return self.graph.chal_bytes()

    def search(self, queries: np.ndarray, k: int):
        """Search the union graph. With scfg.seed_width > 1 each query runs
        ONCE: the exact-seed matmul over the union's whole upper layer picks
        top-seed_width entries ACROSS shards (cross-shard multi-entry), so
        the S-way query replication below — and its ~S x cost — disappears.
        With seed_width == 0, replicate each query per shard with that
        shard's entry point and merge per-shard top-k (reference-semantics
        fallback; each shard is a separate graph component)."""
        q = np.asarray(queries, np.float32)
        b = q.shape[0]
        s = len(self.entries)
        self._slim.scfg = self.scfg
        if self.scfg.seed_width > 1:
            self._slim.scfg = dataclasses.replace(
                self.scfg, seed_strata=self._strata
            )
            d, i = self._slim.search(q, k=k)
            self.last_stats = self._slim.last_stats
            gi = np.where(i >= 0, self.gids[np.maximum(i, 0)], -1)
            return np.asarray(d), gi
        qr = np.repeat(q, s, axis=0)  # [b*s, d]: query-major, shard-minor
        entry = jnp.asarray(np.tile(self.entries, b))
        d, i = self._slim.search(qr, k=k, entry=entry)
        self.last_stats = self._slim.last_stats
        d = d.reshape(b, s * k)
        gi = np.where(i >= 0, self.gids[np.maximum(i, 0)], -1).reshape(b, s * k)
        d = np.where(gi >= 0, d, np.inf)
        order = np.argsort(d, axis=1)[:, :k]
        return np.take_along_axis(d, order, 1), np.take_along_axis(gi, order, 1)
