"""HNSW-SlimQ: pruned CHAL graph over RaBitQ codes, no raw vectors stored.

Counterpart of HierarchicalNSWSlimQ (reference hnswalg_slimq.h)
and HnswSlimQStrategy (hnsw_slimq_strategy.h:42-165):

* build: KMeans-16 centroids + cluster assignment (the files the reference
  assumes precomputed, :44-45), a graph built from RAW distances (the rabitq
  hnsw builder also uses raw distances, index/hnsw/hnsw.hpp:381-387), the same
  two-stage Slim pruning, then a quantized payload per node:
  [cluster_id, 1-bit code, ex code] — NO raw vector (:1498-1510).
* search (:1810-1918): rotate the query (FHT), build the per-centroid
  g_add/g_error table, greedy-descend and beam on 1-bit estimates, then do
  the exact-distance rerank against the EXTERNAL dataset (setDataset,
  hnsw_slimq_strategy.h:145 — LEANN-style "index without vectors").
  Deviation: the reference reranks each popped node during traversal; we
  rerank the final top-ef once (equivalent selection, one fused matmul).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..config import HnswConfig, QuantConfig, SearchConfig, SlimConfig
from ..graph import search as gs
from ..graph.prune import convert_to_slim
from ..graph.types import ChalGraph
from ..quant import estimator as est
from ..quant.kmeans import kmeans
from ..quant.rabitq import QuantizedCodes, quantize_batch
from ..quant.rotator import FhtKacRotator
from .hnsw import HnswIndex


def pack_code_rows(codes: QuantizedCodes, cluster_ids) -> jnp.ndarray:
    """One u32 row per node: [bin (P/32 w) | ex (ex_bits*P/32 w) |
    f_add | f_rescale | f_add_ex | f_rescale_ex (bitcast f32) | cluster_id].

    The SoA layout costs ~6 HBM gather TRANSACTIONS per scored candidate
    (bin + ex + 4 factors + cluster id); packing everything the estimator
    needs into one row is a ~6x cut on the scoring path's gather
    transactions."""
    n = codes.bin_code.shape[0]
    bc = jax.lax.bitcast_convert_type
    parts = [codes.bin_code]
    if codes.ex_bits:
        parts.append(codes.ex_planes.reshape(n, -1))
    parts.append(
        bc(
            jnp.stack(
                [codes.f_add, codes.f_rescale, codes.f_add_ex,
                 codes.f_rescale_ex], axis=1,
            ),
            jnp.uint32,
        )
    )
    parts.append(cluster_ids.astype(jnp.uint32)[:, None])
    return jnp.concatenate(parts, axis=1)


def _unpack_fields(rows: jnp.ndarray, nb: int, ex_bits: int):
    """rows u32[B, W, R] -> (bin, ex, f_add, f_rescale, f_add_ex,
    f_rescale_ex, cluster_id) views."""
    bc = jax.lax.bitcast_convert_type
    b, w, _ = rows.shape
    off = nb + ex_bits * nb
    ex = (
        rows[..., nb:off].reshape(b, w, ex_bits, nb) if ex_bits else None
    )
    fl = bc(rows[..., off:off + 4], jnp.float32)
    cid = rows[..., off + 4].astype(jnp.int32)
    return rows[..., :nb], ex, fl[..., 0], fl[..., 1], fl[..., 2], fl[..., 3], cid


@functools.partial(
    jax.jit,
    static_argnames=(
        "max_level", "threshold_level", "cap0", "cap", "ef", "k",
        "max_iters", "metric", "use_ex", "pop_width", "stages", "scan_width",
        "nb", "ex_bits", "seed_width",
    ),
)
def _slimq_search_jit(
    nbr, lvl_off, entry, q_rot, packed, centroids_rot, dataset, q_raw, *,
    nb, ex_bits, max_level, threshold_level, cap0, cap, ef, k, max_iters,
    metric, use_ex, pop_width=1, dense0=None, dense_up=None, rank_up=None,
    stages=(), scan_width=0, seed_width=0, up_bits=None, up_fac=None,
    up_onehot=None, up_ids=None,
):
    b = q_rot.shape[0]
    sumq_full = jnp.sum(q_rot, axis=1)
    qn_raw = (
        jnp.sum(q_raw.astype(jnp.float32) ** 2, axis=1)
        if q_raw is not None and metric == "l2" else None
    )
    g_add_tab, _ = est.centroid_g_tables(q_rot, centroids_rot, metric)

    n_clusters = centroids_rot.shape[0]

    def score_for(idx):
        qr = q_rot if idx is None else q_rot[idx]
        sq = sumq_full if idx is None else sumq_full[idx]
        ga_tab = g_add_tab if idx is None else g_add_tab[idx]

        def score(safe_ids, valid):
            # ONE row gather fetches code planes + factors + cluster id
            rows = packed[safe_ids]  # [B, W, R]
            bc, ex, fa, fr, fae, fre, cid = _unpack_fields(rows, nb, ex_bits)
            # g_add select: one-hot over the 16 clusters (take_along_axis
            # lowers to ~10ns per-ELEMENT gathers on this backend)
            onehot = (
                cid[:, :, None]
                == jnp.arange(n_clusters, dtype=jnp.int32)[None, None, :]
            ).astype(jnp.float32)
            ga = jnp.einsum("bwc,bc->bw", onehot, ga_tab,
                            preferred_element_type=jnp.float32)
            if use_ex:
                d = est.est_dist_ex(qr, sq, bc, ex, fae, fre, ga, ex_bits)
            else:
                d = est.est_dist_1bit(qr, sq, bc, fa, fr, ga)
            return jnp.where(valid, d, jnp.inf)

        return score

    score = score_for(None)
    cur = jnp.broadcast_to(entry.astype(jnp.int32), (b,))
    curdist = score(cur[:, None], jnp.ones((b, 1), bool))[:, 0]
    always = jnp.ones((b,), bool)

    def upper_fetch(l):
        if l > 0 and dense_up is not None and l - 1 < len(dense_up):
            return gs.make_rank_fetch(rank_up, dense_up[l - 1])
        return gs.make_chal_fetch(nbr, lvl_off, l, cap if l > 0 else cap0)

    seed_width = min(seed_width, ef)
    seed_state = None
    if (seed_width > 1 and threshold_level == 0 and max_level >= 1
            and up_bits is not None):
        # exact-seed analog for the quantized engine: the 1-bit estimate to
        # EVERY level>=1 node is one matmul over the unpacked bit planes
        # (est is linear in q_rot) + one [B,16]x[16,n_up] g_add matmul
        ip_up = jnp.einsum("bp,up->bu", q_rot, up_bits,
                           preferred_element_type=jnp.float32)
        ga_up = jnp.einsum("bc,uc->bu", g_add_tab, up_onehot,
                           preferred_element_type=jnp.float32)
        est_up = up_fac[:, 0][None, :] + ga_up + up_fac[:, 1][None, :] * (
            ip_up - 0.5 * sumq_full[:, None]
        )
        est_up = jnp.where((up_ids >= 0)[None, :], est_up, jnp.inf)
        negd, pos = jax.lax.top_k(-est_up, seed_width)
        seed_state = gs.BeamState(
            -negd, up_ids[pos], jnp.zeros((b, seed_width), jnp.int32)
        )
    else:
        for l in range(max_level, threshold_level, -1):
            cur, curdist = gs.greedy_level_scored(
                upper_fetch(l), score, cur, curdist, always
            )

    # exact-distance result track over POPPED nodes (the reference reranks
    # each popped node against the raw dataset during traversal,
    # hnswalg_slimq.h:747-757); dataset==None falls back to estimate-only
    if dataset is not None:
        kk = max(k, 16)
        res0 = (jnp.full((b, kk), jnp.inf), jnp.full((b, kk), -1, jnp.int32))

        def pop_hook_for(idx):
            qr = q_raw if idx is None else q_raw[idx]
            qn = qn_raw if idx is None or qn_raw is None else qn_raw[idx]

            def pop_hook(res, pops, ok):
                rd, ri = res
                safe = jnp.maximum(pops, 0)
                vecs = dataset[safe].astype(jnp.float32)
                if metric == "ip":
                    ed = 1.0 - jnp.einsum("bd,bed->be", qr, vecs,
                                          preferred_element_type=jnp.float32)
                else:
                    ed = (qn[:, None] + jnp.sum(vecs * vecs, -1)
                          - 2.0 * jnp.einsum("bd,bed->be", qr, vecs,
                                             preferred_element_type=jnp.float32))
                dup = jnp.any(pops[:, :, None] == ri[:, None, :], axis=2)
                ed = jnp.where(ok & ~dup, ed, jnp.inf)
                cd = jnp.concatenate([rd, ed], axis=1)
                ci = jnp.concatenate(
                    [ri, jnp.where(ok & ~dup, pops, -1)], axis=1
                )
                sd, si = jax.lax.sort((cd, ci), dimension=1, num_keys=1)
                return sd[:, :kk], si[:, :kk]

            return pop_hook

        def ps_index(res, idx):
            return res[0][idx], res[1][idx]

        def ps_update(res, idx, sub):
            return res[0].at[idx].set(sub[0]), res[1].at[idx].set(sub[1])
    else:
        res0 = None
        pop_hook_for = ps_index = ps_update = None

    if seed_state is not None:
        pad = ef - seed_width
        state = gs.BeamState(
            jnp.concatenate(
                [seed_state.buf_d, jnp.full((b, pad), jnp.inf)], axis=1
            ),
            jnp.concatenate(
                [seed_state.buf_id, jnp.full((b, pad), -1, jnp.int32)],
                axis=1,
            ),
            jnp.zeros((b, ef), jnp.int32),
        )
    else:
        state = gs.beam_init(cur, curdist, ef)
    res = res0
    hops = jnp.zeros((b,), jnp.int32)
    dcomp = jnp.zeros((b,), jnp.int32)
    if seed_state is not None:
        dcomp += jnp.sum((up_ids >= 0).astype(jnp.int32))
    for l in range(min(threshold_level, max_level), -1, -1):
        if l == 0 and dense0 is not None:
            fetch = gs.make_dense_fetch(dense0)
        else:
            fetch = upper_fetch(l)
        if l == 0 and stages:
            state, h, dc, res = gs.beam_staged_scored(
                fetch, score_for, state, always, ef, max_iters, pop_width,
                None, stages, scan_width=scan_width, pop_state=res,
                pop_hook_for=pop_hook_for, pop_state_index=ps_index,
                pop_state_update=ps_update,
            )
        else:
            state, h, dc, res = gs.beam_level_scored(
                fetch, score, state, always, ef, max_iters,
                pop_width=pop_width, pop_state=res,
                pop_hook=(
                    pop_hook_for(None) if pop_hook_for is not None else None
                ),
                scan_width=scan_width,
            )
        hops += h
        dcomp += dc
        if l > 0:
            state = gs.BeamState(
                state.buf_d, state.buf_id, jnp.zeros_like(state.buf_chk)
            )
    if dataset is not None:
        # exact-distance top results over popped nodes
        return res[0], res[1], hops, dcomp
    # est-ranked top-ef for host rerank
    return state.buf_d, state.buf_id, hops, dcomp


class HnswSlimQIndex:
    """Quantized Slim index. Raw vectors are NOT stored; exact rerank uses
    the dataset provided to set_dataset (or search-time `dataset`)."""

    def __init__(self, metric: str = "l2", search_cfg: SearchConfig | None = None):
        self.metric = metric
        self.scfg = search_cfg or SearchConfig()
        self.graph: ChalGraph | None = None
        self.codes: QuantizedCodes | None = None
        self.rotator: FhtKacRotator | None = None
        self.cluster_ids = None  # i32[N]
        self.centroids_rot = None  # f32[C, P]
        self.dataset = None  # external raw vectors for rerank
        self._dataset_dev = None
        self._packed = None  # lazy pack_code_rows cache
        # exact-seed tables over level>=1 nodes (scfg.seed_width > 1):
        # unpacked 1-bit planes + (f_add, f_rescale) + cluster one-hot
        self.up_bits = None
        self.up_fac = None
        self.up_onehot = None
        self.up_ids = None
        self._up_for = None
        self.use_ex = False
        # dense serving layouts (same levers as HnswSlimIndex; the methods
        # are borrowed below — SlimQ's graph is a plain ChalGraph)
        self.dense0 = None
        self.dense_up: tuple | None = None
        self.rank_up = None
        self._rank_np = None
        self._n_up = 0
        self.host_chal: dict | None = None

    # the dense-layout builders operate purely on (graph, host_chal,
    # dense0/dense_up/rank_up) — borrow them from HnswSlimIndex
    from .slim import HnswSlimIndex as _Slim

    densify_level0 = _Slim.densify_level0
    densify_upper = _Slim.densify_upper
    _host_chal = _Slim._host_chal
    del _Slim

    @classmethod
    def build(
        cls,
        vectors: np.ndarray,
        hnsw_cfg: HnswConfig | None = None,
        slim_cfg: SlimConfig | None = None,
        quant_cfg: QuantConfig | None = None,
        keep_dataset: bool = True,
        verbose: bool = False,
        strategy: str = "auto",
        max_batch: int = 4096,
    ) -> "HnswSlimQIndex":
        hnsw_cfg = hnsw_cfg or HnswConfig()
        slim_cfg = slim_cfg or SlimConfig.from_ratios()
        quant_cfg = quant_cfg or QuantConfig()
        vectors = np.asarray(vectors, np.float32)

        idx = cls(metric=hnsw_cfg.metric)
        # KMeans-16 centroids + assignment (hnsw_slimq_strategy.h:97-102)
        centroids, asn = kmeans(
            vectors, k=quant_cfg.num_clusters, iters=quant_cfg.kmeans_iters
        )
        # graph from RAW distances, pruned exactly like Slim
        hnsw = HnswIndex(hnsw_cfg, strategy=strategy, max_batch=max_batch)
        hnsw.build(vectors, verbose=verbose)
        idx.graph = convert_to_slim(
            hnsw.graph, hnsw.vectors, hnsw.vn, slim_cfg,
            metric=hnsw_cfg.metric, verbose=verbose,
        )
        # rotate + quantize (hnsw.hpp construct :683-688, add_point :757-766)
        idx.rotator = FhtKacRotator(vectors.shape[1], seed=hnsw_cfg.seed)
        rotated = np.asarray(idx.rotator.rotate(vectors))
        cent_rot = np.asarray(idx.rotator.rotate(centroids))
        idx.codes = quantize_batch(
            rotated, cent_rot, asn, quant_cfg.ex_bits, metric=hnsw_cfg.metric
        )
        idx.cluster_ids = jnp.asarray(asn.astype(np.int32))
        idx.centroids_rot = jnp.asarray(cent_rot)
        if keep_dataset:
            idx.dataset = vectors
        return idx

    def set_dataset(self, vectors: np.ndarray) -> None:
        """External raw vectors for exact rerank (hnsw_slimq_strategy.h:145)."""
        self.dataset = np.asarray(vectors, np.float32)
        self._dataset_dev = None

    def set_ef(self, ef: int) -> None:
        import dataclasses

        self.scfg = dataclasses.replace(self.scfg, ef=ef)

    def autotune(self, ef: int, **kw) -> dict:
        """Per-graph serve-time knob calibration (shared with Slim; probes
        and GT come from the external rerank dataset)."""
        from .slim import autotune_index

        return autotune_index(self, ef, **kw)

    def _seed_table(self):
        """Seed tables for the one-matmul upper-layer estimate (see
        _slimq_search_jit seed path); rebuilt when the graph changes."""
        import jax

        if self.up_ids is None or self._up_for is not id(self.graph):
            from ..quant import estimator as est

            lv = np.asarray(self.graph.level)
            ids = np.nonzero(lv >= 1)[0].astype(np.int32)
            pad = max(64, 1 << max(0, len(ids) - 1).bit_length())
            idp = np.full(pad, -1, np.int32)
            idp[: len(ids)] = ids
            safe = jnp.asarray(np.maximum(idp, 0))
            self.up_bits = jax.block_until_ready(
                est.unpack_bits(self.codes.bin_code[safe])
            )
            self.up_fac = jnp.stack(
                [self.codes.f_add[safe], self.codes.f_rescale[safe]], axis=1
            )
            cid = np.asarray(self.cluster_ids)[np.maximum(idp, 0)]
            n_c = int(self.centroids_rot.shape[0])
            self.up_onehot = jnp.asarray(
                (cid[:, None] == np.arange(n_c)[None, :]).astype(np.float32)
            )
            self.up_ids = jnp.asarray(idp)
            self._up_for = id(self.graph)
        return self.up_bits, self.up_fac, self.up_onehot, self.up_ids

    def search(self, queries: np.ndarray, k: int, rerank: bool = True):
        g = self.graph
        c = self.codes
        ef = max(self.scfg.ef, k)
        q_rot = self.rotator.rotate(queries)
        use_track = rerank and self.dataset is not None
        if self._dataset_dev is None and use_track:
            self._dataset_dev = jnp.asarray(self.dataset)
        if self._packed is None:
            self._packed = jax.block_until_ready(
                pack_code_rows(c, self.cluster_ids)
            )
        b = int(np.asarray(queries).shape[0])
        stages = tuple(
            b // f for f in self.scfg.straggler_stages if b // f >= 32
        )
        up_bits = up_fac = up_onehot = up_ids = None
        if self.scfg.seed_width > 1 and g.threshold_level == 0 \
                and g.max_level >= 1:
            up_bits, up_fac, up_onehot, up_ids = self._seed_table()
        out = _slimq_search_jit(
            g.nbr, g.lvl_off, g.entry, q_rot, self._packed,
            self.centroids_rot,
            self._dataset_dev if use_track else None,
            jnp.asarray(np.asarray(queries, np.float32)) if use_track else None,
            nb=int(c.bin_code.shape[1]), ex_bits=int(c.ex_bits),
            seed_width=self.scfg.seed_width,
            up_bits=up_bits, up_fac=up_fac, up_onehot=up_onehot,
            up_ids=up_ids,
            max_level=g.max_level, threshold_level=g.threshold_level,
            cap0=g.cap0, cap=g.cap, ef=ef, k=k,
            max_iters=self.scfg.iters(), metric=self.metric,
            use_ex=self.use_ex or self.scfg.use_ex,
            pop_width=self.scfg.pop_width,
            dense0=self.dense0, dense_up=self.dense_up, rank_up=self.rank_up,
            stages=stages, scan_width=self.scfg.scan_width,
        )
        # one transfer, one sync — includes the search-effort counters
        # (metric_hops / metric_distance_computations, hnswalg_slim.h:70-71)
        d, ids, hops, dcomp = jax.device_get(out)
        self.last_stats = {
            "hops": int(hops.sum()),
            "distance_computations": int(dcomp.sum()),
        }
        return d[:, :k], ids[:, :k]

    def index_size(self) -> int:
        """Graph + quantized payload bytes (no raw vectors) —
        hnswalg_slimq.h indexSize + code bytes."""
        return self.graph.chal_bytes() + self.codes.bytes() + 4 * self.graph.n

    def runtime_memory(self) -> int:
        """Table 6 'runtime memory': index + (externally held) vectors."""
        ds = 0 if self.dataset is None else self.dataset.nbytes
        return self.index_size() + ds
