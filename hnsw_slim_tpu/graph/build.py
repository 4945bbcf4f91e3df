"""Batched on-device HNSW construction.

Reference: HierarchicalNSW::addPoint (hnswalg.h:1248-1376) inserts one point at
a time under fine-grained locks. The device build replaces locks with
bulk-synchronous rounds: a batch of points searches the frozen pre-batch graph
in lockstep (greedy descent + per-level beam with ef_construction), then all
connections (forward + reverse with heuristic prune) are applied at once.
This matches the semantics of hnswlib's OpenMP-parallel build, where
concurrent inserts also read slightly stale neighborhoods.

Level sampling: level = floor(-ln(U) * mult), mult = 1/ln(branching_factor)
(hnswalg.h getRandomLevel :1285, ctor :143-158).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from ..config import HnswConfig
from ..ops import distance
from . import revconn
from . import search as gs
from .heuristic import prune_all, prune_batch
from .nnd import sorted_run_rank
from .types import LevelGraph

INF = jnp.float32(jnp.inf)


def _next_pow2(x: int) -> int:
    return 1 if x <= 1 else 1 << (x - 1).bit_length()


def _pad_rows(a: np.ndarray, fill: int = -1) -> tuple[np.ndarray, int]:
    """Pad the leading dim to the next power of two (bounds jit recompiles)."""
    n = a.shape[0]
    m = _next_pow2(n)
    if m == n:
        return a, n
    pad = np.full((m - n,) + a.shape[1:], fill, a.dtype)
    return np.concatenate([a, pad]), n


def _pad_to(a: np.ndarray, size: int, fill: int = -1) -> np.ndarray:
    """Pad the leading dim to exactly `size` (single compiled shape)."""
    n = a.shape[0]
    if n >= size:
        return a
    pad = np.full((size - n,) + a.shape[1:], fill, a.dtype)
    return np.concatenate([a, pad])


def _pad_dup(a: np.ndarray, size: int) -> np.ndarray:
    """Pad the leading dim to `size` by repeating row 0. Used where padded
    rows feed a row-wise-deterministic program whose output is scattered by
    a row-0-duplicated id array: the duplicate writes identical content, so
    the scatter stays benign without a host-side slice."""
    n = a.shape[0]
    if n >= size:
        return a
    pad = np.broadcast_to(a[0], (size - n,) + a.shape[1:])
    return np.concatenate([a, pad])


def _ladder_chunks(n: int, ladder: tuple):
    """Split [0, n) into (slice, padded_size) pieces whose padded sizes come
    from `ladder` (ascending): the compiled-shape count stays at len(ladder)
    while the dispatch count stays low (a cached-program dispatch is ~1 ms).

    The remainder is decomposed greedily into SMALLER rungs when that saves
    more padding than a rung's worth of rows: padding is real H2D bytes,
    and rounding 20k rows up to the 131072 rung ships 31 MB for 4.8 MB of
    payload."""
    out = []
    s = 0
    while s < n:
        rem = n - s
        size = next((x for x in ladder if x >= rem), ladder[-1])
        lower = [x for x in ladder if x <= rem]
        if size > rem and lower and size - rem > lower[-1]:
            size = lower[-1]  # exact-fit lower rung; loop continues on rest
        out.append((slice(s, min(s + size, n)), size))
        s += size
    return out


def sample_levels(n: int, mult: float, seed: int, cap: int = 12) -> np.ndarray:
    """Geometric level sampling (hnswalg.h:1285 getRandomLevel)."""
    rng = np.random.default_rng(seed)
    u = rng.random(n)
    u = np.clip(u, 1e-12, 1.0)
    return np.minimum((-np.log(u) * mult).astype(np.int32), cap)


@functools.partial(
    jax.jit,
    static_argnames=("max_level", "efc", "max_iters", "metric"),
)
def _build_search(
    adjs: tuple,
    entry: jnp.ndarray,
    vectors: jnp.ndarray,
    vn: jnp.ndarray,
    q: jnp.ndarray,
    lp_eff: jnp.ndarray,
    *,
    max_level: int,
    efc: int,
    max_iters: int,
    metric: str,
):
    """Per-batch candidate discovery: greedy descent above each point's level,
    beam (ef_construction) at and below it. Returns per-level candidate
    buffers stacked [max_level+1, B, efc] (ids, dists)."""
    b = q.shape[0]
    precision = jax.lax.Precision.HIGHEST
    qn = distance.sq_norms(q)
    cur = jnp.broadcast_to(entry.astype(jnp.int32), (b,))
    curdist = distance.gathered_dist(
        q, vectors[cur][:, None, :], metric, qn=qn, vn=vn[cur][:, None],
        precision=precision,
    )[:, 0]

    state = gs.beam_init(cur, curdist, efc)
    out_d, out_i = [], []
    for l in range(max_level, -1, -1):
        fetch = gs.make_dense_fetch(adjs[l])
        greedy_active = lp_eff < l
        cur, curdist = greedy_level(
            fetch, vectors, vn, q, qn, cur, curdist, greedy_active, metric, precision
        )
        state = gs.beam_reseed(state, cur, curdist, lp_eff == l)
        beam_active = lp_eff >= l
        state, _, _ = gs.beam_level(
            fetch, vectors, vn, q, qn, state, beam_active, efc, max_iters,
            metric, precision,
        )
        out_d.append(state.buf_d)
        out_i.append(state.buf_id)
        if l > 0:
            state = gs.BeamState(
                state.buf_d, state.buf_id, jnp.zeros_like(state.buf_chk)
            )
    # out[j] corresponds to level max_level - j; flip to index by level
    return jnp.stack(out_d[::-1]), jnp.stack(out_i[::-1])


# thin alias so _build_search reads naturally
greedy_level = gs.greedy_level


@functools.partial(
    jax.jit,
    static_argnames=(
        "max_level", "efc", "max_iters", "metric", "pop_width", "stages",
        "scan_width",
    ),
)
def _build_search0(
    adjs: tuple,
    entry: jnp.ndarray,
    vectors: jnp.ndarray,
    vn: jnp.ndarray,
    q: jnp.ndarray,
    active: jnp.ndarray,
    *,
    max_level: int,
    efc: int,
    max_iters: int,
    metric: str,
    pop_width: int,
    stages: tuple,
    scan_width: int,
):
    """Candidate discovery for LEVEL-0-ONLY inserts (97% of a batch at
    p=1/32): greedy descent through every upper level, one straggler-staged
    multi-pop beam at the base layer. Splitting these out of _build_search
    lets the base beam use the tuned serving kernel and keeps the (rare)
    upper-level nodes in their own small program — the full-batch lockstep
    previously paid every upper level's beam iterations for all 4096 rows.
    Returns (d f32[B, efc], ids i32[B, efc])."""
    precision = jax.lax.Precision.HIGHEST
    b = q.shape[0]
    qn = distance.sq_norms(q)
    cur = jnp.broadcast_to(entry.astype(jnp.int32), (b,))
    curdist = distance.gathered_dist(
        q, vectors[cur][:, None, :], metric, qn=qn, vn=vn[cur][:, None],
        precision=precision,
    )[:, 0]
    for l in range(max_level, 0, -1):
        cur, curdist = greedy_level(
            gs.make_dense_fetch(adjs[l]), vectors, vn, q, qn, cur, curdist,
            active, metric, precision,
        )
    state = gs.beam_init(cur, curdist, efc)
    state, _, _ = gs.beam_level_staged(
        gs.make_dense_fetch(adjs[0]), vectors, q, qn, state, active, efc,
        max_iters, metric, precision, pop_width, None, stages,
        scan_width=scan_width,
    )
    return state.buf_d, state.buf_id


@functools.partial(jax.jit, static_argnames=("w_union",))
def mutual_union(sel: jnp.ndarray, d_sel: jnp.ndarray, *, w_union: int):
    """Symmetrize pruned forward edges and keep each node's w_union nearest.

    Device-side replacement for the reference's locked reverse-edge emplace +
    dedup (hnswalg_slim.h:988-1015, hnswalg.h:618-687): one global sort by
    (src, tgt) for dedup, one by (src, dist) for ranking, one scatter.
    Returns rows i32[N, w_union] (-1 padded, ascending distance) and counts.
    """
    n, m = sel.shape
    src1 = jnp.repeat(lax.broadcasted_iota(jnp.int32, (n, 1), 0), m, axis=1)
    tgt1 = sel
    valid = tgt1 >= 0

    src = jnp.concatenate([src1.reshape(-1), tgt1.reshape(-1)])
    tgt = jnp.concatenate([tgt1.reshape(-1), src1.reshape(-1)])
    dd = jnp.concatenate([d_sel.reshape(-1)] * 2)
    ok = jnp.concatenate([valid.reshape(-1)] * 2)

    # dedup by (src, tgt): 2-key sort, mark adjacent duplicates (no 64-bit
    # pair keys — they would overflow/truncate at large N)
    src_m = jnp.where(ok, src, n)
    tgt_m = jnp.where(ok, tgt, n)
    s1, t1s, d1s = lax.sort((src_m, tgt_m, dd), dimension=0, num_keys=2)
    dup = jnp.concatenate(
        [jnp.zeros((1,), bool), (s1[1:] == s1[:-1]) & (t1s[1:] == t1s[:-1])]
    )
    s1 = jnp.where(dup, n, s1)

    # rank by distance within each src run
    s2, d2, t2 = lax.sort((s1, d1s, t1s), dimension=0, num_keys=2)

    rank = sorted_run_rank(s2)
    keep = (rank < w_union) & (s2 < n)

    rows = jnp.full((n + 1, w_union), -1, jnp.int32)
    rows = rows.at[
        jnp.where(keep, s2, n), jnp.where(keep, rank, 0)
    ].set(jnp.where(keep, t2, -1))[:n]
    counts = jnp.sum((rows >= 0).astype(jnp.int32), axis=1)
    return rows, counts


def knn_to_level0(
    vectors, vn, knn_ids, knn_d, M: int, cap0: int, metric: str,
    chunk: int = 4096, hop2: int = 0, seed: int = 0,
):
    """kNN lists -> navigable level-0 adjacency: heuristic-prune each node's
    kNN to M (mutuallyConnectNewElement semantics), symmetrize, re-prune
    overflowing rows to cap0. hop2 > 0 augments each node's candidates with
    that many random 2-hop samples (diversity for the RNG rule, standing in
    for the insertion build's ef_construction beam candidates)."""
    n = knn_ids.shape[0]
    if hop2 > 0:
        rng = np.random.default_rng(seed)
        kk = knn_ids.shape[1]
        r1 = rng.integers(0, kk, (n, hop2))
        r2 = rng.integers(0, kk, (n, hop2))
        mid = np.take_along_axis(knn_ids, r1, axis=1)
        h2 = np.where(
            mid >= 0, knn_ids.reshape(-1)[np.maximum(mid, 0) * kk + r2], -1
        )
        # plus uniform random long-range candidates: the RNG rule keeps the
        # few that are not intercepted, giving greedy-routable long links
        # (the insertion build gets these from its entry-descent beam)
        rnd = rng.integers(0, n, (n, hop2)).astype(np.int32)
        knn_ids = np.concatenate([knn_ids, h2, rnd], axis=1)
    npad = -(-n // chunk) * chunk
    sel = np.asarray(
        prune_all(
            vectors, vn,
            jnp.asarray(_pad_to(np.arange(n, dtype=np.int32), npad, fill=0)),
            jnp.asarray(_pad_to(np.asarray(knn_ids, np.int32), npad)),
            jnp.asarray(np.full(npad, M, np.int32)),
            M=M, keep_all_under_m=True, metric=metric, chunk=chunk,
            keep_pruned=True,
        )
    )[:n]

    # distance payload for ranking the union (chunked to bound the gather)
    d_sel = np.full((n, M), np.inf, np.float32)
    for s in range(0, n, 65536):
        ck = slice(s, min(s + 65536, n))
        d_sel[ck] = np.asarray(
            _edge_dists(
                vectors[ck.start : ck.stop], vn[ck.start : ck.stop],
                vectors, vn, jnp.asarray(sel[ck]), metric,
            )
        )
    rows, counts = mutual_union(
        jnp.asarray(sel), jnp.asarray(d_sel), w_union=cap0 + 16
    )

    # re-prune rows over cap0; keep under-cap rows untouched (hnswlib appends
    # without pruning until the row overflows, hnswalg.h:618-687)
    rows_np = np.asarray(rows)
    counts_np = np.asarray(counts)
    m_row = np.where(counts_np > cap0, cap0, counts_np + 1).astype(np.int32)
    out = np.asarray(
        prune_all(
            vectors, vn,
            jnp.asarray(_pad_to(np.arange(n, dtype=np.int32), npad, fill=0)),
            jnp.asarray(_pad_to(rows_np, npad)),
            jnp.asarray(_pad_to(m_row, npad, fill=1)),
            M=cap0, keep_all_under_m=True, metric=metric, out_width=cap0,
            chunk=chunk,
        )
    )[:n]
    return out


@functools.partial(jax.jit, static_argnames=("metric",))
def _edge_dists(q, qn, vectors, vn, sel, metric):
    """Exact distances q[i] -> vectors[sel[i, j]]; inf where sel < 0."""
    safe = jnp.maximum(sel, 0)
    d = distance.gathered_dist(
        q, vectors[safe], metric, qn=qn, vn=vn[safe],
        precision=jax.lax.Precision.DEFAULT,
    )
    return jnp.where(sel >= 0, d, INF)


def _exact_knn_subset(vectors, vn, sub_ids: np.ndarray, k: int, metric: str,
                      qchunk: int = 4096):
    """Exact kNN among a node subset (upper levels are tiny: N/32^l nodes).
    Returns global ids i32[S, k] and dists, self excluded."""
    s = len(sub_ids)
    sub = jnp.asarray(sub_ids)
    sv = vectors[sub]
    svn = vn[sub]
    out_i = np.full((s, k), -1, np.int32)
    out_d = np.full((s, k), np.inf, np.float32)
    k_eff = min(k, s - 1)
    for st in range(0, s, qchunk):
        ck = slice(st, min(st + qchunk, s))
        d = distance.pairwise_dist(
            sv[ck.start : ck.stop], sv, metric,
            qn=svn[ck.start : ck.stop], xn=svn,
            precision=jax.lax.Precision.DEFAULT,
        )
        # mask self: row r is subset index ck.start + r
        rows = jnp.arange(ck.stop - ck.start)
        d = d.at[rows, rows + ck.start].set(jnp.inf)
        neg, arg = jax.lax.top_k(-d, k_eff)
        out_i[ck, :k_eff] = sub_ids[np.asarray(arg)]
        out_d[ck, :k_eff] = -np.asarray(neg)
    return out_i, out_d


def build_by_nnd(
    cfg: HnswConfig,
    vectors_np: np.ndarray,
    nnd_k: int = 0,
    nnd_rounds: int = 25,
    hop2: int = 16,
    chunk: int = 8192,
    verbose: bool = False,
):
    """Device-native build: NN-descent kNN graph -> heuristic prune + mutual
    union at level 0; exact kNN + same prune at the (tiny) upper levels.
    Returns (LevelGraph, levels)."""
    from .nnd import nn_descent

    n, dim = vectors_np.shape
    levels = sample_levels(n, cfg.mult, cfg.seed)
    lmax = int(levels.max(initial=0))
    vecs = jnp.asarray(np.asarray(vectors_np, np.float32))
    vn = distance.sq_norms(vecs)

    k = nnd_k or max(cfg.maxM0, 48)
    knn_ids, knn_d = nn_descent(
        vecs, vn, k=k, rounds=nnd_rounds, chunk=min(chunk, _next_pow2(n)),
        metric=cfg.metric, seed=cfg.seed, verbose=verbose,
    )
    adj0 = knn_to_level0(
        vecs, vn, np.asarray(knn_ids), np.asarray(knn_d),
        M=cfg.M, cap0=cfg.maxM0, metric=cfg.metric, hop2=hop2, seed=cfg.seed,
    )
    adj0 = repair_connectivity(
        adj0, np.arange(n, dtype=np.int32), vecs, vn, cfg.metric
    )
    adjs = [adj0]

    for l in range(1, lmax + 1):
        sub = np.nonzero(levels >= l)[0].astype(np.int32)
        full = np.full((n, cfg.maxM), -1, np.int32)
        if len(sub) > 1:
            ki, _ = _exact_knn_subset(
                vecs, vn, sub, min(k, len(sub) - 1), cfg.metric
            )
            rows = _subset_prune_union(
                vecs, vn, sub, ki, cfg.M, cfg.maxM, cfg.metric
            )
            full[sub] = repair_connectivity(rows, sub, vecs, vn, cfg.metric)
        adjs.append(full)

    # enterpoint: first node at the top level (hnswalg.h enterpoint_node_)
    top = np.nonzero(levels == lmax)[0]
    entry = int(top[0]) if len(top) else 0

    return LevelGraph(
        adjs=tuple(jnp.asarray(a) for a in adjs),
        level=jnp.asarray(levels),
        entry=jnp.asarray(np.int32(entry)),
        max_level=lmax,
    ), levels


def _subset_prune_union(vecs, vn, sub_ids, knn_rows, M, cap, metric,
                        chunk: int = 4096, rand_cands: int = 16):
    """Prune+symmetrize a subset's kNN rows (global ids); returns [S, cap]."""
    s = len(sub_ids)
    if rand_cands > 0 and s > 2:
        # random long-range candidates keep upper-level greedy descent
        # routable across far regions (see knn_to_level0)
        rng = np.random.default_rng(1)
        rnd = sub_ids[rng.integers(0, s, (s, min(rand_cands, s - 1)))]
        knn_rows = np.concatenate([knn_rows, rnd.astype(np.int32)], axis=1)
    sel = np.zeros((s, M), np.int32)
    for st in range(0, s, chunk):
        ck = slice(st, min(st + chunk, s))
        cpad = _pad_rows(knn_rows[ck])[0]
        bpad = _pad_rows(sub_ids[ck], fill=0)[0]
        out, _ = prune_batch(
            vecs, vn, jnp.asarray(bpad), jnp.asarray(cpad),
            jnp.asarray(cpad >= 0), M=M, keep_all_under_m=True, metric=metric,
            keep_pruned=True,
        )
        sel[ck] = np.asarray(out)[: ck.stop - ck.start]

    # map to local ids for the union, then back
    lookup = np.full(int(vecs.shape[0]), -1, np.int32)
    lookup[sub_ids] = np.arange(s, dtype=np.int32)
    loc = np.where(sel >= 0, lookup[np.maximum(sel, 0)], -1).astype(np.int32)
    d_sel = np.asarray(
        _edge_dists(vecs[jnp.asarray(sub_ids)], vn[jnp.asarray(sub_ids)],
                    vecs, vn, jnp.asarray(sel), metric)
    )
    rows_l, counts = mutual_union(
        jnp.asarray(loc), jnp.asarray(d_sel), w_union=cap + 8
    )
    rows_l = np.asarray(rows_l)
    counts = np.asarray(counts)
    rows_g = np.where(rows_l >= 0, sub_ids[np.maximum(rows_l, 0)], -1)

    out = np.full((s, cap), -1, np.int32)
    m_row = np.where(counts > cap, cap, counts + 1).astype(np.int32)
    for st in range(0, s, chunk):
        ck = slice(st, min(st + chunk, s))
        cpad = _pad_rows(rows_g[ck])[0]
        bpad = _pad_rows(sub_ids[ck], fill=0)[0]
        mpad = _pad_rows(m_row[ck], fill=1)[0]
        o, _ = prune_batch(
            vecs, vn, jnp.asarray(bpad), jnp.asarray(cpad),
            jnp.asarray(cpad >= 0), M=cap, keep_all_under_m=True,
            metric=metric, out_width=cap, m_per_row=jnp.asarray(mpad),
        )
        out[ck] = np.asarray(o)[: ck.stop - ck.start]
    return out


def _components(rows: np.ndarray, node_ids: np.ndarray | None = None) -> np.ndarray:
    """Connected-component labels over an undirected view of `rows` (scipy
    csgraph, C speed). rows i32[S, W] hold global ids; node_ids maps row
    index -> global id (identity if None)."""
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components

    s, w = rows.shape
    if node_ids is None:
        lookup = None
    else:
        lookup = np.full(int(node_ids.max(initial=0)) + 2, -1, np.int64)
        lookup[node_ids] = np.arange(s)
    src = np.repeat(np.arange(s), w)
    tgt = rows.reshape(-1).astype(np.int64)
    m = tgt >= 0
    src, tgt = src[m], tgt[m]
    if lookup is not None:
        tgt = lookup[tgt]
        m2 = tgt >= 0
        src, tgt = src[m2], tgt[m2]
    g = coo_matrix(
        (np.ones(len(src), np.int8), (src, tgt)), shape=(s, s)
    )
    _, labels = connected_components(g, directed=True, connection="weak")
    return labels


def repair_connectivity(
    rows: np.ndarray,
    node_ids: np.ndarray,
    vectors,
    vn,
    metric: str,
    max_rounds: int = 64,
    sample: int = 256,
) -> np.ndarray:
    """Guarantee a single connected component by adding one mutual edge
    between each stray component and the rest (closest cross pair among
    samples). Insertion-built HNSW gets connectivity for free (every insert
    links into the existing graph, hnswalg.h:1344-1367); the kNN-union build
    must enforce it explicitly."""
    import os as _os
    import time as _time

    timing = _os.environ.get("SLIM_TIMING")
    rows = rows.copy()
    for rnd in range(max_rounds):
        t0 = _time.perf_counter()
        comp = _components(rows, node_ids)
        labels, counts = np.unique(comp, return_counts=True)
        if timing:
            print(f"    repair round {rnd}: components={len(labels)} "
                  f"(components pass {_time.perf_counter()-t0:.2f}s)",
                  flush=True)
        if len(labels) == 1:
            return rows
        main = labels[np.argmax(counts)]
        rng = np.random.default_rng(0)
        # bound the round's [S, sample, 4*sample] distance tensor (~1 MB per
        # stray); an extreme stray count spills into the next round
        strays = [c for c in labels if c != main][:256]
        # ONE batched distance program per round: the per-component device
        # calls (gather + pairwise + sync, ~0.3-0.5 s each) made the repair
        # pass scale with the stray count (165 s of the 1M self-build
        # convert); padding every stray to a fixed sample grid instead
        # costs one [S, sample, 4*sample] einsum.
        a_ss, b_ss = [], []
        for c in strays:
            a_idx = np.nonzero(comp == c)[0]
            b_idx = np.nonzero(comp != c)[0]
            a_s = rng.choice(a_idx, size=sample,
                             replace=len(a_idx) < sample)
            b_s = rng.choice(b_idx, size=4 * sample,
                             replace=len(b_idx) < 4 * sample)
            a_ss.append(a_s)
            b_ss.append(b_s)
        A = np.stack(a_ss)  # [S, sample]
        Bm = np.stack(b_ss)  # [S, 4*sample]
        av = vectors[jnp.asarray(node_ids[A])]  # [S, sample, d]
        bv = vectors[jnp.asarray(node_ids[Bm])]
        dots = jnp.einsum(
            "sad,sbd->sab", av.astype(jnp.float32), bv.astype(jnp.float32),
            precision=jax.lax.Precision.DEFAULT,
        )
        if metric == "ip":
            d_all = np.asarray(1.0 - dots)
        else:
            an = jnp.sum(av.astype(jnp.float32) ** 2, axis=2)
            bn = jnp.sum(bv.astype(jnp.float32) ** 2, axis=2)
            d_all = np.asarray(
                an[:, :, None] + bn[:, None, :] - 2.0 * dots
            )
        for si, c in enumerate(strays):
            d = d_all[si]
            a_s, b_s = a_ss[si], b_ss[si]
            # several bridges per stray component: single-edge bridges are
            # fragile and may be cut by later pruning passes
            flat = np.argsort(d, axis=None)[: 4 * max(1, d.shape[0] // sample)]
            used_a = set()
            for f in flat[:8]:
                ai, bi = np.unravel_index(f, d.shape)
                if ai in used_a:
                    continue
                used_a.add(ai)
                u, v = a_s[ai], b_s[bi]
                if u == v or comp[u] == comp[v]:
                    continue  # sampled-with-replacement duplicates
                _append_or_replace(rows, u, node_ids[v])
                _append_or_replace(rows, v, node_ids[u])
    return rows


def _append_or_replace(rows: np.ndarray, i: int, gid: int) -> None:
    """Append gid to rows[i]; if full, replace the last (farthest) slot."""
    if gid in rows[i]:
        return
    empty = np.nonzero(rows[i] < 0)[0]
    rows[i, empty[0] if len(empty) else -1] = gid


class HnswBuilder:
    """Builds a LevelGraph over a vector set in batched rounds.

    All search batches are padded to `pad_batch` (default max_batch) so the
    expensive _build_search program compiles exactly once per build; padded
    queries carry lp_eff=-1 and never beam. Early small batches run the full
    program over a near-empty graph, which converges in a handful of
    while_loop iterations and costs little.
    """

    def __init__(self, cfg: HnswConfig, max_batch: int = 4096,
                 pad_batch: int | None = None, pop_width: int = 8,
                 stages_frac: tuple = (4, 16), scan_width: int = 0):
        self.cfg = cfg
        self.max_batch = max_batch
        self.pad_batch = pad_batch or max_batch
        # build-search kernel knobs for the level-0 beam (same levers as the
        # serving path: multi-pop + straggler compaction; measured on the
        # serve kernel, straggler compaction alone is worth ~6x at 1M)
        self.pop_width = pop_width
        self.stages_frac = stages_frac
        self.scan_width = scan_width
        # vanilla rows written by insert batches (inserted nodes + their
        # reverse-connect targets): the incremental re-prune working set
        self.touched: list[np.ndarray] = []
        # cumulative per-phase seconds across all batches (SLIM_TIMING)
        self.phase_s: dict = {}
        # (level, of_edges, of_targets, of_t, new_w) per fused apply —
        # lazily fetched truncation monitor (_check_overflow_monitor)
        self._of_monitor: list = []

    def touched_ids(self) -> np.ndarray:
        return (np.unique(np.concatenate(self.touched))
                if self.touched else np.zeros(0, np.int64))

    def build(self, vectors: np.ndarray, verbose: bool = False):
        """Returns (LevelGraph, levels np.int32[N])."""
        cfg = self.cfg
        n, dim = vectors.shape
        levels = sample_levels(n, cfg.mult, cfg.seed)
        lmax = int(levels.max(initial=0))
        caps = [cfg.maxM0] + [cfg.maxM] * lmax

        import os as _os
        import time as _time

        timing = _os.environ.get("SLIM_TIMING")
        t_setup = _time.perf_counter()
        vecs = jnp.asarray(np.asarray(vectors, np.float32))
        if timing:
            jax.block_until_ready(vecs)
            self.phase_s["setup.h2d"] = _time.perf_counter() - t_setup
            t_setup = _time.perf_counter()
        vn = distance.sq_norms(vecs)
        if timing:
            jax.block_until_ready(vn)
            self.phase_s["setup.norms"] = _time.perf_counter() - t_setup
            t_setup = _time.perf_counter()
        # the adjacency lives on DEVICE for the whole build (jnp.full, -1
        # init); the host mirror is pulled ONCE at the end. Host-side
        # allocation/upload previously cost 67 s of page faults + 57 s of
        # H2D at 1M on this hypervisor-backed host.
        adj_np = None
        adj_dev = [
            jnp.full((n, caps[l]), -1, jnp.int32) for l in range(lmax + 1)
        ]
        if timing:
            jax.block_until_ready(adj_dev[0])
            self.phase_s["setup"] = _time.perf_counter() - t_setup

        # per-level degree arrays: the fused device apply (graph/revconn.py)
        # tracks row occupancy on device so reverse-append columns never
        # need a host round trip
        deg_dev = [jnp.zeros((n,), jnp.int32) for _ in range(lmax + 1)]
        self._of_monitor = []

        entry = 0
        cur_maxlevel = int(levels[0])
        start = 1  # point 0 inserted trivially (no peers to link)
        entry, cur_maxlevel = self._insert_range(
            start, n, levels, entry, cur_maxlevel, vecs, vn, adj_np, adj_dev,
            lmax, verbose, deg_dev=deg_dev,
        )
        self._check_overflow_monitor(verbose)
        # testing handle: the device mirror is the source of truth; the host
        # mirror below is its end-of-build pull
        self._adj_dev = adj_dev
        self._deg_dev = deg_dev
        if timing:
            t_setup = _time.perf_counter()
        # ONE end-of-build D2H fills the host mirror consumers need
        # (convert/incremental); per-batch mirror writes are gone entirely.
        # np.array = writable copy (np.asarray of a device buffer can hand
        # back a read-only view; replace_points writes rows in place).
        self.adj_np = [np.array(a) for a in adj_dev]
        if timing:
            self.phase_s["mirror.d2h"] = _time.perf_counter() - t_setup

        # the device mirror IS the final adjacency — re-uploading the host
        # mirror here would cost ~500 MB of H2D for byte-identical content
        return LevelGraph(
            adjs=tuple(adj_dev),
            level=jnp.asarray(levels),
            entry=jnp.asarray(np.int32(entry)),
            max_level=lmax,
        ), levels

    def _insert_range(self, start, n, levels, entry, cur_maxlevel, vecs, vn,
                      adj_np, adj_dev, lmax, verbose, deg_dev=None):
        import os as _os
        import time as _time

        timing = _os.environ.get("SLIM_TIMING")
        done = start
        while done < n:
            bsz = min(self._batch_size(done), n - done)
            ids = np.arange(done, done + bsz)
            if deg_dev is not None:  # bulk: fused device apply, no mirror
                self.touched.append(self._insert_batch_bulk(
                    ids, levels, entry, cur_maxlevel, vecs, vn, adj_dev,
                    deg_dev, lmax,
                ))
            else:
                self.touched.append(self._insert_batch(
                    ids, levels, entry, cur_maxlevel, vecs, vn, adj_np,
                    adj_dev, lmax,
                ))
            if timing:
                t_out = _time.perf_counter()
            # entry-point update (hnswalg.h:1369-1374): each insert whose level
            # exceeds the running max becomes the new enterpoint, in order.
            hi = np.nonzero(levels[ids] > cur_maxlevel)[0]
            for j in hi:  # rare: P(level>0) ~ 1/32, strictly increasing runs
                if levels[ids[j]] > cur_maxlevel:
                    cur_maxlevel = int(levels[ids[j]])
                    entry = int(ids[j])
            done += bsz
            if timing:
                self.phase_s["outer"] = (
                    self.phase_s.get("outer", 0.0)
                    + _time.perf_counter() - t_out
                )
            if verbose and done % 65536 < bsz:
                print(f"  built {done}/{n}")
        import os as _os

        if self.phase_s and (verbose or _os.environ.get("SLIM_TIMING")):
            print("  build phase totals: " + " ".join(
                f"{k}={v:.1f}s" for k, v in sorted(
                    self.phase_s.items(), key=lambda kv: -kv[1])
            ), flush=True)
        return entry, cur_maxlevel

    def _batch_size(self, cur: int) -> int:
        # batch never exceeds current graph size: early rounds stay
        # high-quality, later rounds amortize to max_batch
        return max(1, min(cur, self.max_batch))

    def _insert_batch_bulk(
        self, ids, levels, entry, cur_maxlevel, vecs, vn, adj_dev, deg_dev,
        lmax, collect=None,
    ):
        """Device-resident insert batch: search + ONE fused apply per level
        (graph/revconn.apply_insert). No host mirror writes, no per-batch
        D2H — the host-planned path (_insert_batch below, kept for the
        replace_points flow) pays 8-12 dispatch+sync pairs and ~9 MB of H2D
        per batch.

        collect: optional dict the incremental add_points flow passes to
        learn which pre-existing rows each level's apply touched (the
        reverse-connect targets == the forward selection's values, read back
        from the post-apply adjacency). Collect mode also widens the
        overflow re-prune: update batches insert into a MATURE graph whose
        rows sit at cap, so nearly every reverse append overflows (the
        shrink path of mutuallyConnectNewElement, hnswalg.h:618-687),
        unlike the growing-graph bulk build where overflow is rare."""
        import os
        import time as _time

        timing = os.environ.get("SLIM_TIMING")
        marks = []
        t0 = t_batch = _time.perf_counter()
        cfg = self.cfg
        b = len(ids)
        lp = levels[ids].astype(np.int32)
        lp_eff = np.minimum(lp, cur_maxlevel)
        ids_pad = _pad_to(ids.astype(np.int32), self.pad_batch,
                          fill=int(ids[-1]))
        lp_pad = _pad_to(lp_eff, self.pad_batch, fill=-1)
        q = vecs[jnp.asarray(ids_pad)]
        entry_dev = jnp.asarray(np.int32(entry))
        up = np.nonzero(lp_eff >= 1)[0]
        stages = tuple(
            self.pad_batch // f for f in self.stages_frac
            if self.pad_batch // f >= 32
        )
        _, i0 = _build_search0(
            tuple(adj_dev), entry_dev, vecs, vn, q,
            jnp.asarray(lp_pad == 0),
            max_level=lmax, efc=cfg.ef_construction,
            max_iters=2 * cfg.ef_construction + 64, metric=cfg.metric,
            pop_width=self.pop_width, stages=stages,
            scan_width=self.scan_width,
        )
        cand_up = None
        if len(up):
            # floor 64: a 1000-insert batch draws ~33 upper-level points, so
            # a floor of 32 flip-flops the pow2 bucket across updates and
            # recompiles the upper search
            bup = _next_pow2(max(len(up), 64))
            up_rows = _pad_to(up.astype(np.int32), bup, fill=int(up[0]))
            q_up = vecs[jnp.asarray(
                _pad_to(ids[up].astype(np.int32), bup, fill=int(ids[up][0]))
            )]
            _, cand_up = _build_search(
                tuple(adj_dev), entry_dev, vecs, vn, q_up,
                jnp.asarray(_pad_to(lp_eff[up], bup, fill=-1)),
                max_level=lmax, efc=cfg.ef_construction,
                max_iters=2 * cfg.ef_construction + 64, metric=cfg.metric,
            )  # device [lmax+1, bup, efc]
            # upper-level inserts take their L0 candidates from the
            # per-level search (dup rows write identical content)
            i0 = i0.at[jnp.asarray(up_rows)].set(cand_up[0])
        if timing:
            jax.block_until_ready(i0)
            marks.append(("search", _time.perf_counter() - t0))
        for l in range(int(lp_eff.max(initial=0)), -1, -1):
            if timing:
                t0 = _time.perf_counter()
            active = lp_eff >= l
            if not active.any():
                continue
            cap_l = cfg.maxM0 if l == 0 else cfg.maxM
            of_t, new_w = (4096, 64) if l == 0 else (1024, 32)
            if collect is not None:
                of_t, new_w = (16384, 32) if l == 0 else (2048, 32)
            if l == 0:
                a_pad = jnp.asarray(ids_pad)
                cand = i0
                n_valid = b
            else:
                aidx = np.nonzero(active)[0]
                # rows of cand_up correspond to `up` order (both sorted)
                pos = np.searchsorted(up, aidx).astype(np.int32)
                n_valid = len(aidx)
                psize = _next_pow2(max(n_valid, 64))  # floor 64: see bup
                rowsel = _pad_to(pos, psize, fill=int(pos[0]))
                cand = cand_up[l][jnp.asarray(rowsel)]
                a_pad = jnp.asarray(_pad_to(
                    ids[aidx].astype(np.int32), psize, fill=int(ids[aidx][0])
                ))
            adj_new, deg_new, of_e, of_tc = revconn.apply_insert(
                adj_dev[l], deg_dev[l], vecs, vn, a_pad, cand,
                jnp.int32(n_valid), M=cfg.M, cap=cap_l, metric=cfg.metric,
                of_t=of_t, new_w=new_w,
            )
            adj_dev[l] = adj_new
            deg_dev[l] = deg_new
            # lazy monitoring: fetched once at end of build
            self._of_monitor.append((l, of_e, of_tc, of_t, new_w))
            if collect is not None:
                # post-apply rows of the inserted ids == their forward
                # selection; its values are exactly the reverse-connect
                # targets (candidates come from the frozen pre-batch graph,
                # so they are disjoint from this batch's ids)
                rows = np.asarray(adj_new[a_pad])[: int(n_valid)]
                tg = np.unique(rows[rows >= 0]).astype(np.int64)
                ins = (ids if l == 0 else ids[aidx]).astype(np.int64)
                collect.setdefault(l, []).extend((ins, tg))
            if timing:
                jax.block_until_ready(adj_new)
                marks.append((f"L{l}.apply", _time.perf_counter() - t0))
        # bound the dispatch queue: one cheap device sync per batch keeps
        # the pipeline depth at ~1 and the host mirror in step
        jax.block_until_ready(adj_dev[0])
        if timing:
            print("    insert_batch: " + " ".join(
                f"{k}={v:.2f}s" for k, v in marks if v >= 0.05
            ), flush=True)
            marks.append(("wall", _time.perf_counter() - t_batch))
            for k, v in marks:
                key = k.split(".", 1)[-1]
                self.phase_s[key] = self.phase_s.get(key, 0.0) + v
        # bulk touched = inserted ids only (reverse targets stay on device);
        # the incremental flows use the mirror path below instead
        return ids.astype(np.int64)

    def _check_overflow_monitor(self, verbose: bool):
        """Fetch the per-batch overflow counters (one sync) and report
        truncation, i.e. batches whose unique overflow targets exceeded the
        fixed re-prune width (their excess reverse edges were dropped)."""
        if not self._of_monitor:
            return
        vals = jax.device_get([(e, t) for _, e, t, _, _ in self._of_monitor])
        trunc = sum(
            1 for (l, _, _, cap_t, _), (e, t) in zip(self._of_monitor, vals)
            if t > cap_t
        )
        if verbose or trunc:
            tot_e = sum(int(e) for e, _ in vals)
            max_t = max(int(t) for _, t in vals)
            print(f"  reverse-connect overflow: {tot_e} edges re-pruned, "
                  f"max {max_t} targets/batch, {trunc} truncated batches",
                  flush=True)
        self._of_monitor = []

    def _insert_batch(
        self, ids, levels, entry, cur_maxlevel, vecs, vn, adj_np, adj_dev, lmax
    ):
        import os
        import time as _time

        timing = os.environ.get("SLIM_TIMING")
        marks = []
        t0 = t_batch = _time.perf_counter()
        cfg = self.cfg
        b = len(ids)
        lp = levels[ids].astype(np.int32)
        lp_eff = np.minimum(lp, cur_maxlevel)
        ids_pad = _pad_to(ids.astype(np.int32), self.pad_batch, fill=int(ids[-1]))
        lp_pad = _pad_to(lp_eff, self.pad_batch, fill=-1)  # padded queries never beam
        q = vecs[jnp.asarray(ids_pad)]
        entry_dev = jnp.asarray(np.int32(entry))

        # route: level-0-only inserts (~97% at p=1/32) take the tuned staged
        # beam; the rare upper-level nodes run the full per-level program in
        # their own pow2-bucketed small batch (the full-batch lockstep used
        # to pay every upper level's beam iterations across all 4096 rows)
        up = np.nonzero(lp_eff >= 1)[0]
        stages = tuple(
            self.pad_batch // f for f in self.stages_frac
            if self.pad_batch // f >= 32
        )
        _, i0 = _build_search0(
            tuple(adj_dev), entry_dev, vecs, vn, q,
            jnp.asarray(lp_pad == 0),
            max_level=lmax, efc=cfg.ef_construction,
            max_iters=2 * cfg.ef_construction + 64, metric=cfg.metric,
            pop_width=self.pop_width, stages=stages,
            scan_width=self.scan_width,
        )
        i0_np = np.asarray(i0)[:b]  # one 2 MB D2H (dists are never used)
        pos_in_up = np.full(b, -1)
        cand_up_np = None
        if len(up):
            bup = _next_pow2(max(len(up), 32))
            q_up = vecs[jnp.asarray(
                _pad_to(ids[up].astype(np.int32), bup, fill=int(ids[up][0]))
            )]
            _, ci_up = _build_search(
                tuple(adj_dev), entry_dev, vecs, vn, q_up,
                jnp.asarray(_pad_to(lp_eff[up], bup, fill=-1)),
                max_level=lmax, efc=cfg.ef_construction,
                max_iters=2 * cfg.ef_construction + 64, metric=cfg.metric,
            )
            cand_up_np = np.asarray(ci_up)  # [lmax+1, bup, efc]
            pos_in_up[up] = np.arange(len(up))

        if timing:
            marks.append(("search", _time.perf_counter() - t0))
        touched: list[np.ndarray] = []
        for l in range(int(lp_eff.max(initial=0)), -1, -1):
            if timing:
                t0 = _time.perf_counter()
            active = lp_eff >= l
            if not active.any():
                continue
            aidx = np.nonzero(active)[0]
            a_ids = ids[aidx]
            cap_l = cfg.maxM0 if l == 0 else cfg.maxM
            if l == 0:
                ci_np = i0_np.copy()
                if len(up):
                    ci_np[up] = cand_up_np[0][pos_in_up[up]]
                ci_np = ci_np[aidx]
            else:
                ci_np = cand_up_np[l][pos_in_up[aidx]]
            na = len(a_ids)
            if l == 0:  # whole batch: one compiled shape
                psize = self.pad_batch
            else:
                psize = _next_pow2(na)
            # dup-row padding (not -1/0 fill): the device result is scattered
            # directly below, and a duplicated id must write identical content
            ci_pad = _pad_dup(ci_np, psize)
            aid_pad = _pad_to(
                a_ids.astype(np.int32), psize, fill=int(a_ids[0])
            )
            # forward selection: heuristic to M with the under-M early-out
            # (mutuallyConnectNewElement -> getNeighborsByHeuristic2,
            #  hnswalg.h:549-560)
            aid_dev = jnp.asarray(aid_pad)
            sel_dev, _ = prune_batch(
                vecs, vn, aid_dev, jnp.asarray(ci_pad),
                jnp.asarray(ci_pad >= 0),
                M=cfg.M, keep_all_under_m=True, metric=cfg.metric,
            )
            # device-direct forward scatter: the pruned rows never leave the
            # chip on the write path (the D2H below feeds only the host
            # mirror + reverse-edge planning)
            a = adj_dev[l]
            selw = sel_dev.shape[1]
            sel_full = (
                sel_dev[:, :cap_l] if selw >= cap_l
                else jnp.pad(
                    sel_dev, ((0, 0), (0, cap_l - selw)), constant_values=-1
                )
            )
            a = a.at[aid_dev].set(sel_full)
            sel = np.asarray(sel_dev)[:na]
            fwd_rows = np.full((len(a_ids), cap_l), -1, np.int32)
            fwd_rows[:, : sel.shape[1]] = sel
            if timing:
                marks.append((f"L{l}.fwd", _time.perf_counter() - t0))
                t0 = _time.perf_counter()

            # reverse targets live in the pre-batch graph, disjoint from a_ids
            rev_targets, rev_rows, fit_plan, of_idx, a = self._reverse_connect(
                l, a_ids, sel, adj_np[l], cap_l, vecs, vn, a
            )
            if timing:
                marks.append((f"L{l}.rev", _time.perf_counter() - t0))
                t0 = _time.perf_counter()

            upd_ids = np.concatenate([a_ids, rev_targets]).astype(np.int32)
            upd_rows = np.concatenate([fwd_rows, rev_rows], axis=0)
            adj_np[l][upd_ids] = upd_rows  # host mirror: full rows, cheap
            # Device scatter in CONSTANT-shape chunks. Every fresh shape
            # compiles a fresh program, and data-dependent pow2 buckets
            # churn through dozens of variants across a 1M build. Two fixed
            # programs per level width:
            #   full rows  (inserted nodes + overflow/big-append targets)
            #   compact fit (append <= FIT_K edges: gather -> dense
            #   compare-combine -> row scatter, not an element-wise
            #   `.at[r, c].set`)
            # forward rows and overflow rows were already scattered on
            # device; only the big-append rows (> FIT_K new edges but still
            # fitting) still ship as host-composed full rows
            full_ids = rev_targets[of_idx]
            full_rows = rev_rows[of_idx]
            # bucket LADDER, not fixed chunks: shapes must be few (each
            # fresh shape compiles) but dispatches must be few too (each
            # eager op chain pays a dispatch and a sync)
            for ck, size in _ladder_chunks(len(full_ids), (2048, 16384,
                                                           131072)):
                ids_pad2 = _pad_to(
                    full_ids[ck], size, fill=int(full_ids[ck.start])
                )
                rows_pad2 = np.broadcast_to(
                    full_rows[ck.start], (size, full_rows.shape[1])
                ).copy()
                rows_pad2[: ck.stop - ck.start] = full_rows[ck]
                a = a.at[jnp.asarray(ids_pad2)].set(jnp.asarray(rows_pad2))
            if fit_plan is not None:
                fit_ids, fit_cols, fit_vals = fit_plan
                col_iota = jnp.arange(cap_l)[None, None, :]
                for ck, size in _ladder_chunks(len(fit_ids), (8192, 131072)):
                    # pad by duplicating row 0 so the duplicated id writes
                    # identical content (duplicate scatters are then benign)
                    fi = _pad_to(
                        fit_ids[ck], size, fill=int(fit_ids[ck.start])
                    )
                    fc = np.broadcast_to(
                        fit_cols[ck.start], (size, fit_cols.shape[1])
                    ).copy()
                    fc[: ck.stop - ck.start] = fit_cols[ck]
                    fv = np.broadcast_to(
                        fit_vals[ck.start], (size, fit_vals.shape[1])
                    ).copy()
                    fv[: ck.stop - ck.start] = fit_vals[ck]
                    fi_d = jnp.asarray(fi)
                    cur = a[fi_d]  # [F, cap_l] row gather
                    hitc = jnp.asarray(fc)[:, :, None] == col_iota
                    upd = jnp.max(
                        jnp.where(hitc, jnp.asarray(fv)[:, :, None], -1),
                        axis=1,
                    )
                    a = a.at[fi_d].set(jnp.where(upd >= 0, upd, cur))
            adj_dev[l] = a
            touched.append(upd_ids)
            if timing:
                marks.append((f"L{l}.scatter", _time.perf_counter() - t0))
        out = (np.unique(np.concatenate(touched)).astype(np.int64)
               if touched else np.zeros(0, np.int64))
        if timing:
            print("    insert_batch: " + " ".join(
                f"{k}={v:.2f}s" for k, v in marks if v >= 0.05
            ), flush=True)
            marks.append(("wall", _time.perf_counter() - t_batch))
            for k, v in marks:
                # collapse per-level labels: L3.fwd -> fwd
                key = k.split(".", 1)[-1]
                self.phase_s[key] = self.phase_s.get(key, 0.0) + v
        return out

    def _reverse_connect(self, l, a_ids, sel, adj_l, cap_l, vecs, vn, a_dev):
        """Reverse edges u->p for each forward edge p->u (hnswalg.h:618-687):
        append while the target row has room, else heuristic-prune
        {existing ∪ new} down to the level cap.

        Returns (uniq, out_rows, fit_plan, ship, a_dev) where fit_plan is
        None or (fit_ids, fit_cols[:, FIT_K], fit_vals[:, FIT_K]): targets
        appending <= FIT_K edges, shipped as a constant-width compact update;
        `ship` indexes the big-append rows (> FIT_K but fitting) that go as
        full rows. Overflow rows are scattered into a_dev here, directly
        from the device prune output (no H2D re-upload)."""
        cfg = self.cfg
        mask = sel >= 0
        pairs_u = sel[mask]
        pairs_p = np.repeat(a_ids, mask.sum(axis=1))
        if len(pairs_u) == 0:
            return (np.zeros((0,), np.int32),
                    np.zeros((0, cap_l), np.int32), None,
                    np.zeros((0,), np.int64), a_dev)

        order = np.argsort(pairs_u, kind="stable")
        us, ps = pairs_u[order], pairs_p[order]
        uniq, starts, counts = np.unique(us, return_index=True, return_counts=True)
        max_new = _next_pow2(int(counts.max()))
        newmat = np.full((len(uniq), max_new), -1, np.int32)
        col = np.arange(len(us)) - np.repeat(starts, counts)
        row = np.repeat(np.arange(len(uniq)), counts)
        newmat[row, col] = ps

        existing = adj_l[uniq]  # [U, cap_l]
        ne = (existing >= 0).sum(axis=1)
        total = ne + counts
        out_rows = existing.copy()

        # fit = append-only AND few new edges: ships as a compact fixed-width
        # (col, val) update. The width is a CONSTANT 8 so the device program
        # compiles once — every fresh (rows, kmax) pair compiles a program,
        # and data-dependent pow2 buckets would churn through dozens of
        # variants across a 1M build. Targets appending >8 edges simply
        # take the overflow path (same result: a full-row write).
        FIT_K = 8
        fits = total <= cap_l
        pair_fits = fits[row]
        r, c = row[pair_fits], col[pair_fits]
        out_rows[r, ne[r] + c] = newmat[r, c]

        # fitting rows appending > FIT_K edges keep append semantics but
        # ship as full rows (rare hub events; constant compact width wins)
        fidx = np.nonzero(fits & (counts <= FIT_K))[0]
        fit_plan = None
        if len(fidx):
            fit_cols = np.full((len(fidx), FIT_K), cap_l, np.int32)  # OOB
            fit_vals = np.full((len(fidx), FIT_K), -1, np.int32)
            inv = np.full(len(uniq), -1)
            inv[fidx] = np.arange(len(fidx))
            rf, cf = inv[r], c
            sub = rf >= 0  # pairs of compact-update rows only
            fit_cols[rf[sub], cf[sub]] = (ne[r][sub] + cf[sub]).astype(np.int32)
            fit_vals[rf[sub], cf[sub]] = newmat[r, c][sub]
            fit_plan = (uniq[fidx].astype(np.int32), fit_cols, fit_vals)

        of = np.nonzero(~fits)[0]
        if len(of):
            # canonical prune shapes: ladder row sizes, candidate width
            # always cap_l + 64 — a fresh shape costs ~3 s on the remote
            # compiler and the variable (pow2(|of| tail), cap_l + max_new)
            # pair used to generate dozens of variants across a 1M build
            # (the 8-10 s rev spikes in the r3 selfbuild log)
            w_new = min(max_new, 64)
            newpad = np.full((len(of), 64), -1, np.int32)
            # targets with >64 new reverse edges keep the first 64 in
            # arrival order (the reference's sequential appends behave
            # comparably; >64 is a rare hub event at cap_l=64)
            newpad[:, :w_new] = newmat[of, :w_new]
            cand = np.concatenate([existing[of], newpad], axis=1)
            sels = []
            # ladder sizes: one program per size, but usually ONE dispatch
            # per batch — the per-call dispatch+sync latency outweighs the
            # compute of a small chunk
            for ck, size in _ladder_chunks(len(of), (2048, 8192)):
                # dup-row padding: the duplicated id's scatter writes
                # identical content (prune_batch is row-wise deterministic)
                cpad = _pad_dup(cand[ck], size)
                upad = _pad_to(
                    uniq[of][ck], size, fill=int(uniq[of][ck.start])
                )
                upad_dev = jnp.asarray(upad)
                sel_r, _ = prune_batch(
                    vecs, vn,
                    upad_dev,
                    jnp.asarray(cpad),
                    jnp.asarray(cpad >= 0),
                    M=cap_l, keep_all_under_m=False, metric=cfg.metric,
                    out_width=cap_l,
                )
                # device-direct scatter of the pruned rows (out_width ==
                # cap_l, so no reshape); the D2H below feeds only the host
                # mirror
                a_dev = a_dev.at[upad_dev].set(sel_r)
                # D2H the full canonical block and slice on HOST — a device
                # slice sel_r[:k] is a fresh program per distinct k
                sels.append(np.asarray(sel_r)[: ck.stop - ck.start])
            allsel = sels[0] if len(sels) == 1 else np.concatenate(sels)
            out_rows[of] = allsel[: len(of)]
        # full-row ship set: big-fit appends (> FIT_K) only — overflow rows
        # were already written device-side above
        ship = np.nonzero(fits & (counts > FIT_K))[0]
        return uniq.astype(np.int32), out_rows, fit_plan, ship, a_dev
