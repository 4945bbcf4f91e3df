"""Vectorized relative-neighborhood (RNG) heuristic pruning.

Port of getNeighborsByHeuristic2 (reference hnswalg.h:481-523) and
PruneByHeuristic (hnswalg_slim.h:836-865): walk candidates in ascending
distance order; keep a candidate iff no already-kept neighbor is closer to it
than the base point is. On the device this is a vmapped O(C²)
pairwise-distance matmul + a scan over sorted positions, batched over
thousands of nodes.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax

from ..ops import distance

INF = jnp.float32(jnp.inf)


def _prune_one(cand_d, pd, valid, m, keep_all_under_m: bool):
    """Single-node prune over DISTANCE-SORTED inputs: cand_d f32[C] ascending
    (invalid lanes sorted last), pd f32[C, C] pairwise candidate distances in
    the same order, valid bool[C], m = budget (scalar, may be traced).
    Returns kept bool[C] (in sorted positions) and kept count.

    Implemented as lax.scan over the sorted walk with one-hot writes
    instead of scalar dynamic indexing (order[i] gathers, kept.at[ci].set
    scatters) inside a fori_loop under vmap: a backend once miscompiled that
    form silently, returning first-m-by-position picks. chip_smoke.py checks
    this prune on the GPU against JAX's CPU backend. The pre-sort happens
    batched in _prune_batch_impl."""
    c = cand_d.shape[0]
    iota = jnp.arange(c)

    def step(carry, x):
        kept, cnt, i = carry
        di, vi, pdcol = x
        # reference: reject if any kept neighbor is closer to ci than base
        conflict = jnp.any(kept & (pdcol < di))
        good = vi & (cnt < m) & ~conflict
        kept = kept | ((iota == i) & good)
        return (kept, cnt + good.astype(jnp.int32), i + 1), None

    (kept, cnt, _), _ = lax.scan(
        step,
        (jnp.zeros((c,), bool), jnp.int32(0), jnp.int32(0)),
        (cand_d, valid, pd),  # pd rows == columns of the symmetric matrix
    )
    if keep_all_under_m:
        # getNeighborsByHeuristic2 early-out: fewer than M candidates -> keep all
        nvalid = jnp.sum(valid.astype(jnp.int32))
        under = nvalid < m
        kept = jnp.where(under, valid, kept)
        cnt = jnp.where(under, nvalid, cnt)
    return kept, cnt


def _prune_one_guarded(cand_d, pd, valid, guard, m):
    """SlimZero variant (hnswalg_slimzero.h PruneByHeuristic :820-894) over
    DISTANCE-SORTED inputs (see _prune_one): pass 1 reserves every candidate
    whose in-degree guard is set, unconditionally; pass 2 fills the rest in
    ascending distance by the RNG rule against ALL kept entries, capped at m
    total. Scan + one-hot writes only — no in-loop dynamic indexing."""
    c = cand_d.shape[0]
    iota = jnp.arange(c)

    kept0 = valid & guard  # pass 1: reserved low-indegree nodes
    cnt0 = jnp.sum(kept0.astype(jnp.int32))

    def step(carry, x):
        kept, cnt, i = carry
        di, vi, gi, pdcol = x
        conflict = jnp.any(kept & (pdcol < di))
        good = vi & ~gi & (cnt < m) & ~conflict
        kept = kept | ((iota == i) & good)
        return (kept, cnt + good.astype(jnp.int32), i + 1), None

    (kept, cnt, _), _ = lax.scan(
        step, (kept0, cnt0, jnp.int32(0)), (cand_d, valid, guard, pd)
    )
    return kept, cnt


def _sorted_prune_inputs(vectors, vn, cand_d, valid, cand_ids, metric,
                         precision):
    """Batched ascending-(masked)distance reorder of the candidate arrays,
    with the pairwise-distance tensor computed directly ON the sorted ids
    (a second row gather from `vectors` — cheaper than permuting a [B, C, C]
    tensor, and fp-identical since each pair's dot is computed from the same
    two vectors). Returns (d_s, pd_s, v_s, ids_s)."""
    b, c = cand_d.shape
    masked = jnp.where(valid, cand_d, INF)
    iota = lax.broadcasted_iota(jnp.int32, (b, c), 1)
    _, perm = lax.sort((masked, iota), dimension=1, num_keys=1)
    d_s = jnp.take_along_axis(cand_d, perm, axis=1)
    v_s = jnp.take_along_axis(valid, perm, axis=1)
    ids_s = jnp.take_along_axis(cand_ids, perm, axis=1)
    safe_s = jnp.maximum(ids_s, 0)
    cvecs_s = vectors[safe_s].astype(jnp.float32)
    cn_s = vn[safe_s]
    dots = jnp.einsum(
        "bcd,bed->bce", cvecs_s, cvecs_s,
        preferred_element_type=jnp.float32, precision=precision,
    )
    pd_s = 1.0 - dots if metric == "ip" else (
        cn_s[:, :, None] + cn_s[:, None, :] - 2.0 * dots
    )
    return d_s, pd_s, v_s, ids_s


@functools.partial(
    jax.jit, static_argnames=("M", "metric", "out_width")
)
def prune_batch_guarded(
    vectors: jnp.ndarray,
    vn: jnp.ndarray,
    base_ids: jnp.ndarray,
    cand_ids: jnp.ndarray,
    valid: jnp.ndarray,
    guard: jnp.ndarray,  # bool[B, C]: candidate indegree <= min_indegree
    *,
    M: int,
    metric: str = "l2",
    out_width: int = 0,
    precision=jax.lax.Precision.HIGHEST,
    m_per_row: jnp.ndarray | None = None,
):
    """Batched SlimZero guarded prune. Guarded candidates are always kept
    (connectivity preserved by the in-degree floor instead of reverse-edge
    augmentation, hnswalg_slimzero.h:966-1000)."""
    return _prune_batch_guarded_impl(
        vectors, vn, base_ids, cand_ids, valid, guard, M, metric,
        out_width or M, precision, m_per_row,
    )


def _prune_batch_guarded_impl(vectors, vn, base_ids, cand_ids, valid, guard,
                              M, metric, w, precision, m_per_row):
    safe = jnp.maximum(cand_ids, 0)
    cvecs = vectors[safe].astype(jnp.float32)
    cn = vn[safe]
    bvec = vectors[base_ids].astype(jnp.float32)
    bn = vn[base_ids]
    cand_d = distance.gathered_dist(
        bvec, cvecs, metric, qn=bn, vn=cn, precision=precision
    )
    valid = valid & (cand_ids >= 0) & (cand_ids != base_ids[:, None])
    if m_per_row is None:
        m_per_row = jnp.full((cand_ids.shape[0],), M, jnp.int32)
    # sort guard along with the row (one extra [B, C] gather)
    b, c = cand_d.shape
    masked = jnp.where(valid, cand_d, INF)
    iota = lax.broadcasted_iota(jnp.int32, (b, c), 1)
    _, perm = lax.sort((masked, iota), dimension=1, num_keys=1)
    g_s = jnp.take_along_axis(guard & valid, perm, axis=1)
    d_s, pd_s, v_s, ids_s = _sorted_prune_inputs(
        vectors, vn, cand_d, valid, cand_ids, metric, precision
    )
    kept, cnt = jax.vmap(_prune_one_guarded)(d_s, pd_s, v_s, g_s, m_per_row)
    return _pack_kept(kept, cnt, d_s, ids_s, w)


@functools.partial(
    jax.jit,
    static_argnames=("M", "keep_all_under_m", "metric", "out_width", "chunk",
                     "keep_pruned"),
)
def prune_all(
    vectors: jnp.ndarray,
    vn: jnp.ndarray,
    base_ids: jnp.ndarray,  # i32[Npad] (pad with 0)
    cand_ids: jnp.ndarray,  # i32[Npad, C] (pad with -1)
    m_per_row: jnp.ndarray,  # i32[Npad] (pad with 1)
    *,
    M: int,
    keep_all_under_m: bool,
    metric: str = "l2",
    out_width: int = 0,
    chunk: int = 2048,
    precision=jax.lax.Precision.HIGHEST,
    keep_pruned: bool = False,
):
    """Whole-array heuristic prune with internal fori chunking: ONE device
    dispatch for all nodes (a per-chunk python loop pays a host sync per
    chunk). Npad must be a multiple of `chunk`."""
    w = out_width or M
    n = base_ids.shape[0]
    out = jnp.full((n, w), -1, jnp.int32)

    def body(i, out):
        s = i * chunk
        b = lax.dynamic_slice_in_dim(base_ids, s, chunk, 0)
        c = lax.dynamic_slice_in_dim(cand_ids, s, chunk, 0)
        m = lax.dynamic_slice_in_dim(m_per_row, s, chunk, 0)
        sel, _ = _prune_batch_impl(
            vectors, vn, b, c, c >= 0, M, keep_all_under_m, metric, w,
            precision, m, keep_pruned,
        )
        return lax.dynamic_update_slice_in_dim(out, sel, s, 0)

    return lax.fori_loop(0, n // chunk, body, out)


@functools.partial(
    jax.jit,
    static_argnames=("M", "keep_all_under_m", "metric", "out_width",
                     "keep_pruned"),
)
def prune_batch(
    vectors: jnp.ndarray,
    vn: jnp.ndarray,
    base_ids: jnp.ndarray,  # i32[B]
    cand_ids: jnp.ndarray,  # i32[B, C]
    valid: jnp.ndarray,  # bool[B, C]
    *,
    M: int,
    keep_all_under_m: bool,
    metric: str = "l2",
    out_width: int = 0,
    precision=jax.lax.Precision.HIGHEST,
    m_per_row: jnp.ndarray | None = None,  # i32[B] overrides M per node
    keep_pruned: bool = False,
):
    """Heuristic-prune candidate lists for a batch of base nodes.

    Distances are recomputed on device (one [B,C,d] gather + einsum for
    base→cand, one [B,C,C] matmul for cand pairwise). Returns
    sel_ids i32[B, W] in ascending distance order, -1 padded
    (W = out_width or M). m_per_row supports the Slim hub/low budgets
    (hnswalg_slim.h:966-971).
    """
    return _prune_batch_impl(
        vectors, vn, base_ids, cand_ids, valid, M, keep_all_under_m, metric,
        out_width or M, precision, m_per_row, keep_pruned,
    )


def _prune_batch_impl(vectors, vn, base_ids, cand_ids, valid, M,
                      keep_all_under_m, metric, w, precision, m_per_row,
                      keep_pruned=False):
    safe = jnp.maximum(cand_ids, 0)
    cvecs = vectors[safe].astype(jnp.float32)  # [B, C, d]
    cn = vn[safe]
    bvec = vectors[base_ids].astype(jnp.float32)  # [B, d]
    bn = vn[base_ids]
    cand_d = distance.gathered_dist(
        bvec, cvecs, metric, qn=bn, vn=cn, precision=precision
    )
    valid = valid & (cand_ids >= 0) & (cand_ids != base_ids[:, None])
    if m_per_row is None:
        m_per_row = jnp.full((cand_ids.shape[0],), M, jnp.int32)
    d_s, pd_s, v_s, ids_s = _sorted_prune_inputs(
        vectors, vn, cand_d, valid, cand_ids, metric, precision
    )
    kept, cnt = jax.vmap(
        lambda d, p, v, m: _prune_one(d, p, v, m, keep_all_under_m)
    )(d_s, pd_s, v_s, m_per_row)

    if keep_pruned:
        # backfill RNG-rejected candidates (nearest first) up to the budget.
        # NOT reference semantics (getNeighborsByHeuristic2 keeps only RNG
        # survivors) — used by the NND build path, whose candidate sets are
        # exact kNN lists: maximally tight, so the RNG rule intercepts almost
        # everything and leaves rows far sparser than the insertion build's
        # (measured at 1M clustered: mean degree 16 vs 24, 2-hop GT coverage
        # 0.72 vs 0.92). The slim conversion re-prunes with its own budgets.
        # Rows are distance-sorted here, so "nearest first" = ascending
        # position among fill_ok lanes (a cumsum, no argsort needed).
        c = ids_s.shape[1]
        lt = jnp.arange(c)[:, None] < jnp.arange(c)[None, :]  # [j, i]: j < i
        eq = ids_s[:, :, None] == ids_s[:, None, :]  # [B, j, i]
        dup = jnp.any(eq & v_s[:, :, None] & lt[None], axis=1)
        dup_of_kept = jnp.any(eq & kept[:, :, None], axis=1)
        fill_ok = v_s & ~kept & ~dup & ~dup_of_kept
        rank2 = jnp.cumsum(fill_ok.astype(jnp.int32), axis=1) - 1
        extra = fill_ok & (rank2 < (m_per_row - cnt)[:, None])
        kept = kept | extra
        cnt = cnt + jnp.sum(extra, axis=1).astype(jnp.int32)

    return _pack_kept(kept, cnt, d_s, ids_s, w)


def _pack_kept(kept, cnt, d_s, ids_s, w):
    """Pack kept lanes (already distance-sorted rows) to the front with one
    multi-operand lax.sort; -1 beyond cnt."""
    key = jnp.where(kept, d_s, INF)
    ids2 = jnp.where(kept, ids_s, -1)
    _, sel_full = lax.sort((key, ids2), dimension=1, num_keys=1)
    sel = sel_full[:, :w]
    pos = jax.lax.broadcasted_iota(jnp.int32, sel.shape, 1)
    sel = jnp.where(pos < cnt[:, None], sel, -1)
    if sel.shape[1] < w:  # fewer candidates than the requested output width
        sel = jnp.pad(sel, ((0, 0), (0, w - sel.shape[1])), constant_values=-1)
    return sel, cnt
