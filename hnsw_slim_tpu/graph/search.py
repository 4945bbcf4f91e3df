"""Batched best-first graph search — the engine's hottest path.

Reference: the sequential heap loops searchBaseLayerST (hnswalg_slim.h:320-457)
and the greedy upper-level descent (hnswalg_slim.h:2040-2078). Here the whole
query batch advances in lockstep inside `lax.while_loop`s:

* greedy descent: every query holds one current node; one masked neighbor
  gather + one fused distance matmul per step; per-query done masks.
* beam search: every query holds a SORTED top-ef buffer (ids, dists, checked
  bits) — the array-based SearchBuffer the reference itself adopted for SlimQ
  (hnswalg_slimq.h:80-151). Each iteration pops the best unchecked entry per
  query, gathers its ≤W neighbors, scores them with one [B, W, d] einsum, and
  merges with a single multi-operand `lax.sort`.

Design choices:
* merge via one multi-operand lax.sort((dist, id, chk), num_keys=1) over
  the buffer and the scored candidates, so payloads move with their keys
  and no per-row payload gather is needed.
* selection/pop via masks and one sort by pop rank, not scatter/gather.
* NO visited table: candidates are deduped against the buffer, and a node
  that fell out of the sorted top-ef can never re-enter (the buffer's worst
  distance only decreases), so termination is guaranteed. Re-scanning an
  already-seen neighbor merely wastes one of the W distance lanes — cheaper
  than the epoch-tagged VisitedList (visited_list_pool.h:10-77) it replaces.

Termination matches the reference exactly: a query stops when its best
unchecked candidate is farther than the worst of its full top-ef buffer.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

from ..ops import distance

INF = jnp.float32(jnp.inf)


def make_chal_fetch(nbr: jnp.ndarray, lvl_off: jnp.ndarray, l: int, width: int):
    """Neighbor fetch for a ChalGraph level: ids i32[B, width], -1 padded."""

    def fetch(v: jnp.ndarray) -> jnp.ndarray:
        start = lvl_off[v, l]
        end = lvl_off[v, l + 1]
        idx = start[:, None] + jax.lax.broadcasted_iota(
            jnp.int32, (v.shape[0], width), 1
        )
        valid = idx < end[:, None]
        ids = nbr[jnp.clip(idx, 0, nbr.shape[0] - 1)]
        return jnp.where(valid, ids, -1)

    return fetch


def make_dense_fetch(adj_l: jnp.ndarray):
    """Neighbor fetch for a LevelGraph level (dense padded rows)."""

    def fetch(v: jnp.ndarray) -> jnp.ndarray:
        return adj_l[v]

    return fetch


def make_rank_fetch(rank: jnp.ndarray, dense_l: jnp.ndarray):
    """Neighbor fetch through a rank indirection: `rank` i32[N_pad] maps a
    node id to its row in `dense_l` i32[R_pad, cap] (-1 = node has no row
    at this level). Two HBM transactions per pop (rank scalar + one row)
    instead of per-edge scalar gathers from the flat CHAL array — the dense
    upper-level serving layout (see index/slim.py densify_upper)."""

    def fetch(v: jnp.ndarray) -> jnp.ndarray:
        r = rank[v]
        rows = dense_l[jnp.maximum(r, 0)]
        return jnp.where(r[:, None] >= 0, rows, -1)

    return fetch


def make_exact_scorer(vectors, vn, q, qn, metric, precision):
    """Scorer: exact fused-matmul distances (the Slim path).

    Neighbor norms are recomputed from the gathered rows (an elementwise
    reduction) rather than gathered from the N-sized norm array: a random
    scalar gather per neighbor is one more scattered memory access for
    data the row already holds.
    """
    del vn  # kept in the signature for call-site compatibility

    def score(safe_ids, valid):
        vecs = vectors[safe_ids]
        d = distance.gathered_dist(
            q, vecs, metric, qn=qn, vn=None, precision=precision
        )
        return jnp.where(valid, d, INF)

    return score


def greedy_level_scored(
    fetch: Callable,
    score: Callable,
    cur: jnp.ndarray,
    curdist: jnp.ndarray,
    active: jnp.ndarray,
):
    """One level of greedy descent with a pluggable scorer (exact for Slim,
    quantized estimate for SlimQ — hnswalg_slimq.h:1862-1901)."""

    def cond(state):
        _, _, changed = state
        return jnp.any(changed)

    def body(state):
        cur, curdist, changed = state
        ids = fetch(cur)
        valid = (ids >= 0) & changed[:, None]
        safe = jnp.maximum(ids, 0)
        d = score(safe, valid)
        dmin = jnp.min(d, axis=1)
        # one-hot argmin (scatter-free): smallest id among minimal-distance lanes
        best = jnp.min(jnp.where(d == dmin[:, None], safe, jnp.int32(2**30)), axis=1)
        better = dmin < curdist
        cur = jnp.where(better, best, cur)
        curdist = jnp.where(better, dmin, curdist)
        return cur, curdist, changed & better

    cur, curdist, _ = lax.while_loop(cond, body, (cur, curdist, active))
    return cur, curdist


def greedy_level(
    fetch: Callable,
    vectors: jnp.ndarray,
    vn: jnp.ndarray,
    q: jnp.ndarray,
    qn: jnp.ndarray,
    cur: jnp.ndarray,
    curdist: jnp.ndarray,
    active: jnp.ndarray,
    metric: str,
    precision,
):
    """Greedy descent with exact distances (hnswalg_slim.h:2040-2078)."""
    score = make_exact_scorer(vectors, vn, q, qn, metric, precision)
    return greedy_level_scored(fetch, score, cur, curdist, active)


class BeamState(NamedTuple):
    buf_d: jnp.ndarray  # f32[B, EF] sorted ascending, inf padded
    buf_id: jnp.ndarray  # i32[B, EF], -1 padded
    buf_chk: jnp.ndarray  # i32[B, EF] 1 = expanded


def beam_init(seed_id: jnp.ndarray, seed_d: jnp.ndarray, ef: int) -> BeamState:
    """Buffer seeded with one entry per query (hnswalg_slim.h:2101-2106)."""
    b = seed_id.shape[0]
    buf_d = jnp.full((b, ef), INF).at[:, 0].set(seed_d)
    buf_id = jnp.full((b, ef), -1, jnp.int32).at[:, 0].set(seed_id)
    buf_chk = jnp.zeros((b, ef), jnp.int32)
    return BeamState(buf_d, buf_id, buf_chk)


def beam_reseed(state: BeamState, seed_id: jnp.ndarray, seed_d: jnp.ndarray, active):
    """Replace the buffer rows of `active` queries with a fresh single seed
    (used when a build query transitions from greedy descent to beam)."""
    b = seed_id.shape[0]
    ef = state.buf_d.shape[1]
    new_d = jnp.full((b, ef), INF).at[:, 0].set(seed_d)
    new_id = jnp.full((b, ef), -1, jnp.int32).at[:, 0].set(seed_id)
    return BeamState(
        jnp.where(active[:, None], new_d, state.buf_d),
        jnp.where(active[:, None], new_id, state.buf_id),
        jnp.where(active[:, None], 0, state.buf_chk),
    )


class FilterTrack(NamedTuple):
    """Allowed-only result buffer for filtered search (BaseFilterFunctor
    semantics, hnswlib.h:124-133 via hnswalg.h searchBaseLayerST's
    non-bare-bone path): disallowed nodes are traversed but never returned,
    and the termination bound comes from this buffer — so the search keeps
    expanding until ef ALLOWED results are found (k-guarantee under heavy
    filtering, unlike post-hoc masking of the traversal buffer)."""

    res_d: jnp.ndarray  # f32[B, EF] sorted ascending, inf padded
    res_id: jnp.ndarray  # i32[B, EF], -1 padded


def filter_track_init(b: int, ef: int) -> FilterTrack:
    return FilterTrack(
        jnp.full((b, ef), INF), jnp.full((b, ef), -1, jnp.int32)
    )


def beam_level_scored(
    fetch: Callable,
    score: Callable,
    state: BeamState,
    active: jnp.ndarray,
    ef: int,
    max_iters: int,
    pop_width: int = 1,
    ef_eff: jnp.ndarray | None = None,
    pop_state=None,
    pop_hook: Callable | None = None,
    allowed: jnp.ndarray | None = None,
    ftrack: FilterTrack | None = None,
    stop_active_leq: int = 0,
    iter_start: jnp.ndarray | None = None,
    return_done: bool = False,
    scan_width: int = 0,
) -> BeamState:
    """Best-first beam search at one level with a pluggable scorer.

    Equivalent of searchBaseLayerST (hnswalg_slim.h:320-457): pop the best
    unchecked entries, expand neighbors, merge into top-ef, stop when the
    best unchecked candidate exceeds the worst buffered distance.

    pop_hook(pop_state, popped_ids i32[B, E], popped_mask bool[B, E]) is
    invoked on each iteration's popped nodes — SlimQ uses it to keep an
    exact-distance result track like the reference's per-pop rerank
    (hnswalg_slimq.h:747-757).

    pop_width > 1 expands the E best unchecked entries per iteration
    (DiskANN-style beamwidth): fewer, fatter device steps; recall at equal
    ef is unchanged or better (a strict superset of nodes is expanded).

    ef_eff (traced scalar, <= ef) restricts the working buffer to its first
    ef_eff slots: one compiled program serves any runtime ef (the reference's
    free setEf, hnswalg_slim.h:346-349), trading sort width for compile reuse.

    allowed (bool[N]) + ftrack enable filtered search: scored candidates
    where allowed[id] merge into ftrack, and the termination bound switches
    to ftrack's worst (reference lowerBound over allowed-only top_candidates,
    hnswalg.h searchBaseLayerST). Returns (state, hops, dcomp, pop_state,
    ftrack) — 5-tuple — when filtering.

    stop_active_leq > 0 additionally exits the lockstep loop once at most
    that many queries are still active (the staggered straggler pass picks
    them up in a smaller batch — see beam_level_staged); iter_start carries
    the lockstep iteration budget across stages; return_done appends
    (done bool[B], iters) to the return tuple.
    """
    b = active.shape[0]
    pos = jax.lax.broadcasted_iota(jnp.int32, (b, ef), 1)
    e = pop_width

    def cond(carry):
        _, done, iters, _, _, _, _ = carry
        go = jnp.any(~done) & (iters < max_iters)
        if stop_active_leq > 0:
            go &= jnp.sum((~done).astype(jnp.int32)) > stop_active_leq
        return go

    def body(carry):
        st, done, iters, hops, dcomp, pstate, ftr = carry
        buf_d, buf_id, buf_chk = st
        unchk = (buf_chk == 0) & (buf_id >= 0)
        if ef_eff is not None:
            unchk = unchk & (pos < ef_eff)
            bound = jnp.take_along_axis(
                buf_d, jnp.broadcast_to(ef_eff - 1, (b,))[:, None], axis=1
            )[:, 0]
        else:
            bound = buf_d[:, ef - 1]  # inf while not full
        if ftr is not None:
            # allowed-only lowerBound: keep searching until ef allowed
            # results exist, then stop as usual (hnswalg.h non-bare-bone)
            if ef_eff is not None:
                fbound = jnp.take_along_axis(
                    ftr.res_d, jnp.broadcast_to(ef_eff - 1, (b,))[:, None],
                    axis=1,
                )[:, 0]
            else:
                fbound = ftr.res_d[:, ef - 1]
            bound = fbound
        # rank among unchecked; buffer is sorted so rank orders by distance
        rank = jnp.cumsum(unchk.astype(jnp.int32), axis=1) - 1
        # termination judged on the single best unchecked (reference rule)
        first = unchk & (rank == 0)
        has = jnp.any(first, axis=1)
        sel_d = jnp.max(jnp.where(first, buf_d, -INF), axis=1)
        qdone = done | ~has | (sel_d > bound)

        # expand up to E unchecked entries within the bound
        selmask = unchk & (rank < e) & (buf_d <= bound[:, None]) & (
            ~qdone[:, None]
        )
        buf_chk = jnp.where(selmask, 1, buf_chk)

        # extract the E popped ids with ONE 2-operand sort by pop rank
        # instead of E one-hot masked-max passes over [B, P]. Ranks are
        # unique among selected lanes, so the first E sorted lanes are
        # exactly the pops in ascending-distance order.
        popkey = jnp.where(selmask, rank, jnp.int32(2**30))
        sk, sv = lax.sort((popkey, buf_id), dimension=1, num_keys=1)
        pops = jnp.where(sk[:, :e] < 2**30, sv[:, :e], -1)  # [B, E]
        if pop_hook is not None:
            pstate = pop_hook(pstate, pops, pops >= 0)

        # ONE row gather for all E pops (both fetch forms are shape-generic
        # in the leading dim; E separate gather ops pay E dispatch/fusion
        # boundaries for the same HBM transactions)
        idsf = fetch(jnp.maximum(pops, 0).reshape(b * e))
        fw = idsf.shape[1]
        ids = jnp.where(
            (pops >= 0)[:, :, None], idsf.reshape(b, e, fw), -1
        ).reshape(b, e * fw)  # [B, E*W]

        valid = (ids >= 0) & ~qdone[:, None]

        # compact before the gather: slim rows average ~a quarter of the
        # padded width, and each gathered vector row is a scattered memory
        # access — sorting the candidate ids packs the valid ones first
        # (and makes cross-expansion duplicates adjacent for free).
        # scan_width caps the surviving lanes (pruned-graph pops yield ~7
        # unique-new neighbors each, so a tight cap cuts the
        # gather+score+merge width with no measurable recall cost;
        # overflow lanes are simply dropped)
        ew = ids.shape[1]
        cw = min(ew, scan_width or max(2 * ef, 128)) if e > 1 else ew
        if e > 1 and 2 * cw < ew:
            # sort/intra-dedup FIRST, then buffer-dedup only a 2*cw
            # pre-window: a full [B, EW, P] broadcast compare is EW/(2*cw)
            # times the work. The final small sort packs the survivors, so
            # the scan window carries no intra-dup holes either.
            cs0 = lax.sort(jnp.where(valid, ids, jnp.int32(2**30)),
                           dimension=1)
            dup0 = jnp.concatenate(
                [jnp.zeros((b, 1), bool), cs0[:, 1:] == cs0[:, :-1]], axis=1)
            pre = jnp.where(dup0, jnp.int32(2**30), cs0)[:, : 2 * cw]
            dupb = jnp.any(pre[:, :, None] == buf_id[:, None, :], axis=2)
            pre = jnp.where(dupb, jnp.int32(2**30), pre)
            cand_sorted = lax.sort(pre, dimension=1)[:, :cw]
        else:
            dup = jnp.any(ids[:, :, None] == buf_id[:, None, :], axis=2)
            cand_ids = jnp.where(valid & ~dup, ids, jnp.int32(2**30))
            cand_sorted = lax.sort(cand_ids, dimension=1)
            if e > 1:
                dup2 = jnp.concatenate(
                    [jnp.zeros((b, 1), bool),
                     cand_sorted[:, 1:] == cand_sorted[:, :-1]],
                    axis=1,
                )
                cand_sorted = jnp.where(dup2, jnp.int32(2**30), cand_sorted)
            cand_sorted = cand_sorted[:, :cw]
        cand = cand_sorted < 2**30
        safe = jnp.where(cand, cand_sorted, 0)

        d = score(safe, cand)

        # search-effort counters (metric_hops / metric_distance_computations,
        # hnswalg_slim.h:70-71)
        hops = hops + jnp.sum(selmask.astype(jnp.int32), axis=1)
        dcomp = dcomp + jnp.sum(cand.astype(jnp.int32), axis=1)

        if ftr is not None:
            ok = cand & allowed[safe]
            # dedup against the track (a node can be scored twice: once as a
            # neighbor of two different pops across iterations)
            fdup = jnp.any(
                cand_sorted[:, :, None] == ftr.res_id[:, None, :], axis=2
            )
            fd = jnp.where(ok & ~fdup, d, INF)
            fc_d = jnp.concatenate([ftr.res_d, fd], axis=1)
            fc_i = jnp.concatenate(
                [ftr.res_id, jnp.where(ok & ~fdup, cand_sorted, -1)], axis=1
            )
            rd, ri = lax.sort((fc_d, fc_i), dimension=1, num_keys=1)
            ftr = FilterTrack(rd[:, :ef], ri[:, :ef])

        # merge: one multi-operand sort of buffer + candidates
        cand_id_col = jnp.where(cand, cand_sorted, -1)
        cat_d = jnp.concatenate([buf_d, d], axis=1)
        cat_i = jnp.concatenate([buf_id, cand_id_col], axis=1)
        cat_c = jnp.concatenate(
            [buf_chk, jnp.zeros_like(cand_sorted)], axis=1
        )
        sd, si, sc = lax.sort(
            (cat_d, cat_i, cat_c), dimension=1, num_keys=1
        )
        new_st = BeamState(sd[:, :ef], si[:, :ef], sc[:, :ef])
        return new_st, qdone, iters + 1, hops, dcomp, pstate, ftr

    zero = jnp.zeros((b,), jnp.int32)
    it0 = jnp.int32(0) if iter_start is None else iter_start
    out, done, iters, hops, dcomp, pop_state, ftrack = lax.while_loop(
        cond, body,
        (state, ~active, it0, zero, zero, pop_state, ftrack),
    )
    tail = (done, iters) if return_done else ()
    if allowed is not None:
        return (out, hops, dcomp, pop_state, ftrack) + tail
    return (out, hops, dcomp, pop_state) + tail


def beam_staged_scored(
    fetch: Callable,
    score_for: Callable,
    state: BeamState,
    active: jnp.ndarray,
    ef: int,
    max_iters: int,
    pop_width: int,
    ef_eff: jnp.ndarray | None,
    stage_sizes: tuple,
    scan_width: int = 0,
    pop_state=None,
    pop_hook_for: Callable | None = None,
    pop_state_index: Callable | None = None,
    pop_state_update: Callable | None = None,
):
    """Straggler-compacted beam with a pluggable scorer: run the full batch
    until at most stage_sizes[0] queries remain active, then compact the
    survivors into a stage_sizes[0]-wide sub-batch and continue (recursively
    down the stage list). The lockstep while_loop makes every query pay the
    slowest query's iteration count (measured 2-4x tail at 1M nodes); each
    compaction cuts the per-iteration cost by the batch ratio while
    preserving the exact per-query semantics (all beam updates are
    row-local, so a query computes the same result in any batch). Iteration
    budget (max_iters) is global across stages.

    score_for(idx) returns the scorer restricted to query rows idx (None =
    full batch); pop_hook_for(idx) likewise for the optional per-pop hook.
    pop_state_index(pstate, idx) / pop_state_update(pstate, idx, sub) subset
    and write back the hook's state across stages (SlimQ's exact-rerank
    result track)."""
    b = active.shape[0]
    # stages >= b would make the first lockstep loop exit immediately and
    # leave queries outside a later (smaller) stage unsearched — sanitize
    # here so every call-site is safe, not just HnswSlimIndex.search
    stage_sizes = tuple(sorted((s for s in stage_sizes if 0 < s < b),
                               reverse=True))
    hook = pop_hook_for(None) if pop_hook_for is not None else None
    if not stage_sizes:
        st, hops, dcomp, pstate = beam_level_scored(
            fetch, score_for(None), state, active, ef, max_iters, pop_width,
            ef_eff, pop_state=pop_state, pop_hook=hook,
            scan_width=scan_width,
        )
        return st, hops, dcomp, pstate
    st, hops, dcomp, pstate, done, iters = beam_level_scored(
        fetch, score_for(None), state, active, ef, max_iters, pop_width,
        ef_eff, pop_state=pop_state, pop_hook=hook,
        stop_active_leq=stage_sizes[0], return_done=True,
        scan_width=scan_width,
    )
    buf_d, buf_id, buf_chk = st
    for si, bs in enumerate(stage_sizes):
        if bs >= b:
            continue
        perm = jnp.argsort(done)  # stable: active queries first
        idx = perm[:bs]
        sub = BeamState(buf_d[idx], buf_id[idx], buf_chk[idx])
        sub_ps = (
            pop_state_index(pstate, idx)
            if pop_state_index is not None else pstate
        )
        sub_hook = pop_hook_for(idx) if pop_hook_for is not None else None
        nxt = stage_sizes[si + 1] if si + 1 < len(stage_sizes) else 0
        sst, sh, sdc, sub_ps, sdone, iters = beam_level_scored(
            fetch, score_for(idx), sub, ~done[idx], ef, max_iters, pop_width,
            ef_eff, pop_state=sub_ps, pop_hook=sub_hook,
            stop_active_leq=nxt, return_done=True, iter_start=iters,
            scan_width=scan_width,
        )
        buf_d = buf_d.at[idx].set(sst.buf_d)
        buf_id = buf_id.at[idx].set(sst.buf_id)
        buf_chk = buf_chk.at[idx].set(sst.buf_chk)
        hops = hops.at[idx].add(sh)
        dcomp = dcomp.at[idx].add(sdc)
        if pop_state_update is not None:
            pstate = pop_state_update(pstate, idx, sub_ps)
        done = done.at[idx].set(sdone)
    return BeamState(buf_d, buf_id, buf_chk), hops, dcomp, pstate


def beam_level_staged(
    fetch: Callable,
    vectors: jnp.ndarray,
    q: jnp.ndarray,
    qn: jnp.ndarray,
    state: BeamState,
    active: jnp.ndarray,
    ef: int,
    max_iters: int,
    metric: str,
    precision,
    pop_width: int,
    ef_eff: jnp.ndarray | None,
    stage_sizes: tuple,
    scan_width: int = 0,
):
    """Straggler-compacted beam with exact distances (see
    beam_staged_scored)."""

    def score_for(idx):
        if idx is None:
            return make_exact_scorer(vectors, None, q, qn, metric, precision)
        return make_exact_scorer(
            vectors, None, q[idx], qn[idx], metric, precision
        )

    st, hops, dcomp, _ = beam_staged_scored(
        fetch, score_for, state, active, ef, max_iters, pop_width, ef_eff,
        stage_sizes, scan_width=scan_width,
    )
    return st, hops, dcomp


def beam_level(
    fetch: Callable,
    vectors: jnp.ndarray,
    vn: jnp.ndarray,
    q: jnp.ndarray,
    qn: jnp.ndarray,
    state: BeamState,
    active: jnp.ndarray,
    ef: int,
    max_iters: int,
    metric: str,
    precision,
    pop_width: int = 1,
    ef_eff: jnp.ndarray | None = None,
    allowed: jnp.ndarray | None = None,
    ftrack: FilterTrack | None = None,
    scan_width: int = 0,
) -> BeamState:
    """Beam search with exact distances (the Slim/HNSW path)."""
    score = make_exact_scorer(vectors, vn, q, qn, metric, precision)
    if allowed is not None:
        st, hops, dcomp, _, ftrack = beam_level_scored(
            fetch, score, state, active, ef, max_iters, pop_width, ef_eff,
            allowed=allowed, ftrack=ftrack, scan_width=scan_width,
        )
        return st, hops, dcomp, ftrack
    st, hops, dcomp, _ = beam_level_scored(
        fetch, score, state, active, ef, max_iters, pop_width, ef_eff,
        scan_width=scan_width,
    )
    return st, hops, dcomp


def level_search(
    adjs: tuple,
    entry: jnp.ndarray,
    vectors: jnp.ndarray,
    vn: jnp.ndarray,
    q: jnp.ndarray,
    *,
    max_level: int,
    ef: int,
    k: int,
    max_iters: int,
    metric: str,
    precision,
    pop_width: int = 1,
    allowed: jnp.ndarray | None = None,
):
    """Vanilla HNSW query path (hnswalg.h searchKnn :1378-1440): greedy
    descent max_level..1, beam (ef) at the base layer. `allowed` as in
    chal_search (in-kernel BaseFilterFunctor)."""
    b = q.shape[0]
    qn = distance.sq_norms(q)
    cur = jnp.broadcast_to(entry.astype(jnp.int32), (b,))
    curdist = distance.gathered_dist(
        q, vectors[cur][:, None, :], metric, qn=qn, vn=vn[cur][:, None],
        precision=precision,
    )[:, 0]
    always = jnp.ones((b,), bool)
    for l in range(max_level, 0, -1):
        cur, curdist = greedy_level(
            make_dense_fetch(adjs[l]), vectors, vn, q, qn, cur, curdist,
            always, metric, precision,
        )
    state = beam_init(cur, curdist, ef)
    if allowed is not None:
        seed_ok = allowed[cur]
        ftrack = FilterTrack(
            jnp.full((b, ef), INF).at[:, 0].set(jnp.where(seed_ok, curdist, INF)),
            jnp.full((b, ef), -1, jnp.int32).at[:, 0].set(
                jnp.where(seed_ok, cur, -1)
            ),
        )
        state, hops, dcomp, ftrack = beam_level(
            make_dense_fetch(adjs[0]), vectors, vn, q, qn, state, always, ef,
            max_iters, metric, precision, pop_width,
            allowed=allowed, ftrack=ftrack,
        )
        return ftrack.res_d[:, :k], ftrack.res_id[:, :k], hops, dcomp
    state, hops, dcomp = beam_level(
        make_dense_fetch(adjs[0]), vectors, vn, q, qn, state, always, ef,
        max_iters, metric, precision, pop_width,
    )
    return state.buf_d[:, :k], state.buf_id[:, :k], hops, dcomp


def chal_search(
    graph_nbr: jnp.ndarray,
    graph_lvl_off: jnp.ndarray,
    entry: jnp.ndarray,
    vectors: jnp.ndarray,
    vn: jnp.ndarray,
    q: jnp.ndarray,
    *,
    max_level: int,
    threshold_level: int,
    cap0: int,
    cap: int,
    ef: int,
    k: int,
    max_iters: int,
    metric: str,
    precision,
    pop_width: int = 1,
    ef_eff: jnp.ndarray | None = None,
    dense0: jnp.ndarray | None = None,
    dense_up: tuple | None = None,
    rank_up: jnp.ndarray | None = None,
    allowed: jnp.ndarray | None = None,
    stages: tuple = (),
    scan_width: int = 0,
    seed_width: int = 0,
    up_vecs: jnp.ndarray | None = None,
    up_ids: jnp.ndarray | None = None,
    seed_strata: int = 0,
):
    """Full Slim query path (hnswalg_slim.h searchKnn :2030-2131):
    greedy descent for levels max_level..threshold_level+1, beam search for
    levels threshold_level..1 with a shared buffer, then the base layer.
    `allowed` (bool[N]) enables in-kernel BaseFilterFunctor filtering: the
    traversal visits every node but results come from the allowed-only
    track, which also sets the termination bound (k-guarantee).
    `stages`: straggler-compaction sub-batch sizes for the base-layer beam
    (see beam_level_staged); () = single lockstep loop.
    `seed_width` > 1 (with threshold_level == 0): seed the base layer with
    seed_width entries instead of the single greedy-descent entry —
    multi-seed diversity against cluster-local minima (measured +0.32
    recall@10 at fixed ef=48 on 20k clustered). With `up_vecs`/`up_ids`
    (the vectors and ids of ALL level>=1 nodes, ~N/32 rows) the seeds are
    the EXACT top-seed_width upper nodes from one fused [B, n_up] distance
    matmul — the batched replacement for the whole upper-level descent
    (one matmul, no iterations). Without the table, level 1 runs as a
    seed_width-wide beam (fallback for engines without raw vectors).
    Returns (dists f32[B, k], ids i32[B, k]) sorted ascending."""
    b = q.shape[0]
    qn = distance.sq_norms(q)
    cur = jnp.broadcast_to(entry.astype(jnp.int32), (b,))
    curdist = distance.gathered_dist(
        q, vectors[cur][:, None, :], metric, qn=qn, vn=vn[cur][:, None],
        precision=precision,
    )[:, 0]
    always = jnp.ones((b,), bool)

    def upper_fetch(l):
        # dense upper serving layout (rank indirection) when provided;
        # flat CHAL slices otherwise
        if l > 0 and dense_up is not None and l - 1 < len(dense_up):
            return make_rank_fetch(rank_up, dense_up[l - 1])
        return make_chal_fetch(
            graph_nbr, graph_lvl_off, l, cap if l > 0 else cap0
        )

    hops = jnp.zeros((b,), jnp.int32)
    dcomp = jnp.zeros((b,), jnp.int32)
    seed_state = None
    seed_width = min(seed_width, ef)
    use_seed = seed_width > 1 and threshold_level == 0 and max_level >= 1
    if use_seed and up_vecs is not None:
        # exact top-S upper seeds from ONE fused distance matmul over all
        # level>=1 nodes (~N/32 rows) — replaces every upper level
        dmat = distance.pairwise_dist(
            q, up_vecs, metric, qn=qn, precision=precision
        )
        dmat = jnp.where((up_ids >= 0)[None, :], dmat, INF)  # row padding
        if seed_strata > 1:
            # stratified selection: top-(seed_width/strata) upper nodes PER
            # stratum (= per shard segment of the up table) — a union of
            # disconnected shard graphs is only reachable through seeds, so
            # every shard must get some (parallel/flat_union.py; global
            # top-k concentrates in the query's nearest shards and strands
            # the rest)
            u = up_ids.shape[0] // seed_strata
            sps = max(1, seed_width // seed_strata)
            seed_width = sps * seed_strata
            # top-sps per stratum via sps fused argmin/min passes, NOT
            # lax.top_k: top_k lowers to a full stable sort whose f32+s32
            # temps are 2x the dmat bytes — 8 GB extra device memory at 16M
            # (b=1024 x 16 strata x 65536 padded upper rows). sps is tiny
            # (seed_width/strata, 2 at 16M), so k max-reduce passes fuse
            # into the where-chain and materialize nothing beyond dmat.
            d3 = dmat.reshape(b, seed_strata, u)
            iot_u = jnp.arange(u, dtype=jnp.int32)
            sds, poss = [], []
            for _ in range(sps):
                am = jnp.argmin(d3, axis=2)  # [b, strata]
                sds.append(jnp.min(d3, axis=2))
                poss.append(am)
                d3 = jnp.where(
                    iot_u[None, None, :] == am[:, :, None], INF, d3
                )
            sd = jnp.stack(sds, axis=2).reshape(b, seed_width)
            pos = jnp.stack(poss, axis=2)  # [b, strata, sps]
            flat_pos = (
                pos + (jnp.arange(seed_strata, dtype=jnp.int32) * u)[
                    None, :, None]
            ).reshape(b, seed_width)
            si = up_ids[flat_pos]
            sd, si = lax.sort((sd, si), dimension=1, num_keys=1)
        else:
            negd, pos = lax.top_k(-dmat, seed_width)
            sd = -negd
            si = up_ids[pos]
        si = jnp.where(jnp.isinf(sd), -1, si)
        dcomp += jnp.sum((up_ids >= 0).astype(jnp.int32))
        seed_state = BeamState(sd, si, jnp.zeros_like(si))
    else:
        for l in range(max_level, threshold_level, -1):
            fetch = upper_fetch(l)
            if l == 1 and use_seed:
                st1 = beam_init(cur, curdist, seed_width)
                st1, h, dc = beam_level(
                    fetch, vectors, vn, q, qn, st1, always,
                    seed_width, max_iters, metric, precision,
                    pop_width=min(4, seed_width),
                )
                hops += h
                dcomp += dc
                seed_state = st1
                break
            cur, curdist = greedy_level(
                fetch, vectors, vn, q, qn, cur, curdist, always, metric,
                precision,
            )

    if seed_state is not None:
        pad = ef - seed_width
        state = BeamState(
            jnp.concatenate(
                [seed_state.buf_d, jnp.full((b, pad), INF)], axis=1
            ),
            jnp.concatenate(
                [seed_state.buf_id, jnp.full((b, pad), -1, jnp.int32)],
                axis=1,
            ),
            jnp.zeros((b, ef), jnp.int32),
        )
        # the allowed-track seed below keys off (cur, curdist); keep them
        # coherent with the best seed
        cur = seed_state.buf_id[:, 0]
        curdist = seed_state.buf_d[:, 0]
    else:
        state = beam_init(cur, curdist, ef)
    ftrack = None
    if allowed is not None:
        # seed the allowed-only track with the beam seed (the reference adds
        # the entry point to top_candidates when allowed)
        seed_ok = allowed[cur]
        ftrack = FilterTrack(
            jnp.full((b, ef), INF).at[:, 0].set(jnp.where(seed_ok, curdist, INF)),
            jnp.full((b, ef), -1, jnp.int32).at[:, 0].set(
                jnp.where(seed_ok, cur, -1)
            ),
        )
    for l in range(min(threshold_level, max_level), -1, -1):
        if l == 0 and dense0 is not None:
            # dense serving layout: one 240-byte row transaction per pop
            # instead of W scalar gathers from the flat CHAL array
            fetch = make_dense_fetch(dense0)
        else:
            fetch = upper_fetch(l)
        if allowed is not None:
            state, h, dc, ftrack = beam_level(
                fetch, vectors, vn, q, qn, state, always, ef, max_iters,
                metric, precision, pop_width, ef_eff,
                allowed=allowed, ftrack=ftrack,
            )
        elif l == 0 and stages:
            state, h, dc = beam_level_staged(
                fetch, vectors, q, qn, state, always, ef, max_iters,
                metric, precision, pop_width, ef_eff, stages,
                scan_width=scan_width,
            )
        else:
            state, h, dc = beam_level(
                fetch, vectors, vn, q, qn, state, always, ef, max_iters,
                metric, precision, pop_width, ef_eff,
                scan_width=scan_width,
            )
        hops += h
        dcomp += dc
        if l > 0:  # reset checked bits: next level re-expands the survivors
            state = BeamState(state.buf_d, state.buf_id, jnp.zeros_like(state.buf_chk))

    if allowed is not None:
        return ftrack.res_d[:, :k], ftrack.res_id[:, :k], hops, dcomp
    return state.buf_d[:, :k], state.buf_id[:, :k], hops, dcomp
