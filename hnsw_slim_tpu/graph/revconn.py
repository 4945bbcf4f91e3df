"""Fused device-side insert apply: forward prune + scatter + reverse append
+ overflow re-prune in ONE compiled program per (batch, level).

Reference semantics: mutuallyConnectNewElement (hnswalg.h:549-687) — each
inserted node p connects forward to its pruned candidate set, and every
forward edge p->u appends a reverse edge u->p, heuristic-re-pruning u's row
when it exceeds the level cap.

The previous implementation planned reverse edges on the HOST: sel D2H,
numpy sort/unique, fit cols/vals H2D (~9 MB/batch), 8-12 dispatch+sync
pairs per batch. Here the edge list is derived on device from the pruned
rows and applied with a sort + run-rank + flat unique-index scatter, so one
batch costs ONE dispatch and ZERO host round-trips.

Deviations from the host path (both quality-neutral approximations the
batched build already makes):
* reverse edges of one target arrive sorted by inserter id, not arrival
  order (ties in the overflow prune may resolve differently);
* per batch, at most OF_T unique targets overflow-re-prune and each keeps
  its first NEW_W new edges; the per-batch overflow count is returned so
  the builder can report truncation (observed 0 at 1M: overflow edges per
  batch ~2-6k << the 3*P*M/8 lane budget).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax

from .heuristic import _prune_batch_impl

BIG = jnp.int32(2**30)
HIGHEST = jax.lax.Precision.HIGHEST


@functools.partial(
    jax.jit,
    donate_argnums=(0, 1),
    static_argnames=("M", "cap", "metric", "of_t", "new_w"),
)
def apply_insert(
    adj: jnp.ndarray,   # i32[N, cap] level adjacency (donated)
    deg: jnp.ndarray,   # i32[N] row degrees (donated)
    vecs: jnp.ndarray,
    vn: jnp.ndarray,
    a_ids: jnp.ndarray,  # i32[P] inserted node ids, dup-padded
    cand: jnp.ndarray,   # i32[P, C] search candidates, -1 padded
    n_valid: jnp.ndarray,  # i32 scalar: rows >= n_valid are padding
    *,
    M: int,        # forward-prune budget (cfg.M)
    cap: int,      # level cap (maxM0 / maxM) == adj.shape[1]
    metric: str,
    of_t: int,     # overflow re-prune width (unique targets per batch)
    new_w: int,    # new edges kept per overflow target
):
    """Returns (adj, deg, of_edges, of_targets): per-batch overflow edge
    count and how many unique targets overflowed (monitoring only — both
    device scalars, fetched lazily at end of build)."""
    p_rows, _ = cand.shape
    riota = jnp.arange(p_rows, dtype=jnp.int32)
    rows_valid = riota < n_valid
    # padding rows mirror the last valid row so their writes are identical
    safe_row = jnp.minimum(riota, n_valid - 1)
    a_ids = a_ids[safe_row]
    cand = cand[safe_row]

    # 1. forward prune (getNeighborsByHeuristic2 with the under-M early-out;
    # forward rows carry <= M edges as in mutuallyConnectNewElement)
    sel, cnt = _prune_batch_impl(
        vecs, vn, a_ids, cand, cand >= 0, M, True, metric, M, HIGHEST,
        None,
    )
    # 2. forward scatter — duplicate padding rows write identical content
    sel_full = jnp.pad(
        sel, ((0, 0), (0, cap - sel.shape[1])), constant_values=-1
    )
    adj = adj.at[a_ids].set(sel_full)
    deg = deg.at[a_ids].set(cnt)

    # 3. reverse edge list (u = target, p = inserter), sorted by target
    selw = sel.shape[1]
    u = jnp.where(rows_valid[:, None] & (sel >= 0), sel, BIG).reshape(-1)
    p = jnp.broadcast_to(a_ids[:, None], (p_rows, selw)).reshape(-1)
    us, ps = lax.sort((u, p), dimension=0, num_keys=1)
    e = us.shape[0]
    eiota = jnp.arange(e, dtype=jnp.int32)
    rank = eiota - jnp.searchsorted(us, us, side="left").astype(jnp.int32)
    safe_u = jnp.where(us < BIG, us, 0)
    col = deg[safe_u] + rank
    ok = (us < BIG) & (col < cap)

    # 4. fitting appends: one flat scatter, masked lanes out-of-bounds
    flat = adj.reshape(-1)
    idx = jnp.where(ok, safe_u * cap + col, adj.size + eiota)
    flat = flat.at[idx].set(ps, mode="drop", unique_indices=True)
    adj = flat.reshape(adj.shape)
    deg = deg.at[jnp.where(ok, safe_u, BIG)].add(1, mode="drop")

    # 5. overflow targets: re-prune {row ∪ new} down to cap
    # (shrink path of mutuallyConnectNewElement, hnswalg.h:618-687)
    ovf = (us < BIG) & (col >= cap)
    of_edges = jnp.sum(ovf.astype(jnp.int32))
    okey = jnp.where(ovf, us, BIG)
    of_u, of_p = lax.sort((okey, ps), dimension=0, num_keys=1)
    ovalid = of_u < BIG
    first = jnp.concatenate(
        [ovalid[:1], (of_u[1:] != of_u[:-1]) & ovalid[1:]]
    )
    of_targets = jnp.sum(first.astype(jnp.int32))
    of_t = min(of_t, e)  # small batches have fewer edges than the width
    ut = lax.sort(jnp.where(first, of_u, BIG), dimension=0)[:of_t]
    tvalid = ut < BIG
    safe_t = jnp.where(tvalid, ut, 0)
    start = jnp.searchsorted(of_u, safe_t, side="left").astype(jnp.int32)
    tcnt = (
        jnp.searchsorted(of_u, safe_t, side="right").astype(jnp.int32)
        - start
    )
    cur = adj[safe_t]  # includes this batch's appends: same candidate union
    j = jax.lax.broadcasted_iota(jnp.int32, (of_t, new_w), 1)
    srcpos = jnp.clip(start[:, None] + j, 0, e - 1)
    newmat = jnp.where(
        (j < jnp.minimum(tcnt, new_w)[:, None]) & tvalid[:, None],
        of_p[srcpos], -1,
    )
    ocand = jnp.concatenate([cur, newmat], axis=1)
    osel, ocnt = _prune_batch_impl(
        vecs, vn, safe_t, ocand, ocand >= 0, cap, False, metric, cap,
        HIGHEST, None,
    )
    wt = jnp.where(tvalid, ut, BIG)
    adj = adj.at[wt].set(osel, mode="drop")
    deg = deg.at[wt].set(ocnt, mode="drop")
    return adj, deg, of_edges, of_targets
