"""NN-descent kNN-graph construction — the batched device build path.

The reference builds its graph by sequential locked inserts
(hnswalg.h:1248-1376). On an accelerator that shape is wrong: the idiomatic equivalent
(cf. GPU CAGRA / GGNN) is to build an approximate kNN graph with NN-descent —
every round is batched gathers + one fused distance einsum + one multi-operand
sort across ALL nodes at once — then prune it into a navigable HNSW hierarchy
(graph/build.py build_by_nnd).

Ingredients (full NND, not the naive variant):
* random-projection warm start: P random directions, global sorts, each node
  seeded with its sorted-order window neighbors (matmul + sort only);
* new/old flags: 2-hop exploration samples pivots among entries inserted in
  the previous round (uniform resampling of old pairs stalls convergence on
  unstructured data);
* reverse samples via one device-wide edge sort;
* chunked fused distance+sort merges bound the [chunk, C, d] gather.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax

from ..ops import distance

INF = jnp.float32(jnp.inf)


def sorted_run_rank(keys: jnp.ndarray) -> jnp.ndarray:
    """Rank of each element within its run of equal values (keys SORTED
    ascending). Implemented as a binary search for the run start (log(e)
    gathers per element); lax.associative_scan over multi-million-element
    arrays once stalled a backend compiler for over an hour."""
    e = keys.shape[0]
    iota = lax.broadcasted_iota(jnp.int32, (e, 1), 0)[:, 0]
    runstart = jnp.searchsorted(keys, keys, side="left").astype(jnp.int32)
    return iota - runstart


def _chunked_cand_merge(vectors, vn, ids, dists, newf, cand, chunk, metric,
                        precision):
    """Score candidates [N, C] against each node's own vector and merge into
    the sorted top-K state (ids, dists, new flags). Returns
    (ids, dists, newf, n_inserted)."""
    n, k = ids.shape
    n_chunks = n // chunk

    def body(i, carry):
        ids_a, d_a, nf_a, inserted = carry
        s = i * chunk
        idc = lax.dynamic_slice_in_dim(ids_a, s, chunk, 0)
        dc = lax.dynamic_slice_in_dim(d_a, s, chunk, 0)
        nc = lax.dynamic_slice_in_dim(nf_a, s, chunk, 0)
        cc = lax.dynamic_slice_in_dim(cand, s, chunk, 0)
        q = lax.dynamic_slice_in_dim(vectors, s, chunk, 0)
        qn = lax.dynamic_slice_in_dim(vn, s, chunk, 0)

        self_ids = s + lax.broadcasted_iota(jnp.int32, (chunk, 1), 0)
        # dedup: in-candidate duplicates, already-known ids, self
        sc = jnp.sort(jnp.where(cc < 0, jnp.int32(2**30), cc), axis=1)
        dup_in = jnp.concatenate(
            [jnp.zeros((chunk, 1), bool), sc[:, 1:] == sc[:, :-1]], axis=1
        )
        sc = jnp.where(dup_in | (sc == 2**30), -1, sc)
        known = jnp.any(sc[:, :, None] == idc[:, None, :], axis=2)
        valid = (sc >= 0) & ~known & (sc != self_ids)

        safe = jnp.maximum(sc, 0)
        d = distance.gathered_dist(
            q, vectors[safe], metric, qn=qn, vn=vn[safe], precision=precision
        )
        d = jnp.where(valid, d, INF)

        cat_d = jnp.concatenate([dc, d], axis=1)
        cat_i = jnp.concatenate([idc, jnp.where(valid, sc, -1)], axis=1)
        # flag 2 marks fresh candidates so survivors can be counted exactly
        cat_n = jnp.concatenate([nc, jnp.full_like(sc, 2)], axis=1)
        sd, si, sn = lax.sort((cat_d, cat_i, cat_n), dimension=1, num_keys=1)
        sd, si, sn = sd[:, :k], si[:, :k], sn[:, :k]
        inserted += jnp.sum((sn == 2) & (sd < INF)).astype(jnp.int32)
        sn = jnp.where(sn == 2, 1, sn)
        ids_a = lax.dynamic_update_slice_in_dim(ids_a, si, s, 0)
        d_a = lax.dynamic_update_slice_in_dim(d_a, sd, s, 0)
        nf_a = lax.dynamic_update_slice_in_dim(nf_a, sn, s, 0)
        return ids_a, d_a, nf_a, inserted

    return lax.fori_loop(
        0, n_chunks, body, (ids, dists, newf, jnp.int32(0))
    )


@functools.partial(jax.jit, static_argnames=("k", "n_proj", "chunk", "metric"))
def rp_init(key, vectors, vn, n_valid, *, k: int, n_proj: int, chunk: int,
            metric: str):
    """Random-projection warm start: each node's initial candidates are its
    window neighbors in n_proj global sorted orders (+ random fill)."""
    n, d = vectors.shape
    k1, k2 = jax.random.split(key)
    dirs = jax.random.normal(k1, (d, n_proj), jnp.float32)
    proj = (vectors @ dirs).astype(jnp.float32)  # [n, P]

    w = max(2, k // (2 * n_proj))  # window half-width per projection
    offs = jnp.concatenate(
        [jnp.arange(-w, 0), jnp.arange(1, w + 1)]
    ).astype(jnp.int32)
    cands = []
    iota = lax.broadcasted_iota(jnp.int32, (n, 1), 0)[:, 0]
    for p in range(n_proj):
        # push padded rows (>= n_valid) to the end of the order
        keyv = jnp.where(iota < n_valid, proj[:, p], jnp.inf)
        order = jnp.argsort(keyv)  # node ids in sorted order
        rank = jnp.argsort(order)  # node -> position
        pos = jnp.clip(rank[:, None] + offs[None, :], 0, n - 1)
        c = order[pos]
        cands.append(jnp.where(c < n_valid, c, -1))  # windows near the end
        # of the sorted order would otherwise pick padded rows
    rnd = jax.random.randint(k2, (n, max(0, k - 2 * w * n_proj)), 0, n_valid,
                             dtype=jnp.int32)
    cand = jnp.concatenate(cands + [rnd], axis=1)

    init_i = jnp.full((n, k), -1, jnp.int32)
    init_d = jnp.full((n, k), INF)
    init_n = jnp.zeros((n, k), jnp.int32)
    ids, dists, newf, _ = _chunked_cand_merge(
        vectors, vn, init_i, init_d, init_n, cand, chunk, metric,
        jax.lax.Precision.DEFAULT,
    )
    return ids, dists, newf


@functools.partial(jax.jit, static_argnames=("s_fwd", "r_rev"))
def _nnd_candidates(
    key,
    ids: jnp.ndarray,
    newf: jnp.ndarray,
    n_valid: jnp.ndarray,
    *,
    s_fwd: int,
    r_rev: int,
):
    """Candidate generation (forward 2-hop, reverse, local join) as its own
    compiled program — separated from the merge so each piece caches
    independently and compiles in bounded time."""
    n, k = ids.shape
    k1, k2, k3 = jax.random.split(key, 3)

    rand_key = jax.random.uniform(k1, (n, k))
    pivot_score = jnp.where(newf == 1, rand_key, rand_key + 2.0)
    pivot_score = jnp.where(ids >= 0, pivot_score, jnp.inf)
    piv = jnp.argsort(pivot_score, axis=1)[:, :s_fwd]
    mid = jnp.take_along_axis(ids, piv, axis=1)
    r2 = jax.random.randint(k2, (n, s_fwd), 0, k)
    flat = ids.reshape(-1)
    fwd = jnp.where(mid >= 0, flat[jnp.maximum(mid, 0) * k + r2], -1)

    cleared = jnp.zeros_like(newf).at[
        lax.broadcasted_iota(jnp.int32, (n, s_fwd), 0), piv
    ].set(1)
    newf = jnp.where(cleared == 1, 0, newf)

    tgt = ids.reshape(-1)
    src = jnp.repeat(
        lax.broadcasted_iota(jnp.int32, (n, 1), 0), k, axis=1
    ).reshape(-1)
    tgt_s = jnp.where(tgt >= 0, tgt, n)
    st, ss = lax.sort((tgt_s, src), dimension=0, num_keys=1)
    rank = sorted_run_rank(st)
    keep = (rank < r_rev) & (st < n) & (ss < n_valid)
    rev = jnp.full((n + 1, r_rev), -1, jnp.int32)
    rev = rev.at[jnp.where(keep, st, n), jnp.where(keep, rank, 0)].set(
        jnp.where(keep, ss, -1)
    )[:n]

    k4, k5 = jax.random.split(k3)
    r3 = jax.random.randint(k4, (n, s_fwd), 0, r_rev)
    jrev = jnp.take_along_axis(rev, r3, axis=1)
    r4 = jax.random.randint(k5, (n, s_fwd), 0, k)
    join = jnp.where(jrev >= 0, flat[jnp.maximum(jrev, 0) * k + r4], -1)

    return jnp.concatenate([fwd, rev, join], axis=1), newf


@functools.partial(jax.jit, static_argnames=("chunk", "metric"))
def _nnd_merge(ids, dists, newf, vectors, vn, cand, *, chunk, metric):
    return _chunked_cand_merge(
        vectors, vn, ids, dists, newf, cand, chunk, metric,
        jax.lax.Precision.DEFAULT,
    )


def nnd_round_split(
    key, ids, dists, newf, vectors, vn, n_valid, *, s_fwd, r_rev, chunk, metric
):
    """Two-program variant of nnd_round (candidates | merge)."""
    cand, newf = _nnd_candidates(
        key, ids, newf, n_valid, s_fwd=s_fwd, r_rev=r_rev
    )
    ids, dists, newf, inserted = _nnd_merge(
        ids, dists, newf, vectors, vn, cand, chunk=chunk, metric=metric
    )
    return ids, dists, newf, inserted


@functools.partial(
    jax.jit, static_argnames=("s_fwd", "r_rev", "chunk", "metric")
)
def nnd_round(
    key,
    ids: jnp.ndarray,  # i32[N, K] sorted by dist
    dists: jnp.ndarray,  # f32[N, K]
    newf: jnp.ndarray,  # i32[N, K] 1 = inserted last round
    vectors: jnp.ndarray,
    vn: jnp.ndarray,
    n_valid: jnp.ndarray,  # real node count (rows >= n_valid are padding)
    *,
    s_fwd: int,
    r_rev: int,
    chunk: int,
    metric: str,
):
    n, k = ids.shape
    k1, k2, k3 = jax.random.split(key, 3)

    # forward: 2-hop samples with the first hop biased to NEW entries —
    # pick s_fwd pivot positions by sorting (is_old, random) per row
    rand_key = jax.random.uniform(k1, (n, k))
    pivot_score = jnp.where(newf == 1, rand_key, rand_key + 2.0)
    pivot_score = jnp.where(ids >= 0, pivot_score, jnp.inf)
    piv = jnp.argsort(pivot_score, axis=1)[:, :s_fwd]  # positions, new first
    mid = jnp.take_along_axis(ids, piv, axis=1)  # [n, s]
    r2 = jax.random.randint(k2, (n, s_fwd), 0, k)
    flat = ids.reshape(-1)
    fwd = jnp.where(mid >= 0, flat[jnp.maximum(mid, 0) * k + r2], -1)

    # the sampled pivots have now been explored: clear their new flag
    cleared = jnp.zeros_like(newf).at[
        lax.broadcasted_iota(jnp.int32, (n, s_fwd), 0), piv
    ].set(1)
    newf = jnp.where(cleared == 1, 0, newf)

    # reverse: one global sort of all (target, source) edges, keep first
    # r_rev sources per target
    tgt = ids.reshape(-1)
    src = jnp.repeat(
        lax.broadcasted_iota(jnp.int32, (n, 1), 0), k, axis=1
    ).reshape(-1)
    tgt_s = jnp.where(tgt >= 0, tgt, n)
    st, ss = lax.sort((tgt_s, src), dimension=0, num_keys=1)
    rank = sorted_run_rank(st)
    keep = (rank < r_rev) & (st < n) & (ss < n_valid)  # padded rows never leak
    rev = jnp.full((n + 1, r_rev), -1, jnp.int32)
    rev = rev.at[jnp.where(keep, st, n), jnp.where(keep, rank, 0)].set(
        jnp.where(keep, ss, -1)
    )[:n]

    # local join (rev-then-fwd 2-hop): neighbors of nodes that list me —
    # the pair-proposal term of full NN-descent; without it convergence
    # stalls on unstructured data
    k4, k5 = jax.random.split(k3)
    r3 = jax.random.randint(k4, (n, s_fwd), 0, r_rev)
    jrev = jnp.take_along_axis(rev, r3, axis=1)  # [n, s]
    r4 = jax.random.randint(k5, (n, s_fwd), 0, k)
    join = jnp.where(jrev >= 0, flat[jnp.maximum(jrev, 0) * k + r4], -1)

    cand = jnp.concatenate([fwd, rev, join], axis=1)
    ids, dists, newf, inserted = _chunked_cand_merge(
        vectors, vn, ids, dists, newf, cand, chunk, metric,
        jax.lax.Precision.DEFAULT,
    )
    return ids, dists, newf, inserted


def nn_descent(
    vectors: jnp.ndarray,
    vn: jnp.ndarray,
    k: int = 64,
    rounds: int = 30,
    s_fwd: int | None = None,
    r_rev: int | None = None,
    chunk: int = 8192,
    metric: str = "l2",
    seed: int = 0,
    min_change_frac: float = 0.002,
    verbose: bool = False,
):
    """Approximate kNN graph: (ids i32[N, K], dists f32[N, K]) sorted asc.

    N is padded internally to a multiple of `chunk`; padded rows are
    self-contained junk and are dropped before returning.
    """
    n = vectors.shape[0]
    npad = -(-n // chunk) * chunk
    if npad != n:
        pad = jnp.broadcast_to(vectors[:1], (npad - n, vectors.shape[1]))
        vectors = jnp.concatenate([vectors, pad])
        vn = jnp.concatenate([vn, jnp.broadcast_to(vn[:1], (npad - n,))])
    s_fwd = s_fwd or k
    r_rev = r_rev or k // 2
    key = jax.random.PRNGKey(seed)
    nv = jnp.int32(n)
    ids, dists, newf = rp_init(
        key, vectors, vn, nv, k=k, n_proj=4, chunk=chunk, metric=metric
    )
    for r in range(rounds):
        key, sub = jax.random.split(key)
        ids, dists, newf, inserted = nnd_round_split(
            sub, ids, dists, newf, vectors, vn, nv,
            s_fwd=s_fwd, r_rev=r_rev, chunk=chunk, metric=metric,
        )
        c = int(inserted)
        if verbose:
            print(f"  nnd round {r}: {c} insertions")
        if c < min_change_frac * n * k:
            break
    return ids[:n], dists[:n]
