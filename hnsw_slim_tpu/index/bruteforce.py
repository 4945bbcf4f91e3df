"""Exact k-NN by full distance matmul + top-k.

Replacement for the reference's BruteforceSearch (bruteforce.h) and the
BruteForce ground-truth strategy (brute_force_strategy.h:7-51): one distance
matmul per (query-block, base-chunk) at Precision.HIGHEST (full fp32, no
TF32 on the GPU) with a running top-k merge, instead of a per-pair heap
loop.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import distance


@functools.partial(jax.jit, static_argnames=("k", "metric", "chunk"))
def _bf_topk(q, x, xn, n_valid, k: int, metric: str, chunk: int):
    n = x.shape[0]
    nchunks = n // chunk  # x is pre-padded to a multiple of chunk
    qn = distance.sq_norms(q)

    def body(c, state):
        best_d, best_i = state
        xs = jax.lax.dynamic_slice_in_dim(x, c * chunk, chunk, axis=0)
        xns = jax.lax.dynamic_slice_in_dim(xn, c * chunk, chunk, axis=0)
        d = distance.pairwise_dist(q, xs, metric, qn=qn, xn=xns)
        ids = c * chunk + jax.lax.broadcasted_iota(jnp.int32, d.shape, 1)
        d = jnp.where(ids < n_valid, d, jnp.inf)  # mask padded rows
        cat_d = jnp.concatenate([best_d, d], axis=1)
        cat_i = jnp.concatenate([best_i, ids], axis=1)
        neg_top, arg = jax.lax.top_k(-cat_d, k)
        return -neg_top, jnp.take_along_axis(cat_i, arg, axis=1)

    init = (
        jnp.full((q.shape[0], k), jnp.inf, jnp.float32),
        jnp.full((q.shape[0], k), -1, jnp.int32),
    )
    return jax.lax.fori_loop(0, nchunks, body, init)


class BruteForceIndex:
    """Exact search over a flat vector array (reference bruteforce.h)."""

    def __init__(self, vectors: np.ndarray, metric: str = "l2", chunk: int = 65536):
        self.metric = metric
        n, self.dim = vectors.shape
        self.n = n
        self.chunk = min(chunk, _round_up(n, 1024))
        npad = _round_up(n, self.chunk)
        padded = np.zeros((npad, self.dim), np.float32)
        padded[:n] = vectors  # padded rows are masked by index in _bf_topk
        self.x = jnp.asarray(padded)
        self.xn = distance.sq_norms(self.x)

    def search(self, queries: np.ndarray, k: int, batch: int = 8192):
        """(dists f32[B,k], ids i32[B,k]) exact top-k."""
        q = np.asarray(queries, np.float32)
        if q.shape[0] == 0:
            return np.zeros((0, k), np.float32), np.zeros((0, k), np.int32)
        outs_d, outs_i = [], []
        for s in range(0, q.shape[0], batch):
            d, i = _bf_topk(
                jnp.asarray(q[s : s + batch]),
                self.x,
                self.xn,
                self.n,
                k,
                self.metric,
                self.chunk,
            )
            outs_d.append(np.asarray(d))
            outs_i.append(np.asarray(i))
        return np.concatenate(outs_d), np.concatenate(outs_i)


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


@functools.partial(jax.jit, static_argnames=("k", "metric", "chunk", "n_valid"))
def exact_topk(x, xn, q, k: int, metric: str = "l2", chunk: int = 131072,
               n_valid: int = 0):
    """Exact top-k against an ALREADY-ON-DEVICE vector table (no H2D copy,
    unlike BruteForceIndex which owns a padded device copy). Full chunks run
    in a fori_loop; the remainder is one static-shape tail pass. n_valid > 0
    masks trailing padded rows (node-padded serving graphs carry level -1
    padding whose zero vectors must not enter the result).
    Returns (dists f32[B, k], ids i32[B, k])."""
    n = x.shape[0]
    nv = n_valid or n
    chunk = min(chunk, n)
    qn = distance.sq_norms(q)

    def merge(state, d, ids):
        best_d, best_i = state
        d = jnp.where(ids < nv, d, jnp.inf)
        cat_d = jnp.concatenate([best_d, d], axis=1)
        cat_i = jnp.concatenate([best_i, ids], axis=1)
        neg_top, arg = jax.lax.top_k(-cat_d, k)
        return -neg_top, jnp.take_along_axis(cat_i, arg, axis=1)

    def body(c, state):
        xs = jax.lax.dynamic_slice_in_dim(x, c * chunk, chunk, axis=0)
        xns = jax.lax.dynamic_slice_in_dim(xn, c * chunk, chunk, axis=0)
        d = distance.pairwise_dist(q, xs, metric, qn=qn, xn=xns)
        ids = c * chunk + jax.lax.broadcasted_iota(jnp.int32, d.shape, 1)
        return merge(state, d, ids)

    init = (
        jnp.full((q.shape[0], k), jnp.inf, jnp.float32),
        jnp.full((q.shape[0], k), -1, jnp.int32),
    )
    out = jax.lax.fori_loop(0, n // chunk, body, init)
    if n % chunk:
        tail = x[(n // chunk) * chunk:]
        d = distance.pairwise_dist(
            q, tail, metric, qn=qn, xn=xn[(n // chunk) * chunk:]
        )
        ids = (n // chunk) * chunk + jax.lax.broadcasted_iota(
            jnp.int32, d.shape, 1
        )
        out = merge(out, d, ids)
    return out
