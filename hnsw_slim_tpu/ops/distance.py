"""Distance kernels as batched matmuls.

The reference dispatches per-pair scalar SIMD kernels (space_l2.h:6-324,
space_ip.h:6-400). Here the same work is one fused matmul per batch:
    L2²(q, x) = ‖q‖² + ‖x‖² − 2 qᵀx
    IPdist(q, x) = 1 − qᵀx          (space_ip.h InnerProductDistance)

All kernels take/return float32 (accumulation) and are jit-friendly.

Precision on the GPU: a float32 matmul at Precision.DEFAULT runs in TF32
(about three decimal digits); Precision.HIGHEST is full fp32. The graph
builds use DEFAULT (graph/build.py, graph/nnd.py, quant/kmeans.py); search
and exact ground truth use HIGHEST (index/slim.py, parallel/sharded.py, and
the defaults below).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

F32 = jnp.float32


@jax.jit
def sq_norms(x: jnp.ndarray) -> jnp.ndarray:
    """‖x‖² per row: f32[N].

    Jitted so the f32 upcast fuses into the reduction: dispatched eagerly,
    ``x.astype(f32)`` materializes a full-size f32 copy — 8.2 GB for a
    16M x 128 bf16 store. Fused, peak extra device memory is O(output) =
    4 bytes/row.
    """
    return jnp.sum(x.astype(F32) * x.astype(F32), axis=-1)


def pairwise_dist(
    q: jnp.ndarray,
    x: jnp.ndarray,
    metric: str = "l2",
    qn: jnp.ndarray | None = None,
    xn: jnp.ndarray | None = None,
    precision: jax.lax.Precision = jax.lax.Precision.HIGHEST,
) -> jnp.ndarray:
    """All-pairs distances f32[B, N] between q[B, d] and x[N, d].

    precision=HIGHEST is full fp32: required for the exact
    brute-force/ground-truth path (TF32, the GPU's DEFAULT for f32
    matmuls, reorders near-ties and breaks exactness); graph traversal may
    relax it for speed.
    """
    dots = jax.lax.dot_general(
        q.astype(F32),
        x.astype(F32),
        dimension_numbers=(((1,), (1,)), ((), ())),
        preferred_element_type=F32,
        precision=precision,
    )
    if metric == "ip":
        return 1.0 - dots
    if qn is None:
        qn = sq_norms(q)
    if xn is None:
        xn = sq_norms(x)
    return qn[:, None] + xn[None, :] - 2.0 * dots


def gathered_dist(
    q: jnp.ndarray,
    vecs: jnp.ndarray,
    metric: str = "l2",
    qn: jnp.ndarray | None = None,
    vn: jnp.ndarray | None = None,
    precision: jax.lax.Precision = jax.lax.Precision.HIGHEST,
) -> jnp.ndarray:
    """Distances f32[B, W] between q[B, d] and per-query gathered rows vecs[B, W, d].

    This is the hot op of graph traversal: each query scores its own neighbor
    slice (reference searchBaseLayerST inner loop, hnswalg_slim.h:320-457).
    """
    dots = jnp.einsum(
        "bd,bwd->bw",
        q.astype(F32),
        vecs.astype(F32),
        preferred_element_type=F32,
        precision=precision,
    )
    if metric == "ip":
        return 1.0 - dots
    if qn is None:
        qn = sq_norms(q)
    if vn is None:
        vn = sq_norms(vecs)
    return qn[:, None] + vn - 2.0 * dots


@functools.partial(jax.jit, static_argnames=("metric",))
def point_dist(a: jnp.ndarray, b: jnp.ndarray, metric: str = "l2") -> jnp.ndarray:
    """Rowwise distance f32[B] between a[B, d] and b[B, d]."""
    a = a.astype(F32)
    b = b.astype(F32)
    if metric == "ip":
        return 1.0 - jnp.sum(a * b, axis=-1)
    diff = a - b
    return jnp.sum(diff * diff, axis=-1)
