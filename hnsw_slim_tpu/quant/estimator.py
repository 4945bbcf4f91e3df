"""Distance estimation from RaBitQ codes — matmul instead of popcount.

The reference estimates <q, x_u> by AND+popcount over 4-bit query planes
(estimator.hpp:164-188 via warmup_space.hpp:8-60) because AVX popcount is the
fastest CPU path. On the device the same quantity is one fused unpack +
dot, using the EXACT rotated query (the reference's 4-bit query
quantization exists only to enable popcount; mask_ip_x0_q in
split_single_fulldist :133-159 is the exact-query variant we match).

    est = f_add + g_add + f_rescale * (<q_rot, bits> + c1 * sum(q_rot))
    low = est - f_error * g_error                      (:180-188)

with c1 = -1/2, g_add = ||q - centroid||² (L2) or -<q, centroid> (IP),
g_error = ||q - centroid|| (query.hpp:100-107).
"""

from __future__ import annotations

import jax.numpy as jnp


def unpack_bits(codes: jnp.ndarray) -> jnp.ndarray:
    """u32[..., W] -> f32[..., W*32] of {0, 1} (little-endian bit order)."""
    shifts = jnp.arange(32, dtype=jnp.uint32)
    bits = (codes[..., None] >> shifts) & jnp.uint32(1)
    return bits.reshape(*codes.shape[:-1], codes.shape[-1] * 32).astype(
        jnp.float32
    )


def bin_ip(q_rot: jnp.ndarray, bin_code: jnp.ndarray) -> jnp.ndarray:
    """<q_rot, x_u> for per-query candidate codes.

    q_rot f32[B, P], bin_code u32[B, W, P/32] -> f32[B, W].
    """
    bits = unpack_bits(bin_code)  # [B, W, P]
    return jnp.einsum(
        "bp,bwp->bw", q_rot, bits, preferred_element_type=jnp.float32
    )


def est_dist_1bit(
    q_rot: jnp.ndarray,  # f32[B, P]
    sumq: jnp.ndarray,  # f32[B] = sum(q_rot)
    bin_code: jnp.ndarray,  # u32[B, W, P/32] gathered candidate codes
    f_add: jnp.ndarray,  # f32[B, W]
    f_rescale: jnp.ndarray,  # f32[B, W]
    g_add: jnp.ndarray,  # f32[B, W] per-candidate centroid term
) -> jnp.ndarray:
    """split_single_estdist (estimator.hpp:164-188) with exact query."""
    ip = bin_ip(q_rot, bin_code)
    c1 = jnp.float32(-0.5)
    return f_add + g_add + f_rescale * (ip + c1 * sumq[:, None])


def est_dist_ex(
    q_rot: jnp.ndarray,
    sumq: jnp.ndarray,
    bin_code: jnp.ndarray,  # u32[B, W, P/32]
    ex_planes: jnp.ndarray,  # u32[B, W, ex_bits, P/32]
    f_add_ex: jnp.ndarray,
    f_rescale_ex: jnp.ndarray,
    g_add: jnp.ndarray,
    ex_bits: int,
) -> jnp.ndarray:
    """split_single_fulldist (estimator.hpp:133-159): total code =
    (bin << ex_bits) + ex; est = f_add_ex + g_add + f_rescale_ex *
    (2^ex * <q,bin> + <q,ex> + cb * sumq)."""
    ip_bin = bin_ip(q_rot, bin_code)
    ip_ex = jnp.zeros_like(ip_bin)
    for b in range(ex_bits):
        ip_ex += (2.0**b) * bin_ip(q_rot, ex_planes[:, :, b])
    cb = jnp.float32(-((1 << ex_bits) - 0.5))
    return f_add_ex + g_add + f_rescale_ex * (
        (2.0**ex_bits) * ip_bin + ip_ex + cb * sumq[:, None]
    )


def centroid_g_tables(q_rot, centroids_rot, metric: str = "l2"):
    """Per-(query, cluster) g_add/g_error (hnswalg_slimq.h:1823-1848,
    query.hpp set_g_add :100-107)."""
    if metric == "ip":
        ip = q_rot @ centroids_rot.T
        diff = q_rot[:, None, :] - centroids_rot[None, :, :]
        norm = jnp.sqrt(jnp.sum(diff * diff, axis=-1))
        return -ip, norm
    diff = q_rot[:, None, :] - centroids_rot[None, :, :]
    sq = jnp.sum(diff * diff, axis=-1)
    return sq, jnp.sqrt(sq)
