"""RaBitQ quantization: 1-bit sign codes + ex-bit codes, with estimation factors.

Port of rabitqlib's quantize_split_single stack (reference
quantization/rabitq.hpp:249-266, rabitq_impl.hpp:76-137 one_bit_code_with_factor,
:435-497 ex_bits_code_with_factor, :336-361 quantize_ex, :276-333
best_rescale_factor, :297-321 get_const_scaling_factors). Everything is
vectorized over the batch: signs = (residual > 0), factors = norms and dots
(batched jnp), ex codes via the sampled constant rescale factor
(faster_config, rabitq.hpp:27-34).

Codes are stored as uint32 bit-planes: bin_code u32[N, P/32], ex planes
u32[N, ex_bits, P/32] — the same bits/dim as the reference's packed layout,
shaped for device-side unpack + matmul estimation.
"""

from __future__ import annotations

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np

K_CONST_EPSILON = 1.9  # rabitq_impl.hpp:18
K_TIGHT_START = [0.0, 0.15, 0.20, 0.52, 0.59, 0.71, 0.75, 0.77, 0.81]  # :260-273


def best_rescale_factor(o_abs: np.ndarray, ex_bits: int) -> float:
    """Event-sweep maximization of <o, o_bar>/|o_bar| (rabitq_impl.hpp:276-333),
    vectorized with numpy (used only to sample the constant factor)."""
    k_eps = 1e-5
    n_enum = 10
    dim = len(o_abs)
    max_o = float(o_abs.max())
    t_end = (((1 << ex_bits) - 1) + n_enum) / max_o
    t_start = t_end * K_TIGHT_START[ex_bits]

    cur = (t_start * o_abs + k_eps).astype(np.int64)
    sqr_den = dim * 0.25 + float((cur * cur + cur).sum())
    num = float(((cur + 0.5) * o_abs).sum())

    # events: coordinate i crosses integer level j at t = j / o_abs[i]
    levels = np.arange(1, (1 << ex_bits)) if ex_bits > 0 else np.array([], np.int64)
    with np.errstate(divide="ignore"):
        times = levels[None, :] / o_abs[:, None]  # [dim, L]
    o_rep = np.repeat(o_abs, len(levels))
    lev_rep = np.tile(levels, dim)
    t_flat = times.reshape(-1)
    mask = (t_flat > (cur.repeat(len(levels)) / np.maximum(o_rep, 1e-30))) & (
        t_flat < t_end
    ) & (lev_rep > cur.repeat(len(levels)))
    order = np.argsort(t_flat[mask])
    ts = t_flat[mask][order]
    os = o_rep[mask][order]
    ls = lev_rep[mask][order]

    # cumulative updates: each event increments one coordinate's level
    sqr_den_c = sqr_den + np.cumsum(2 * ls)
    num_c = num + np.cumsum(os)
    ips = num_c / np.sqrt(sqr_den_c)
    if len(ips) == 0:
        return t_start
    best = int(np.argmax(ips))
    return float(ts[best])


@functools.lru_cache(maxsize=32)
def const_scaling_factor(padded_dim: int, ex_bits: int, n_samples: int = 100) -> float:
    """get_const_scaling_factors (rabitq_impl.hpp:297-321)."""
    if ex_bits == 0:
        return 1.0
    rng = np.random.default_rng(0)
    x = rng.standard_normal((n_samples, padded_dim))
    x = np.abs(x / np.linalg.norm(x, axis=1, keepdims=True))
    return float(np.mean([best_rescale_factor(r, ex_bits) for r in x]))


@dataclasses.dataclass
class QuantizedCodes:
    """Struct-of-arrays payload (replaces BinDataMap/ExDataMap byte layouts,
    reference quantization/data_layout.hpp:9-194)."""

    bin_code: jnp.ndarray  # u32[N, P/32]
    f_add: jnp.ndarray  # f32[N]
    f_rescale: jnp.ndarray  # f32[N]
    f_error: jnp.ndarray  # f32[N]
    ex_planes: jnp.ndarray  # u32[N, ex_bits, P/32] (ex_bits may be 0)
    f_add_ex: jnp.ndarray  # f32[N]
    f_rescale_ex: jnp.ndarray  # f32[N]
    f_error_ex: jnp.ndarray  # f32[N]
    ex_bits: int

    def bytes(self) -> int:
        per = lambda a: a.size * a.dtype.itemsize
        return int(
            per(self.bin_code) + per(self.ex_planes)
            + 6 * 4 * self.bin_code.shape[0]
        )


def _pack_bits(bits: np.ndarray) -> np.ndarray:
    """bool[N, P] -> u32[N, P/32] little-endian bit order."""
    n, p = bits.shape
    by = np.packbits(bits.astype(np.uint8), axis=1, bitorder="little")
    return by.reshape(n, p // 32, 4).view(np.uint32)[:, :, 0]


def quantize_batch(
    rotated: np.ndarray,  # f32[N, P] rotated data
    centroids_rot: np.ndarray,  # f32[C, P] rotated centroids
    cluster_ids: np.ndarray,  # i32[N]
    ex_bits: int,
    metric: str = "l2",
) -> QuantizedCodes:
    """quantize_split_single over a batch (rabitq.hpp:249-266)."""
    x = np.asarray(rotated, np.float64)
    c = np.asarray(centroids_rot, np.float64)[cluster_ids]
    n, p = x.shape
    res = x - c

    # ---- 1-bit code + factors (one_bit_code_with_factor :76-137) ----
    bits = res > 0
    xu_cb = bits.astype(np.float64) - 0.5  # cb = -(2^1-1)/2
    l2_sqr = (res * res).sum(1)
    l2_norm = np.sqrt(l2_sqr)
    ip_resi = (res * xu_cb).sum(1)
    ip_cent = (c * xu_cb).sum(1)
    ip_resi = np.where(ip_resi == 0, np.inf, ip_resi)
    with np.errstate(invalid="ignore"):
        tmp_err = l2_norm * K_CONST_EPSILON * np.sqrt(
            np.maximum(
                (l2_sqr * (xu_cb * xu_cb).sum(1)) / (ip_resi * ip_resi) - 1, 0
            ) / (p - 1)
        )
    if metric == "l2":
        f_add = l2_sqr + 2 * l2_sqr * ip_cent / ip_resi
        f_rescale = -2 * l2_sqr / ip_resi
        f_error = 2 * tmp_err
    else:  # ip (rabitq_impl.hpp:128-132)
        f_add = 1 - (res * c).sum(1) + l2_sqr * ip_cent / ip_resi
        f_rescale = -l2_sqr / ip_resi
        f_error = tmp_err

    # ---- ex-bit code + factors (ex_bits_code_with_factor :435-497) ----
    if ex_bits > 0:
        t_const = const_scaling_factor(p, ex_bits)
        norm_res = np.linalg.norm(res, axis=1, keepdims=True)
        o_abs = np.abs(res / np.where(norm_res == 0, 1, norm_res))
        code = (t_const * o_abs + 1e-5).astype(np.int64)
        code = np.minimum(code, (1 << ex_bits) - 1)
        ipnorm = ((code + 0.5) * o_abs).sum(1)
        ipnorm_inv = np.where(ipnorm > 0, 1.0 / ipnorm, 1.0)
        # revert codes for negative dims (:424-430)
        mask = (1 << ex_bits) - 1
        code = np.where(res < 0, (~code) & mask, code)

        total_code = code + (bits.astype(np.int64) << ex_bits)
        cb = -((1 << ex_bits) - 0.5)
        xu_cb_ex = total_code + cb
        ip_resi_ex = (res * xu_cb_ex).sum(1)
        ip_cent_ex = (c * xu_cb_ex).sum(1)
        ip_resi_ex = np.where(ip_resi_ex == 0, np.inf, ip_resi_ex)
        with np.errstate(invalid="ignore"):
            tmp_err_ex = l2_norm * K_CONST_EPSILON * np.sqrt(
                np.maximum(
                    (l2_sqr * (xu_cb_ex * xu_cb_ex).sum(1))
                    / (ip_resi_ex * ip_resi_ex) - 1, 0
                ) / (p - 1)
            )
        if metric == "l2":
            f_add_ex = l2_sqr + 2 * l2_sqr * ip_cent_ex / ip_resi_ex
            f_rescale_ex = ipnorm_inv * -2 * l2_norm
            f_error_ex = 2 * tmp_err_ex
        else:
            f_add_ex = 1 - (res * c).sum(1) + l2_sqr * ip_cent_ex / ip_resi_ex
            f_rescale_ex = ipnorm_inv * -l2_norm
            f_error_ex = tmp_err_ex
        planes = np.stack(
            [_pack_bits((code >> b) & 1 > 0) for b in range(ex_bits)], axis=1
        )
    else:
        f_add_ex = f_add
        f_rescale_ex = f_rescale
        f_error_ex = f_error
        planes = np.zeros((n, 0, p // 32), np.uint32)

    return QuantizedCodes(
        bin_code=jnp.asarray(_pack_bits(bits)),
        f_add=jnp.asarray(f_add.astype(np.float32)),
        f_rescale=jnp.asarray(f_rescale.astype(np.float32)),
        f_error=jnp.asarray(f_error.astype(np.float32)),
        ex_planes=jnp.asarray(planes),
        f_add_ex=jnp.asarray(f_add_ex.astype(np.float32)),
        f_rescale_ex=jnp.asarray(f_rescale_ex.astype(np.float32)),
        f_error_ex=jnp.asarray(f_error_ex.astype(np.float32)),
        ex_bits=ex_bits,
    )
