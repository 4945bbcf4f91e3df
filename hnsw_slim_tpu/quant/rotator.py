"""FhtKac rotator: random sign flips x 4 rounds of fast Hadamard transform.

Port of rabitqlib::FhtKacRotator (reference utils/rotator.hpp:207-310): the
whole state is 4*padded_dim flip bits; rotate() = 4 rounds of
[sign flip -> FHT -> scale 1/sqrt(dim)]. The reference's 19.7k-line unrolled
AVX kernels (utils/fht_avx.hpp) collapse into a log2(P)-step reshape
butterfly of elementwise ops. Dimensions are always padded to a power of two (the
reference's non-pow2 kacs_walk branch is unnecessary here).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np


def pad_dim(dim: int) -> int:
    p = 1
    while p < dim:
        p *= 2
    return max(p, 64)


def fht(x: jnp.ndarray) -> jnp.ndarray:
    """Unnormalized fast Hadamard transform over the last axis (pow2)."""
    b, p = x.shape
    h = 1
    while h < p:
        x = x.reshape(b, p // (2 * h), 2, h)
        a0 = x[:, :, 0, :]
        a1 = x[:, :, 1, :]
        x = jnp.stack([a0 + a1, a0 - a1], axis=2).reshape(b, p)
        h *= 2
    return x


@functools.partial(jax.jit, static_argnames=())
def _rotate(x: jnp.ndarray, signs: jnp.ndarray, fac: jnp.ndarray) -> jnp.ndarray:
    for r in range(4):
        x = x * signs[r][None, :]
        x = fht(x) * fac
    return x


class FhtKacRotator:
    def __init__(self, dim: int, seed: int = 0, flip_bits: np.ndarray | None = None):
        self.dim = dim
        self.padded_dim = pad_dim(dim)
        if flip_bits is None:
            rng = np.random.default_rng(seed)
            flip_bits = rng.integers(
                0, 256, size=(4, self.padded_dim // 8), dtype=np.uint8
            )
        self.flip_bits = flip_bits  # serialization state, like flip_ bytes
        bits = np.unpackbits(flip_bits, axis=1, bitorder="little")
        self.signs = jnp.asarray(1.0 - 2.0 * bits[:, : self.padded_dim], jnp.float32)
        self.fac = jnp.float32(1.0 / np.sqrt(self.padded_dim))

    def rotate(self, x) -> jnp.ndarray:
        """f32[B, padded_dim] rotation of f32[B, dim] (zero padded)."""
        x = jnp.asarray(np.asarray(x, np.float32))
        if x.ndim == 1:
            x = x[None]
        b, d = x.shape
        if d < self.padded_dim:
            x = jnp.pad(x, ((0, 0), (0, self.padded_dim - d)))
        return _rotate(x, self.signs, self.fac)

    def state(self) -> np.ndarray:
        return self.flip_bits

    @classmethod
    def from_state(cls, dim: int, flip_bits: np.ndarray) -> "FhtKacRotator":
        return cls(dim, flip_bits=flip_bits)
