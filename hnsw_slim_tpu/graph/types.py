"""Flat-array graph containers — the device answer to pointer-chasing CHAL blocks.

Reference layout (hnswalg_slim.h:1096-1106): one malloc'd block per node =
uint16 per-level prefix offsets + packed uint32 neighbor ids. Here the whole
index is three device arrays (struct-of-arrays):

    nbr     int32[E_pad]        all nodes' neighbor ids, concatenated
    lvl_off int32[N, L_max+2]   absolute offsets; level-l slice of node v is
                                nbr[lvl_off[v,l] : lvl_off[v,l+1]]
    level   int32[N]            element level (hnswalg.h element_levels_)

CHAL semantics are preserved exactly: lvl_off[v, l] is the running prefix, and
levels above a node's own level have empty slices (offsets saturate).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class ChalGraph:
    """Pruned (Slim) hierarchical adjacency in flat arrays."""

    nbr: jnp.ndarray  # int32[E_pad]
    lvl_off: jnp.ndarray  # int32[N_pad, L_max+2]
    level: jnp.ndarray  # int32[N_pad] (-1 on padding rows)
    entry: jnp.ndarray  # int32[] scalar: enterpoint_node_
    max_level: int = dataclasses.field(metadata=dict(static=True))
    threshold_level: int = dataclasses.field(metadata=dict(static=True))
    cap0: int = dataclasses.field(metadata=dict(static=True))  # max level-0 degree
    cap: int = dataclasses.field(metadata=dict(static=True))  # max upper degree
    # logical element count when the node dim is padded (0 = unpadded).
    # Padding keeps compiled search shapes stable across /updateIndex growth.
    n_real: int = dataclasses.field(metadata=dict(static=True), default=0)

    @property
    def n(self) -> int:
        return self.n_real or self.level.shape[0]

    def chal_bytes(self) -> int:
        """Graph-only byte accounting, EXACTLY the reference's indexSize
        (hnswalg_slim.h:2435-2443): 16 B per node (nbr ptr 8 + total 4 + 4)
        + per-node CHAL block (u16 offset per level + u32 per neighbor id).
        Verified equal to the reference binary's printed size on an imported
        reference-built graph."""
        total_nbrs = int(np.asarray(self.lvl_off[:, -1] - self.lvl_off[:, 0]).sum())
        levels = np.asarray(self.level)
        real = levels >= 0  # capacity-padding rows carry level -1
        return int(16 * int(real.sum()) + 2 * int(levels[real].sum())
                   + 4 * total_nbrs)


def pad_chal_nodes(chal: ChalGraph, multiple: int = 65536) -> ChalGraph:
    """Pad the node dimension to a multiple so serving programs compile once
    per capacity bucket instead of once per /updateIndex (the reference's
    pointer engine has no compiled shapes; here a 1-node growth would
    otherwise recompile the 1M-scale search). Padding rows: level -1,
    saturated (empty) offset slices — unreachable by traversal."""
    logical = chal.n
    n = chal.level.shape[0]
    n_pad = -(-n // multiple) * multiple
    if n_pad == n:
        return chal if chal.n_real else dataclasses.replace(chal, n_real=n)
    tail_off = chal.lvl_off[-1, -1]
    lvl_off = jnp.concatenate([
        chal.lvl_off,
        jnp.broadcast_to(tail_off, (n_pad - n, chal.lvl_off.shape[1])),
    ])
    level = jnp.concatenate([
        chal.level, jnp.full((n_pad - n,), -1, jnp.int32)
    ])
    return dataclasses.replace(
        chal, lvl_off=lvl_off, level=level, n_real=logical
    )


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class LevelGraph:
    """Unpruned build-time HNSW adjacency: one dense padded array per level.

    adj[l] is int32[N, M_l] (-1 padded), M_0 = maxM0, M_l = maxM above
    (reference hnswalg.h:108-109). Rows are only meaningful for nodes with
    level >= l.
    """

    adjs: tuple  # tuple of int32[N_pad, M_l]
    level: jnp.ndarray  # int32[N_pad] (-1 on capacity-padding rows)
    entry: jnp.ndarray  # int32[] scalar
    max_level: int = dataclasses.field(metadata=dict(static=True))
    # logical element count when rows are capacity-padded (0 = unpadded).
    # Capacity buckets keep insert-path programs compiled once across
    # /updateIndex growth (a vector of N+1000 would otherwise recompile).
    n_real: int = dataclasses.field(metadata=dict(static=True), default=0)

    @property
    def n(self) -> int:
        return self.n_real or self.level.shape[0]


def pack_chal(
    neighbors_by_level: list[list[np.ndarray]],
    levels: np.ndarray,
    entry: int,
    max_level: int,
    threshold_level: int,
    cap0: int,
    cap: int,
    pad_to: int = 1024,
) -> ChalGraph:
    """Pack host-side per-(node, level) neighbor lists into a ChalGraph.

    neighbors_by_level[v][l] = int32 array of node v's level-l neighbors
    (mirrors the packing loop at hnswalg_slim.h:1088-1106).
    """
    n = len(levels)
    lvl_off = np.zeros((n, max_level + 2), np.int32)
    chunks = []
    pos = 0
    for v in range(n):
        lv = int(levels[v])
        for l in range(max_level + 1):
            lvl_off[v, l] = pos
            if l <= lv:
                ids = np.asarray(neighbors_by_level[v][l], np.int32)
                chunks.append(ids)
                pos += len(ids)
        lvl_off[v, max_level + 1] = pos
    flat = np.concatenate(chunks) if chunks else np.zeros((0,), np.int32)
    e_pad = max(pad_to, ((pos + pad_to - 1) // pad_to) * pad_to)
    nbr = np.full((e_pad,), -1, np.int32)
    nbr[:pos] = flat
    return ChalGraph(
        nbr=jnp.asarray(nbr),
        lvl_off=jnp.asarray(lvl_off),
        level=jnp.asarray(np.asarray(levels, np.int32)),
        entry=jnp.asarray(np.int32(entry)),
        max_level=int(max_level),
        threshold_level=int(threshold_level),
        cap0=int(cap0),
        cap=int(cap),
    )
