"""hnsw-slim-tpu: a batched graph-ANN engine in JAX with HNSW-Slim's capabilities.

Public surface (see README.md / PARITY.md):

    from hnsw_slim_tpu import (
        HnswConfig, SlimConfig, SearchConfig, QuantConfig,
        HnswIndex, HnswSlimIndex, HnswSlimZeroIndex, HnswSlimQIndex,
        BruteForceIndex,
    )
"""

from .config import HnswConfig, QuantConfig, SearchConfig, SlimConfig

__all__ = [
    "HnswConfig", "SlimConfig", "SearchConfig", "QuantConfig",
    "HnswIndex", "HnswSlimIndex", "HnswSlimZeroIndex", "HnswSlimQIndex",
    "BruteForceIndex", "ShardedSlimIndex",
]


def __getattr__(name):  # lazy: index classes pull in jax
    if name in ("HnswIndex",):
        from .index.hnsw import HnswIndex

        return HnswIndex
    if name == "HnswSlimIndex":
        from .index.slim import HnswSlimIndex

        return HnswSlimIndex
    if name == "HnswSlimZeroIndex":
        from .index.slimzero import HnswSlimZeroIndex

        return HnswSlimZeroIndex
    if name == "HnswSlimQIndex":
        from .index.slimq import HnswSlimQIndex

        return HnswSlimQIndex
    if name == "BruteForceIndex":
        from .index.bruteforce import BruteForceIndex

        return BruteForceIndex
    if name == "ShardedSlimIndex":
        from .parallel.sharded import ShardedSlimIndex

        return ShardedSlimIndex
    raise AttributeError(name)
