"""HNSW-SlimZero index: in-degree-guarded pruning, no reverse-edge union.

Counterpart of HierarchicalNSWSlimZero (reference
hnswalg_slimzero.h) and HnswSlimZeroStrategy (hnsw_slimzero_strategy.h:38-141).
Search is identical to Slim (same CHAL layout); only the conversion differs.
"""

from __future__ import annotations

import math

import numpy as np

from ..config import HnswConfig, SearchConfig, SlimConfig
from ..graph.prune import convert_to_slimzero
from .hnsw import HnswIndex
from .slim import HnswSlimIndex


class HnswSlimZeroIndex(HnswSlimIndex):
    @classmethod
    def from_hnsw(
        cls,
        hnsw: HnswIndex,
        slim_cfg: SlimConfig,
        search_cfg: SearchConfig | None = None,
        count_level0_hubs: bool = False,
        verbose: bool = False,
    ) -> "HnswSlimZeroIndex":
        idx = cls(metric=hnsw.cfg.metric, search_cfg=search_cfg)
        idx.vectors = hnsw.vectors
        idx.vn = hnsw.vn
        idx.graph = convert_to_slimzero(
            hnsw.graph, hnsw.vectors, hnsw.vn, slim_cfg,
            metric=hnsw.cfg.metric, count_level0_hubs=count_level0_hubs,
            verbose=verbose,
        )
        return idx

    @classmethod
    def build(
        cls,
        vectors: np.ndarray,
        hnsw_cfg: HnswConfig | None = None,
        slim_cfg: SlimConfig | None = None,
        max_batch: int = 4096,
        verbose: bool = False,
    ) -> "HnswSlimZeroIndex":
        hnsw = HnswIndex(hnsw_cfg or HnswConfig(), max_batch=max_batch)
        hnsw.build(vectors, verbose=verbose)
        return cls.from_hnsw(hnsw, slim_cfg or SlimConfig.from_ratios(),
                             verbose=verbose)

    @staticmethod
    def size_estimate(
        n: int, branching_factor: str, slim_cfg: SlimConfig
    ) -> float:
        """Closed-form index-size model in bytes
        (reference hnsw_slimzero_strategy.h:106-120)."""
        decay = 1.0 / float(branching_factor)
        size_1 = 16.0 * n
        size_2 = 2.0 * n * decay / (1 - decay)
        mix = (
            slim_cfg.top_degree_percent * slim_cfg.top_M
            + (1 - slim_cfg.top_degree_percent) * slim_cfg.low_m
        )
        if slim_cfg.threshold_level == 0:
            size_3 = 4.0 * n * (2 + decay) * mix
        else:
            size_3 = (
                4.0 * n
                * (2 - decay + math.pow(decay, slim_cfg.threshold_level + 1))
                * mix
            )
        return size_1 + size_2 + size_3
