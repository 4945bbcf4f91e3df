"""Global configuration for the HNSW-Slim engine.

Mirrors the reference's mutable globals and gflags-derived parameters
(reference: include/core.h:30-38, main.cc:46-110) as immutable dataclasses.

Derived-parameter convention (reference main.cc:58-70):
    low_m0 = top_M0 * Mm_ratio / 100
    top_M  = level_ratio/100 * top_M0
    low_m  = level_ratio/100 * low_m0

`branching_factor` is a string: "e", "sqrt", or a number; it controls the
level-sampling probability via mult_ = 1/log(bf) (reference hnswalg.h:143-158).
"""

from __future__ import annotations

import dataclasses
import math


def branching_mult(branching_factor: str) -> float:
    """mult_ used for geometric level sampling (reference hnswalg.h:143-158)."""
    if branching_factor == "e":
        return 1.0 / math.log(math.e)
    if branching_factor == "sqrt":
        return 1.0 / math.log(math.sqrt(2.0) / (math.sqrt(2.0) - 1.0))
    return 1.0 / math.log(float(branching_factor))


@dataclasses.dataclass(frozen=True)
class HnswConfig:
    """Parameters of the vanilla HNSW build (reference hnswalg.h ctor + main.cc flags)."""

    M: int = 30
    M0: int = 0  # 0 -> defaults to 2*M (reference hnswalg.h maxM0_ = M * 2)
    ef_construction: int = 128
    ef_search: int = 128
    branching_factor: str = "32"  # paper default p = 1/32 (BASELINE.md)
    metric: str = "l2"  # "l2" (squared L2) or "ip" (1 - dot)
    seed: int = 100  # reference hnswalg.h random_seed default 100
    # On-device vector storage: "float32" (exact, reference parity) or
    # "bfloat16" (halves HBM — the dominant term at 100M scale; traversal
    # and returned distances become ~1e-2-relative approximate)
    store_dtype: str = "float32"

    @property
    def maxM(self) -> int:
        return self.M

    @property
    def maxM0(self) -> int:
        return self.M0 if self.M0 > 0 else 2 * self.M

    @property
    def mult(self) -> float:
        return branching_mult(self.branching_factor)


@dataclasses.dataclass(frozen=True)
class SlimConfig:
    """Two-stage pruning parameters (reference main.cc:27-39,58-70; paper §7.1.3).

    top_degree_percent0/percent = alpha: fraction of highest-degree nodes that
    keep the large budget (degree threshold walk, hnswalg_slim.h:923-945).
    """

    threshold_level: int = 0
    top_degree_percent0: float = 0.02
    top_degree_percent: float = 0.02
    top_M0: int = 32
    low_m0: int = 8
    top_M: int = 16
    low_m: int = 4
    # SlimZero only (reference main.cc:37-38, hnswalg_slimzero.h)
    min_indegree0: int = 8
    min_indegree: int = 4

    @classmethod
    def from_ratios(
        cls,
        top_M0: int = 32,
        level_ratio: int = 50,
        Mm_ratio: int = 25,
        top_degree_percent0: float = 0.02,
        threshold_level: int = 0,
        **kw,
    ) -> "SlimConfig":
        """Reference main.cc:58-70 derivation."""
        ratio = level_ratio / 100.0
        low_m0 = top_M0 * Mm_ratio // 100
        return cls(
            threshold_level=threshold_level,
            top_degree_percent0=top_degree_percent0,
            top_degree_percent=top_degree_percent0,
            top_M0=top_M0,
            low_m0=low_m0,
            top_M=int(ratio * top_M0),
            low_m=int(ratio * low_m0),
            **kw,
        )


@dataclasses.dataclass(frozen=True)
class SearchConfig:
    """Runtime search knobs for the batched device search kernels."""

    ef: int = 128
    # Static iteration cap for the best-first while_loop. The batch runs in
    # lockstep, so the SLOWEST query sets the iteration count (measured: the
    # straggler tail costs 2-4x at 1M nodes); the auto cap trades the tail of
    # straggler recall for throughput and scales with pop_width.
    max_iters: int = 0  # 0 -> auto: (2*ef + 16) / pop_width + 8
    # Expand this many best-unchecked entries per beam iteration
    # (DiskANN-style beamwidth; 1 = exact reference pop semantics). 4 is
    # measured fastest AND highest-recall at scale (superset expansion):
    # 1M nodes, ef=64: pop=1 1140qps/0.671 -> pop=4 1457qps/0.679.
    pop_width: int = 4
    # Straggler compaction: once at most B/frac queries are still active,
    # compact them into a B/frac-wide sub-batch and continue there (each
    # fraction is one extra stage). The lockstep loop makes every query pay
    # the slowest query's iterations; compaction cuts the per-iteration cost
    # by the batch ratio with bit-identical per-query results. (2, 8, 32)
    # exits the full-width loop early and compacts deeply; its speed on the
    # GPU against other stage lists is not measured yet.
    straggler_stages: tuple = (2, 8, 32)
    # Cap on surviving candidate lanes per iteration after compaction
    # (0 = auto: max(2*ef, 128)). Pruned-graph pops yield ~7 unique new
    # neighbors each, so a tight cap shrinks the gather/score/merge width.
    scan_width: int = 0
    # Multi-seed base layer: > 1 (with threshold_level 0) runs level 1 as a
    # seed_width-wide beam and seeds the L0 buffer with ALL its survivors
    # instead of the single greedy-descent entry (diversity against
    # cluster-local minima; strict superset of the 1-seed traversal).
    seed_width: int = 0
    # Stratified seeds: > 1 splits the up table into that many equal
    # segments (shards of a union graph) and picks seed_width/strata seeds
    # per segment — disconnected shard components are only reachable
    # through seeds (parallel/flat_union.py sets this to S).
    seed_strata: int = 0
    # dynamic_ef: compile ONE program with an ef_max-wide buffer and pass the
    # runtime ef as data — set_ef becomes compile-free (the reference's setEf)
    # at the cost of always paying the ef_max sort width.
    dynamic_ef: bool = False
    ef_max: int = 256
    # SlimQ only: traverse on (1 + ex_bits)-bit estimates instead of 1-bit
    # (reference searchBaseLayerST<use_ex>, hnswalg_slimq.h:688-761) — tighter
    # estimates, more bytes gathered per hop.
    use_ex: bool = False

    def iters(self) -> int:
        if self.max_iters > 0:
            return self.max_iters
        return (2 * self.ef + 16) // self.pop_width + 8


@dataclasses.dataclass(frozen=True)
class QuantConfig:
    """RaBitQ parameters (reference hnsw_slimq_strategy.h:42-60, rabitqlib)."""

    total_bits: int = 4  # 1 sign bit + (total_bits-1) ex bits per dim
    num_clusters: int = 16  # KMeans-16 centroids (hnsw_slimq_strategy.h:44-45)
    kmeans_iters: int = 25

    @property
    def ex_bits(self) -> int:
        return self.total_bits - 1
