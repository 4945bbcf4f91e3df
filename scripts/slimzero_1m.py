"""SlimZero at 1M: convert the reference-built vanilla graph with the
in-degree-guard pipeline (convert_to_slimzero) and measure recall/QPS + size.

VERDICT-r1: SlimZero had no at-scale validation (largest test 6k). This run
uses the same 1M reference-built vanilla HNSW the bench imports, so the
comparison triangle is: reference slim graph (bench) vs our slim conversion
(selfbuild) vs our slimzero conversion (this) on identical data.

Usage: python scripts/slimzero_1m.py  (from the repository root)
"""

import dataclasses
import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

N, DIM, NQ = 1_000_000, 128, 1024


def main():
    from hnsw_slim_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    from hnsw_slim_tpu.config import SlimConfig
    from hnsw_slim_tpu.index.bruteforce import BruteForceIndex
    from hnsw_slim_tpu.index.slimzero import HnswSlimZeroIndex
    from hnsw_slim_tpu.persist.checkpoint import load_hnsw
    from hnsw_slim_tpu.utils.data import clustered

    base, queries = clustered(N, DIM, n_queries=NQ,
                              n_clusters=max(64, N // 1000), seed=7,
                              scale=0.3)
    bf = BruteForceIndex(base)
    _, gt = bf.search(queries, k=10)
    import gc

    del bf
    gc.collect()

    npz = os.path.join(REPO, f".bench_cache/ref_{N}_128_1024_v3.slimgraph.hnsw.npz")
    t0 = time.perf_counter()
    h = load_hnsw(npz)
    print(f"import: {time.perf_counter()-t0:.1f}s", flush=True)

    t0 = time.perf_counter()
    idx = HnswSlimZeroIndex.from_hnsw(h, SlimConfig.from_ratios())
    t_conv = time.perf_counter() - t0
    print(f"slimzero convert: {t_conv:.1f}s "
          f"({idx.index_size()/1e6:.1f} MB graph; closed-form estimate "
          f"{HnswSlimZeroIndex.size_estimate(N, '32', SlimConfig.from_ratios())/1e6:.1f} MB)",
          flush=True)

    points = {}
    idx.scfg = dataclasses.replace(idx.scfg, straggler_stages=(4, 16))
    for ef in (64, 128, 192, 256, 384, 512):
        tune = idx.autotune(ef)
        print(f"  autotune ef={ef}: {tune['knobs']}", flush=True)
        _, ids = idx.search(queries, k=10)
        times = [0.0] * 3
        for i in range(3):
            t0 = time.perf_counter()
            idx.search(queries, k=10)
            times[i] = time.perf_counter() - t0
        rec = sum(len(set(a.tolist()) & set(b.tolist()))
                  for a, b in zip(ids, gt)) / gt.size
        qps = NQ / min(times)
        points[ef] = (round(rec, 4), round(qps))
        print(f"slimzero ef={ef}: recall@10={rec:.4f} qps={qps:.0f}",
              flush=True)
        if rec >= 0.95:
            break
    print(json.dumps({
        "mode": "slimzero_1m", "convert_s": round(t_conv, 1),
        "graph_mb": round(idx.index_size() / 1e6, 1),
        "points": {str(k): list(v) for k, v in points.items()},
    }), flush=True)


if __name__ == "__main__":
    main()
