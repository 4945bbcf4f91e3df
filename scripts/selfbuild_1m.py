"""Self-build at 1M: this framework's OWN pipeline end-to-end on the GPU.

The bench serves a reference-built graph to isolate search throughput;
this script instead runs the full in-framework path at scale —
NND build (graph/nnd.py) -> slim conversion (graph/prune.convert_to_slim)
-> staged search — and reports build/convert wall-clock plus the recall/QPS
sweep vs brute-force GT. VERDICT-r1 weak #7: the conversion pipeline was
never exercised at a realistic degree distribution; this is that run.

Usage: python scripts/selfbuild_1m.py  (from the repository root)
Results recorded in README.md.
"""

import dataclasses
import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

N, DIM, NQ = int(os.environ.get("SB_N", 1_000_000)), 128, 1024
STRATEGY = os.environ.get("SB_STRATEGY", "nnd")  # nnd | insert
# build-clock knobs (VERDICT r3 item 1: beat the reference's 556 s 1-core
# build at served recall >= 0.95). Larger insert batches amortize host
# orchestration; lower efc narrows the per-insert beam — both trade a
# little graph quality, and the serving sweep below verifies the margin.
MAXBATCH = int(os.environ.get("SB_MAXBATCH", 4096))
EFC = int(os.environ.get("SB_EFC", 128))
M = int(os.environ.get("SB_M", 30))
# SB_SEED: exact-seed multi-entry width at serve time (r5 kernel; 0 = greedy
# descent). SB_FRESH=1 ignores the build cache — for min-of-3 build clocks.
SEED = int(os.environ.get("SB_SEED", 32))
FRESH = os.environ.get("SB_FRESH") == "1"


def main():
    from hnsw_slim_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    from hnsw_slim_tpu.config import HnswConfig, SearchConfig, SlimConfig
    from hnsw_slim_tpu.index.bruteforce import BruteForceIndex
    from hnsw_slim_tpu.index.hnsw import HnswIndex
    from hnsw_slim_tpu.index.slim import HnswSlimIndex
    from hnsw_slim_tpu.utils.data import clustered

    import gc

    from hnsw_slim_tpu.persist.checkpoint import load_hnsw, save_hnsw

    base, queries = clustered(N, DIM, n_queries=NQ,
                              n_clusters=max(64, N // 1000), seed=7,
                              scale=0.3)
    bf = BruteForceIndex(base)
    _, gt = bf.search(queries, k=10)
    del bf  # frees its 512 MB device copy of base (HBM headroom for convert)
    gc.collect()

    tag = f"{STRATEGY}_b{MAXBATCH}_e{EFC}_m{M}" \
        if (MAXBATCH, EFC, M) != (4096, 128, 30) else STRATEGY
    cache = os.path.join(REPO, f".bench_cache/selfbuild_{N}_{tag}.npz")
    t0 = time.perf_counter()
    if os.path.exists(cache) and not FRESH:
        h = load_hnsw(cache)
        t_build = float(open(cache + ".time").read())
        print(f"{tag} build: cached ({t_build:.1f}s original)", flush=True)
    else:
        h = HnswIndex(HnswConfig(M=M, ef_construction=EFC),
                      strategy=STRATEGY, max_batch=MAXBATCH)
        h.build(base, verbose=True)
        t_build = time.perf_counter() - t0
        save_hnsw(cache, h)
        open(cache + ".time", "w").write(str(t_build))
        print(f"{tag} build: {t_build:.1f}s", flush=True)

    t0 = time.perf_counter()
    idx = HnswSlimIndex.from_hnsw(h, SlimConfig.from_ratios())
    t_conv = time.perf_counter() - t0
    print(f"slim convert: {t_conv:.1f}s  "
          f"({idx.index_size()/1e6:.1f} MB graph)", flush=True)
    idx.check_integrity()
    print("integrity OK", flush=True)
    if os.environ.get("SB_DENSE0", "1") == "1":
        idx.densify_level0()

    points = {}
    idx.scfg = dataclasses.replace(idx.scfg, straggler_stages=(4, 16),
                                   seed_width=SEED)
    efs = (48, 64, 96, 128, 192) if SEED > 1 else (64, 96, 128, 192, 256, 384)
    for ef in efs:
        tune = idx.autotune(ef)
        print(f"  autotune ef={ef}: {tune['knobs']}", flush=True)
        _, ids = idx.search(queries, k=10)  # compile + warm
        times = [0.0] * 3
        for i in range(3):
            t0 = time.perf_counter()
            idx.search(queries, k=10)
            times[i] = time.perf_counter() - t0
        rec = sum(len(set(a.tolist()) & set(b.tolist()))
                  for a, b in zip(ids, gt)) / gt.size
        qps = NQ / min(times)
        points[ef] = (round(rec, 4), round(qps))
        print(f"selfbuild ef={ef}: recall@10={rec:.4f} qps={qps:.0f}",
              flush=True)
        if rec >= 0.95:
            break
    print(json.dumps({
        "mode": f"selfbuild_1m_{tag}", "build_s": round(t_build, 1),
        "convert_s": round(t_conv, 1),
        "graph_mb": round(idx.index_size() / 1e6, 1),
        "points": {str(k): list(v) for k, v in points.items()},
    }), flush=True)


if __name__ == "__main__":
    main()
