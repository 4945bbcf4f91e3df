"""Build the SECOND 8M shard set with the framework's OWN device builder.

The seed-7 set is reference-built (build_8m_shards.py — the graph-import
oracle path); this one is 8 x 1M in-framework insertion builds + Slim
conversions on the accelerator (graph/build.py, graph/prune.py) — at-scale evidence
for the self-build path (round-4 verdict item 8) AND the second half of the
16M corpus (scripts/serve_16m.py). Output: shard{i}.npz checkpoints
(persist/checkpoint.save_slim) that serve_16m.py loads host-side.

Runs in the background while the CPU builds the reference set; per-shard
wall-clock is recorded but NOT a clean benchmark when contended (1-core
host). Restartable (skips existing shards).

Usage: python scripts/build_8m_shards_self.py  (from the repository root)
"""

import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

N, DIM, S = 8_000_000, 128, 8
SEED = int(os.environ.get("SHARDS_SEED", 11))
OUT = os.environ.get("SHARDS_OUT", os.path.join(REPO, ".bench_cache/shards8m_b"))


def main():
    from hnsw_slim_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    from hnsw_slim_tpu.config import HnswConfig, SlimConfig
    from hnsw_slim_tpu.index.hnsw import HnswIndex
    from hnsw_slim_tpu.index.slim import HnswSlimIndex
    from hnsw_slim_tpu.persist.checkpoint import save_slim
    from hnsw_slim_tpu.utils.data import clustered

    os.makedirs(OUT, exist_ok=True)
    t0 = time.time()
    base, _ = clustered(N, DIM, n_queries=16, n_clusters=N // 1000,
                        seed=SEED, scale=0.3)
    print(f"data gen {time.time()-t0:.0f}s", flush=True)

    for si in range(S):
        path = f"{OUT}/shard{si}.npz"
        if os.path.exists(path):
            print(f"shard {si}: exists, skip", flush=True)
            continue
        t1 = time.time()
        sub = np.ascontiguousarray(base[si::S])
        h = HnswIndex(HnswConfig(M=30, ef_construction=128),
                      strategy="insert")
        h.build(sub)
        tb = time.time() - t1
        t2 = time.time()
        idx = HnswSlimIndex.from_hnsw(h, SlimConfig.from_ratios())
        save_slim(path, idx)
        print(f"shard {si}: build {tb:.0f}s convert+save "
              f"{time.time()-t2:.0f}s", flush=True)
        del h, idx, sub
        import gc

        gc.collect()


if __name__ == "__main__":
    main()
