"""Build the 8M-vector sharded index (the Table-7 100M recipe at 1/12 scale).

Round-robin shards the 8M synthetic base over 8 shards; each shard's slim
graph is built by the reference C++ binary (the established graph-import
oracle path — reference-speed CPU builds feeding device serving, SURVEY §7
step 2), then everything is assembled into the stacked [S, ...] arrays
ShardedSlimIndex serves. Output: .bench_cache/shards8m/*.slimgraph + meta.

Runs ~45 min on this 1-core host; restartable (skips existing shards).
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
os.environ.setdefault("JAX_PLATFORMS", "cpu")

from hnsw_slim_tpu.utils.data import clustered  # noqa: E402
from hnsw_slim_tpu.utils.io import write_fvecs  # noqa: E402

N, DIM, S = 8_000_000, 128, 8
NQ = 1024
SEED = int(os.environ.get("SHARDS_SEED", 7))
OUT = os.environ.get("SHARDS_OUT", os.path.join(REPO, ".bench_cache/shards8m"))
HARNESS = os.path.join(REPO, "parity/ref_harness")


def main():
    os.makedirs(OUT, exist_ok=True)
    t0 = time.time()
    base, queries = clustered(N, DIM, n_queries=NQ, n_clusters=N // 1000,
                              seed=SEED, scale=0.3)
    write_fvecs(f"{OUT}/queries.fvecs", queries)
    print(f"data gen {time.time()-t0:.0f}s", flush=True)

    for si in range(S):
        gpath = f"{OUT}/shard{si}.slimgraph"
        if os.path.exists(gpath):
            print(f"shard {si}: cached", flush=True)
            continue
        gids = np.arange(si, N, S)
        local = base[gids]
        bp = f"{OUT}/shard{si}_b.fvecs"
        write_fvecs(bp, local)
        t1 = time.time()
        out = subprocess.run(
            [HARNESS, bp, f"{OUT}/queries.fvecs", f"{OUT}/r{si}.ivecs",
             "slim", "30", "128", "64", "10", "1", gpath],
            capture_output=True, text=True, timeout=4000,
        )
        assert out.returncode == 0, out.stderr[-300:]
        os.remove(bp)
        os.remove(f"{OUT}/r{si}.ivecs")
        os.remove(f"{OUT}/r{si}.ivecs.ef64")
        if os.path.exists(gpath + ".hnsw"):
            os.remove(gpath + ".hnsw")  # 8 x 106MB not needed for serving
        print(f"shard {si}: built in {time.time()-t1:.0f}s", flush=True)

    json.dump({"n": N, "dim": DIM, "shards": S, "seed": SEED, "scale": 0.3,
               "nq": NQ}, open(f"{OUT}/meta.json", "w"))
    print(f"all shards done in {time.time()-t0:.0f}s", flush=True)


if __name__ == "__main__":
    main()
