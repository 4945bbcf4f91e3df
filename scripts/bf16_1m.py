"""bf16 vector-store serving at 1M: recall delta, HBM bytes, QPS vs f32.

VERDICT r2 item 8 asks for a measured bf16 at-scale run instead of the
"bf16 halves that" extrapolation. Serves the cached reference-built 1M
graph twice — store_dtype float32 vs bfloat16 — over an ef sweep with
autotuned knobs, reporting recall@10 vs brute-force GT, device HBM for the
vector store, and QPS. Whether row gathers on the card are bound by bytes
or by transactions decides whether bf16 also gathers faster; the first
question here is the recall cost of scoring against rounded vectors
(distance accumulation stays f32: ops/distance.py casts gathered rows up).

Usage: python scripts/bf16_1m.py  (from the repository root)
Prints a JSON summary; measured numbers belong in README's bf16 table.
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
    from hnsw_slim_tpu.graph.import_ref import slim_index_from_ref
    from hnsw_slim_tpu.index.bruteforce import BruteForceIndex
    from hnsw_slim_tpu.utils.data import clustered

    base, queries = clustered(N, DIM, n_queries=NQ,
                              n_clusters=max(64, N // 1000), seed=7,
                              scale=0.3)
    bf = BruteForceIndex(base)
    _, gt = bf.search(queries, k=10)
    del bf

    g = os.path.join(REPO, ".bench_cache/ref_1000000_128_1024_v3.slimgraph")
    out = {}
    for dtype in ("float32", "bfloat16"):
        idx = slim_index_from_ref(g, base, store_dtype=dtype)
        idx.densify_level0()
        idx.densify_upper()
        idx.scfg = dataclasses.replace(idx.scfg, straggler_stages=(4, 16))
        vec_bytes = idx.vectors.size * idx.vectors.dtype.itemsize
        pts = {}
        for ef in (64, 128, 256, 384):
            idx.autotune(ef)
            _, ids = idx.search(queries, k=10)  # compile + warm
            times = []
            for _ in range(3):
                t0 = time.perf_counter()
                idx.search(queries, k=10)
                times.append(time.perf_counter() - t0)
            rec = sum(len(set(a.tolist()) & set(b.tolist()))
                      for a, b in zip(ids, gt)) / gt.size
            qps = NQ / min(times)
            pts[ef] = (round(rec, 4), round(qps))
            print(f"{dtype} ef={ef}: recall@10={rec:.4f} qps={qps:.0f}",
                  flush=True)
        out[dtype] = {"vector_store_bytes": int(vec_bytes), "points": pts}
        del idx
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
