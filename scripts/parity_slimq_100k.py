"""SlimQ head-to-head vs the reference quantized engine at 100k scale
(VERDICT round-1 item 4: the 5k test in tests/test_parity_slimq.py, scaled to
a realistic dataset — shared data, shared kmeans-16 centroids, recall at
equal ef, plus QPS of both engines).

PQ_SCALE controls dataset hardness for the 1-bit estimator: scale=0.3
(the bench's SIFT-like clustered setting) has ~100 natural clusters but only
16 kmeans centroids, so RaBitQ residuals are large and BOTH engines collapse
(measured: reference recall@10 = 0.064/0.093/0.127 at ef=32/64/128 vs this
repo's 0.169/0.279/0.466 — the in-traversal exact-rerank track degrades more
gracefully). scale=1.0 approximates the near-unimodal geometry the reference
paper's real datasets have, where 16 centroids are adequate.

Usage: python scripts/parity_slimq_100k.py  (from the repository root)
Results are recorded in PARITY.md.
"""

import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

N, DIM, NQ = int(os.environ.get("PQ_N", 100_000)), 128, 512
SCALE = float(os.environ.get("PQ_SCALE", 1.0))
EFS = (32, 64, 128)
OUT = os.path.join(REPO, f".bench_cache/slimq100k_s{SCALE:g}")


def recall(ids, gt):
    return sum(len(set(a.tolist()) & set(b.tolist()))
               for a, b in zip(ids, gt)) / gt.size


def main():
    from hnsw_slim_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    from hnsw_slim_tpu.config import HnswConfig, SlimConfig
    from hnsw_slim_tpu.index.bruteforce import BruteForceIndex
    from hnsw_slim_tpu.index.slimq import HnswSlimQIndex
    from hnsw_slim_tpu.quant.kmeans import kmeans
    from hnsw_slim_tpu.utils.data import clustered
    from hnsw_slim_tpu.utils.io import read_ivecs, write_fvecs, write_ivecs

    os.makedirs(OUT, exist_ok=True)
    base, queries = clustered(N, DIM, n_queries=NQ, n_clusters=N // 1000,
                              seed=13, scale=SCALE)
    bf = BruteForceIndex(base)
    _, gt = bf.search(queries, k=10)

    cent, asn = kmeans(base, 16, iters=10, seed=0)
    bp, qp = f"{OUT}/b.fvecs", f"{OUT}/q.fvecs"
    cp, ap, rp = f"{OUT}/c.fvecs", f"{OUT}/a.ivecs", f"{OUT}/r.ivecs"
    write_fvecs(bp, base)
    write_fvecs(qp, queries)
    write_fvecs(cp, np.asarray(cent))
    write_ivecs(ap, np.asarray(asn, np.int32).reshape(-1, 1))

    t0 = time.time()
    out = subprocess.run(
        [os.path.join(REPO, "parity/ref_harness"), bp, qp, rp, "slimq", "32", "128",
         ",".join(map(str, EFS)), "10", "1", "", cp, ap],
        capture_output=True, text=True, timeout=7200,
    )
    assert out.returncode == 0, out.stderr[-500:]
    print(f"reference slimq build+search: {time.time()-t0:.0f}s", flush=True)
    stats = dict(l.split() for l in out.stdout.strip().splitlines()
                 if len(l.split()) == 2)
    for ef in EFS:
        ids = read_ivecs(f"{rp}.ef{ef}")
        q = NQ / (float(stats[f"solve_ms_ef{ef}"]) / 1e3)
        print(f"reference slimq ef={ef}: recall={recall(ids, gt):.4f} "
              f"qps={q:.0f} (1-core CPU)", flush=True)

    t0 = time.time()
    idx = HnswSlimQIndex.build(
        base, HnswConfig(M=32, ef_construction=128),
        SlimConfig(top_M0=32, low_m0=8, top_M=16, low_m=4),
    )
    print(f"slimq build: {time.time()-t0:.0f}s", flush=True)
    for ef in EFS:
        idx.set_ef(ef)
        _, ids = idx.search(queries, k=10)  # compile + warm
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            idx.search(queries, k=10)
            times.append(time.perf_counter() - t0)
        print(f"slimq ef={ef}: recall={recall(ids, gt):.4f} "
              f"qps={NQ/min(times):.0f}", flush=True)

    for p in (bp, qp):
        os.remove(p)


if __name__ == "__main__":
    main()
