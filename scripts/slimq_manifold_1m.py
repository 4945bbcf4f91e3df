"""SlimQ in the regime it was designed for: low-intrinsic-dimension data
(VERDICT r2 missing #4 / next-round item 6).

Every prior SlimQ number was on iid/clustered synthetics where BOTH engines
collapse — RaBitQ's 1-bit estimator needs the low intrinsic dimension real
embeddings have (reference paper Table 6: >=98% recall with 6.3x memory
reduction on SIFT/GIST-class data; hnswalg_slimq.h:1810-1918). This run
generates 1M points on a 24-dim latent manifold embedded in 128-d
(utils/data.manifold), builds SlimQ, and records:

  - recall@10 / QPS over an ef sweep, with and without exact rerank
  - Table-6-style memory accounting: index bytes (graph + codes, raw
    vectors NOT in the index - the LEANN-style layout,
    hnsw_slimq_strategy.h:145) vs the Slim-fp32 equivalent
  - the reference slimq engine head-to-head on the SAME data + centroids

Usage:
  python scripts/slimq_manifold_1m.py  (from the repository root)
Env: MQ_N (default 1_000_000), MQ_REF=0 to skip the reference run.
Results recorded in PARITY.md.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

N = int(os.environ.get("MQ_N", 1_000_000))
DIM, NQ, LAT = 128, 1024, 24
EFS = tuple(int(e) for e in os.environ.get("MQ_EFS", "32,64,128").split(","))
OUT = os.path.join(REPO, f".bench_cache/slimq_manifold_{N}")


def recall(ids, gt):
    return sum(len(set(a.tolist()) & set(b.tolist()))
               for a, b in zip(ids, gt)) / gt.size


def main():
    from hnsw_slim_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    from hnsw_slim_tpu.config import HnswConfig, QuantConfig, SlimConfig
    from hnsw_slim_tpu.index.bruteforce import BruteForceIndex
    from hnsw_slim_tpu.index.slimq import HnswSlimQIndex
    from hnsw_slim_tpu.quant.kmeans import kmeans
    from hnsw_slim_tpu.utils.data import manifold
    from hnsw_slim_tpu.utils.io import read_ivecs, write_fvecs, write_ivecs

    os.makedirs(OUT, exist_ok=True)
    t0 = time.time()
    base, queries = manifold(N, DIM, latent_dim=LAT, n_queries=NQ,
                             n_clusters=max(64, N // 4000), seed=5)
    print(f"manifold data ({LAT}-dim latent in {DIM}-d): "
          f"{time.time()-t0:.0f}s", flush=True)
    bf = BruteForceIndex(base)
    _, gt = bf.search(queries, k=10)
    del bf
    import gc

    gc.collect()

    cent, asn = kmeans(base, 16, iters=10, seed=0)

    if os.environ.get("MQ_REF", "1") != "0":
        bp, qp = f"{OUT}/b.fvecs", f"{OUT}/q.fvecs"
        cp, ap, rp = f"{OUT}/c.fvecs", f"{OUT}/a.ivecs", f"{OUT}/r.ivecs"
        write_fvecs(bp, base)
        write_fvecs(qp, queries)
        write_fvecs(cp, np.asarray(cent))
        write_ivecs(ap, np.asarray(asn, np.int32).reshape(-1, 1))
        t0 = time.time()
        out = subprocess.run(
            [os.path.join(REPO, "parity/ref_harness"), bp, qp, rp, "slimq", "32",
             "128", ",".join(map(str, EFS)), "10", "1", "", cp, ap],
            capture_output=True, text=True, timeout=14400,
        )
        os.remove(bp)
        assert out.returncode == 0, out.stderr[-500:]
        print(f"reference slimq build+search: {time.time()-t0:.0f}s",
              flush=True)
        stats = dict(l.split() for l in out.stdout.strip().splitlines()
                     if len(l.split()) == 2)
        ref_points = {}
        for ef in EFS:
            ids = read_ivecs(f"{rp}.ef{ef}")
            q = NQ / (float(stats[f"solve_ms_ef{ef}"]) / 1e3)
            ref_points[ef] = (recall(ids, gt), q)
            print(f"reference slimq ef={ef}: recall={ref_points[ef][0]:.4f} "
                  f"qps={q:.0f} (1-core CPU)", flush=True)
        ref_bytes = int(stats.get("slimq_index_bytes", 0))
    else:
        ref_points, ref_bytes = {}, 0

    t0 = time.time()
    ckpt = f"{OUT}/slimq.npz"
    if os.path.exists(ckpt):
        from hnsw_slim_tpu.persist.checkpoint import load_slimq

        idx = load_slimq(ckpt)
        idx.set_dataset(base)
        print(f"slimq load: {time.time()-t0:.0f}s", flush=True)
    else:
        idx = HnswSlimQIndex.build(
            base, HnswConfig(M=32, ef_construction=128),
            SlimConfig(top_M0=32, low_m0=8, top_M=16, low_m=4),
            QuantConfig(total_bits=4),
            strategy="insert" if N > 200_000 else "nnd",
        )
        print(f"slimq build: {time.time()-t0:.0f}s", flush=True)
        from hnsw_slim_tpu.persist.checkpoint import save_slimq

        save_slimq(ckpt, idx)
    fp32_equiv = idx.graph.chal_bytes() + base.nbytes  # Slim-fp32 serving set
    print(f"index bytes (graph+codes, no raw vectors): {idx.index_size()/1e6:.1f} MB"
          f"  vs slim-fp32 {fp32_equiv/1e6:.1f} MB "
          f"-> {fp32_equiv/idx.index_size():.2f}x reduction", flush=True)

    import dataclasses

    idx.densify_level0()
    idx.densify_upper()
    idx.scfg = dataclasses.replace(
        idx.scfg, straggler_stages=(2, 8, 32),
        seed_width=int(os.environ.get("MQ_SEED", 32)),
    )
    points = {}
    for rerank in (True, False):
        if not rerank and os.environ.get("MQ_EST", "1") == "0":
            continue
        for ef in EFS:
            tune = idx.autotune(ef)
            print(f"  autotune ef={ef}: {tune['knobs']} "
                  f"probe_recall={tune['probe_recall']:.4f}", flush=True)
            idx.set_ef(ef)
            _, ids = idx.search(queries, k=10, rerank=rerank)
            times = []
            for _ in range(3):
                t1 = time.perf_counter()
                idx.search(queries, k=10, rerank=rerank)
                times.append(time.perf_counter() - t1)
            r = recall(ids, gt)
            points[f"{'rr' if rerank else 'est'}_{ef}"] = (
                round(r, 4), round(NQ / min(times)))
            print(f"slimq ef={ef} rerank={rerank}: recall@10={r:.4f} "
                  f"qps={NQ/min(times):.0f}", flush=True)

    print(json.dumps({
        "mode": f"slimq_manifold_{N}", "latent_dim": LAT,
        "index_mb": idx.index_size() / 1e6,
        "slim_fp32_mb": fp32_equiv / 1e6,
        "reduction_x": round(fp32_equiv / idx.index_size(), 2),
        "ref_index_mb": ref_bytes / 1e6,
        "points": points,
        "ref_points": {str(e): [round(r, 4), round(q)]
                       for e, (r, q) in ref_points.items()},
    }), flush=True)


if __name__ == "__main__":
    main()
