"""Serve the 8M sharded index (Table-7 100M recipe at reduced scale).

Consumes the shard graphs produced by scripts/build_8m_shards.py (8 x 1M
reference-built slim graphs over a round-robin split of an 8M synthetic
base). Two modes:

  gpu (default)  FlatUnionIndex on one GPU: the 8 disjoint graphs are
                 concatenated into one ChalGraph and served by the tuned
                 chal_search kernel (per-shard entry points, top-k merge).
                 Reports HBM bytes, graph bytes, recall@10 and QPS over an
                 ef sweep — the single-chip analog of reference Table 7
                 (DEEP-100M on one 24-core server, BASELINE.md:36-43).
  mesh           ShardedSlimIndex over the 8-virtual-device CPU mesh: same
                 shard set, per-shard search + all_gather top-k merge.
                 Functional validation of the multi-chip recipe + merge
                 overhead measurement (result parity vs the flat union).

Usage:
  python scripts/serve_8m.py [gpu|bf16|mesh]  (from the repository root)
(bf16 = gpu mode with store_dtype="bfloat16": measures the recall delta and
HBM/QPS of the halved vector store — the Table-7 100M-recipe arithmetic.)
Prints measured numbers; record them in README.md when run.
"""

import gc
import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

N, DIM, S, NQ = 8_000_000, 128, 8, 1024
OUT = os.path.join(REPO, ".bench_cache/shards8m")


def recall(ids, gt):
    return sum(len(set(a.tolist()) & set(b.tolist()))
               for a, b in zip(ids, gt)) / gt.size


def load_shards(base):
    from hnsw_slim_tpu.graph.import_ref import slim_index_from_ref

    shards = []
    for si in range(S):
        gids = np.arange(si, N, S, dtype=np.int32)
        t0 = time.time()
        idx = slim_index_from_ref(f"{OUT}/shard{si}.slimgraph", base[gids],
                                  upload=False)
        print(f"shard {si}: imported in {time.time()-t0:.0f}s "
              f"({idx.graph.chal_bytes()/1e6:.1f} MB graph)", flush=True)
        shards.append((idx, gids))
    return shards


def ground_truth(base, queries):
    gt_path = f"{OUT}/gt.ivecs"
    from hnsw_slim_tpu.utils.io import read_ivecs, write_ivecs

    if os.path.exists(gt_path):
        return read_ivecs(gt_path)
    from hnsw_slim_tpu.index.bruteforce import BruteForceIndex

    t0 = time.time()
    bf = BruteForceIndex(base, chunk=1_000_000)
    _, gt = bf.search(queries, k=10)
    print(f"brute-force GT over 8M: {time.time()-t0:.0f}s", flush=True)
    del bf
    gc.collect()
    write_ivecs(gt_path, np.asarray(gt, np.int32))
    return gt


def main():
    mode = sys.argv[1] if len(sys.argv) > 1 else "gpu"
    if mode == "mesh":  # must precede backend init (first jnp array use)
        os.environ["XLA_FLAGS"] = (
            os.environ.get("XLA_FLAGS", "")
            + " --xla_force_host_platform_device_count=8"
        )
    import jax

    from hnsw_slim_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    if mode == "mesh":
        jax.config.update("jax_platforms", "cpu")

    from hnsw_slim_tpu.config import SearchConfig
    from hnsw_slim_tpu.utils.data import clustered
    from hnsw_slim_tpu.utils.io import read_fvecs

    t0 = time.time()
    base, _ = clustered(N, DIM, n_queries=0, n_clusters=N // 1000,
                        seed=7, scale=0.3)
    queries = read_fvecs(f"{OUT}/queries.fvecs")[:NQ]
    print(f"data: {time.time()-t0:.0f}s", flush=True)
    gt = ground_truth(base, queries)
    shards = load_shards(base)
    del base
    gc.collect()

    if mode in ("gpu", "bf16"):
        from hnsw_slim_tpu.parallel.flat_union import FlatUnionIndex

        t0 = time.time()
        uni = FlatUnionIndex.from_indexes(
            shards, search_cfg=SearchConfig(
                ef=64, straggler_stages=(4, 16), pop_width=8
            ),
            store_dtype="bfloat16" if mode == "bf16" else "float32",
        )
        for idx, _ in shards:  # free per-shard device copies
            idx.vectors = idx.vn = idx.graph = None
        gc.collect()
        print(f"union assembly: {time.time()-t0:.0f}s  "
              f"graph {uni.index_size()/1e6:.1f} MB  "
              f"HBM {uni.hbm_bytes()/1e9:.2f} GB", flush=True)
        results = {}
        import dataclasses

        for ef in (32, 64, 96, 128):
            # serve-time calibration on THIS graph (the 1M bench's hand
            # knobs dropped union recall 0.999->0.78 before autotune)
            tune = uni.autotune(ef)
            print(f"  autotune ef={ef}: {tune['knobs']}", flush=True)
            _, ids = uni.search(queries, k=10)  # compile + warm
            times = []
            for _ in range(3):
                t1 = time.perf_counter()
                uni.search(queries, k=10)
                times.append(time.perf_counter() - t1)
            r = recall(ids, gt)
            qps = NQ / min(times)
            results[ef] = (r, qps)
            print(f"union ef={ef}: recall@10={r:.4f} qps={qps:.0f}",
                  flush=True)
        print(json.dumps({
            "mode": f"union_8m_{mode}", "hbm_gb": uni.hbm_bytes() / 1e9,
            "graph_mb": uni.index_size() / 1e6,
            "points": {str(e): [round(r, 4), round(q)]
                       for e, (r, q) in results.items()},
        }), flush=True)
    else:
        from jax.sharding import Mesh

        from hnsw_slim_tpu.parallel.sharded import ShardedSlimIndex

        devs = np.array(jax.devices("cpu")[:8]).reshape(8, 1)
        mesh = Mesh(devs, ("shard", "dp"))
        scfg = SearchConfig(ef=64, straggler_stages=(4, 16), pop_width=8)
        idx = ShardedSlimIndex.from_indexes(mesh, shards, search_cfg=scfg)
        # same dense serving layouts as single-chip (r4: dense_up/rank_up
        # threaded through _sharded_search_jit)
        extra = idx.densify_level0() + idx.densify_upper()
        print(f"mesh dense layouts: +{extra/1e6:.0f} MB", flush=True)
        nq = 128
        _, ids = idx.search(queries[:nq], k=10)  # compile + warm
        t1 = time.perf_counter()
        d, ids = idx.search(queries[:nq], k=10)
        dt = time.perf_counter() - t1
        r = recall(ids, gt[:nq])

        # mesh == flat parity AT 8M: per-shard searches merged on the host
        # must reproduce the all_gather merge's results (same kernel knobs)
        flat_d, flat_i = [], []
        t2 = time.perf_counter()
        for sub, gids in shards:
            sub.scfg = scfg
            sd, sids = sub.search(queries[:nq], k=10)
            flat_d.append(np.asarray(sd))
            flat_i.append(np.where(np.asarray(sids) >= 0,
                                   gids[np.maximum(np.asarray(sids), 0)], -1))
        dt_flat = time.perf_counter() - t2
        cat_d = np.concatenate(flat_d, axis=1)
        cat_i = np.concatenate(flat_i, axis=1)
        order = np.argsort(cat_d, axis=1, kind="stable")[:, :10]
        ref_d = np.take_along_axis(cat_d, order, axis=1)
        ref_i = np.take_along_axis(cat_i, order, axis=1)
        np.testing.assert_allclose(np.asarray(d), ref_d, rtol=1e-5, atol=1e-5)
        mism = sum(
            0 if set(rm.tolist()) == set(rf.tolist())
            or np.allclose(dm, df, rtol=1e-5, atol=1e-5) else 1
            for rm, rf, dm, df in zip(ids, ref_i, d, ref_d)
        )
        print(json.dumps({
            "mode": "cpu_mesh_8m", "recall": round(r, 4),
            "qps_cpu_mesh": round(nq / dt), "n_queries": nq,
            "parity_mismatch_rows": int(mism),
            "mesh_s": round(dt, 2), "flat_per_shard_sum_s": round(dt_flat, 2),
        }), flush=True)


if __name__ == "__main__":
    main()
