"""16M single-chip bf16 serving — the closest Table-7 analog one chip allows
(VERDICT r4 item 7).

Corpus: the 8M clustered set (seed 7, shards8m/) plus a second independently
drawn 8M set (seed 11, shards8m_b/ via SHARDS_SEED=11 SHARDS_OUT=...
build_8m_shards.py) — 16 reference-built 1M slim shards served as ONE
FlatUnionIndex with a bfloat16 vector store (the measured-at-1M recipe:
halved vector HBM at ~0.01 recall cost, README bf16 table).

HBM accounting printed per run: bf16 vectors (16M x 256 B = 4.1 GB) + CHAL
graph (~0.93 GB) + norms; the dense level-0 layout (i32[N, 64] = 4.1 GB)
is optional via SV16_DENSE0=1 — both fit one card, but the default matches
the Table-7 budget posture (graph + vectors only).

Queries: 512 from each seed's distribution; GT: device brute force over the
16M union (cached).

Usage: python scripts/serve_16m.py  (from the repository root)
"""

import gc
import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

NH, DIM, S, NQ = 8_000_000, 128, 8, 1024
OUT_A = os.path.join(REPO, ".bench_cache/shards8m")
OUT_B = os.path.join(REPO, ".bench_cache/shards8m_b")
GT_PATH = os.path.join(REPO, ".bench_cache/gt16m.ivecs")


def recall(ids, gt):
    return sum(len(set(a.tolist()) & set(b.tolist()))
               for a, b in zip(ids, gt)) / gt.size


def main():
    from hnsw_slim_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    from hnsw_slim_tpu.config import SearchConfig
    from hnsw_slim_tpu.graph.import_ref import slim_index_from_ref
    from hnsw_slim_tpu.index.bruteforce import exact_topk
    from hnsw_slim_tpu.parallel.flat_union import FlatUnionIndex
    from hnsw_slim_tpu.utils.data import clustered
    from hnsw_slim_tpu.utils.io import read_ivecs, write_ivecs

    t0 = time.time()
    # file-backed corpus cache: regeneration is ~5 min of host RNG each run
    # and one round-5 run degenerated into a kernel page-zeroing storm
    # (minor-fault churn, ~20x slowdown); mmap'd npy reads sidestep both
    cdir = os.path.join(REPO, ".bench_cache/corpus16m")
    os.makedirs(cdir, exist_ok=True)
    if not os.path.exists(f"{cdir}/q.npy"):
        base_a, q_a = clustered(NH, DIM, n_queries=NQ // 2,
                                n_clusters=NH // 1000, seed=7, scale=0.3)
        np.save(f"{cdir}/base_a.npy", base_a)
        base_b, q_b = clustered(NH, DIM, n_queries=NQ // 2,
                                n_clusters=NH // 1000, seed=11, scale=0.3)
        np.save(f"{cdir}/base_b.npy", base_b)
        np.save(f"{cdir}/q.npy", np.concatenate([q_a, q_b]))
        del base_a, base_b, q_a, q_b
        gc.collect()
    base_a = np.load(f"{cdir}/base_a.npy", mmap_mode="r")
    base_b = np.load(f"{cdir}/base_b.npy", mmap_mode="r")
    queries = np.load(f"{cdir}/q.npy")
    print(f"data: {time.time()-t0:.0f}s", flush=True)

    def load_npz_shard(path, vecs):
        """Host-side npz shard (self-built set, build_8m_shards_self.py):
        a ChalGraph over numpy arrays — FlatUnionIndex assembly reads
        host arrays, so no per-shard device upload."""
        import json as _json
        import types

        from hnsw_slim_tpu.graph.types import ChalGraph

        with np.load(path) as z:
            meta = _json.loads(bytes(z["meta"].tobytes()).decode())
            g = ChalGraph(
                nbr=z["nbr"], lvl_off=z["lvl_off"], level=z["level"],
                entry=np.int32(meta["entry"]), max_level=meta["max_level"],
                threshold_level=meta["threshold_level"],
                cap0=meta["cap0"], cap=meta["cap"],
            )
        return types.SimpleNamespace(graph=g, vectors=vecs)

    shards = []
    for out, base, off in ((OUT_A, base_a, 0), (OUT_B, base_b, NH)):
        for si in range(S):
            gids = np.arange(si, NH, S, dtype=np.int64) + off
            t1 = time.time()
            gpath = f"{out}/shard{si}.slimgraph"
            if os.path.exists(gpath):
                idx = slim_index_from_ref(gpath, base[si::S], upload=False)
            else:
                idx = load_npz_shard(f"{out}/shard{si}.npz", base[si::S])
            print(f"{out.rsplit('/', 1)[1]}/shard{si}: {time.time()-t1:.0f}s",
                  flush=True)
            shards.append((idx, gids.astype(np.int64)))
    del base_a, base_b
    gc.collect()

    t0 = time.time()
    uni = FlatUnionIndex.from_indexes(
        shards,
        search_cfg=SearchConfig(ef=64, straggler_stages=(4, 16), pop_width=8),
        store_dtype="bfloat16",
    )
    for idx, _ in shards:
        idx.vectors = idx.vn = idx.graph = None
    gc.collect()
    if os.environ.get("SV16_DENSE0") == "1":
        extra = uni.densify_level0()
        print(f"dense0: +{extra/1e9:.2f} GB", flush=True)
    print(f"union assembly: {time.time()-t0:.0f}s  "
          f"graph {uni.index_size()/1e6:.1f} MB  "
          f"HBM {uni.hbm_bytes()/1e9:.2f} GB", flush=True)

    if os.path.exists(GT_PATH):
        gt = read_ivecs(GT_PATH)
    else:
        t0 = time.time()
        _, gt = exact_topk(uni.vectors, uni.vn, queries, k=10, metric="l2",
                           n_valid=int(uni.vectors.shape[0]))
        gt = np.asarray(uni.gids)[np.asarray(gt)] if hasattr(uni, "gids") \
            else np.asarray(gt)
        write_ivecs(GT_PATH, gt.astype(np.int32))
        print(f"brute-force GT over 16M: {time.time()-t0:.0f}s", flush=True)

    import dataclasses

    results = {}
    for mode, seed in (("seed32", 32), ("rep", 0)):
        # seeded: ONE query instance + shard-stratified exact seeds over
        # the union upper layer (2 per shard at seed=32/S=16); rep: the
        # S-way per-shard replication fallback (S x the search work)
        uni._autotune_cache = {}
        uni.scfg = dataclasses.replace(uni.scfg, seed_width=seed)
        for ef in (32, 64, 96):
            uni.scfg = dataclasses.replace(uni.scfg, ef=ef)
            tune = uni.autotune(ef)
            print(f"  autotune {mode} ef={ef}: {tune['knobs']}", flush=True)
            uni.scfg = dataclasses.replace(
                uni.scfg, **tune["knobs"], seed_width=seed)
            _, ids = uni.search(queries, k=10)
            times = []
            for _ in range(3):
                t1 = time.perf_counter()
                uni.search(queries, k=10)
                times.append(time.perf_counter() - t1)
            r = recall(np.asarray(ids), gt)
            qps = NQ / min(times)
            results[f"{mode}_{ef}"] = (round(r, 4), round(qps))
            print(f"16m bf16 union {mode} ef={ef}: recall@10={r:.4f} "
                  f"qps={qps:.0f}", flush=True)
    print(json.dumps({
        "mode": "union_16m_bf16", "hbm_gb": uni.hbm_bytes() / 1e9,
        "graph_mb": uni.index_size() / 1e6,
        "points": {k: list(v) for k, v in results.items()},
    }), flush=True)


if __name__ == "__main__":
    main()
