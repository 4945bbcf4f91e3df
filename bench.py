"""Benchmark entry point (one GPU).

Headline metric (ROADMAP north star, reference Table 5): batched-search QPS
at the smallest ef reaching recall@10 >= 0.95 on a synthetic clustered
dataset (SIFT-like: 1M x 128-d), against the LIVE reference C++ engine:

* parity/ref_harness compiles the unmodified reference headers and runs the
  same ef sweep on the same data on this machine's CPU, using every core the
  host has (recorded as baseline_threads so the comparison is auditable;
  the reference paper's 24-core serving numbers are in BASELINE.md Table 5
  for context).
* The engine serves the reference's own exported slim graph, so the ratio
  isolates search-engine throughput on an identical index.
* vs_baseline = qps@0.95 / reference_cpu_qps@0.95.

Secondary fields keep the matched-ef64 comparison (same graph + same ef =
identical traversal frontier) and the engine's effort counters (hops /
distance computations / bytes gathered) so perf progress is attributable.

Refuses to run on any backend but a GPU. The reference graph and its sweep
results are cached in .bench_cache/; compiled programs in the persistent
compile cache (utils/compile_cache.py).

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", "device",
...}.
"""

import json
import os
import subprocess
import sys
import time

N = int(os.environ.get("BENCH_N", 1_000_000))
DIM = int(os.environ.get("BENCH_DIM", 128))
NQ = int(os.environ.get("BENCH_NQ", 4096))
PAPER_BASELINE_QPS = 4450.0  # Table 5 client interp @95% (BASELINE.md)
REPO = os.path.dirname(os.path.abspath(__file__))
EFS = [32, 48, 64, 80, 96, 128, 192, 256, 320, 384, 512]
TARGET = float(os.environ.get("BENCH_TARGET_RECALL", 0.95))
# exact-seed width: the upper levels are replaced by ONE fused distance
# matmul over all level>=1 nodes (~N/16 rows on the reference graph) whose
# top-SEED results seed the base beam, instead of pointer-chasing them
SEED_WIDTH = int(os.environ.get("BENCH_SEED_WIDTH", 32))
try:
    HOST_CORES = len(os.sched_getaffinity(0))
except AttributeError:
    HOST_CORES = os.cpu_count() or 1


def log(msg):
    print(f"# {msg}", file=sys.stderr, flush=True)


def recall(ids, gt):
    return sum(
        len(set(a.tolist()) & set(b.tolist())) for a, b in zip(ids, gt)
    ) / gt.size


def build_harness():
    r = subprocess.run(
        ["make", "-C", os.path.join(REPO, "parity")], capture_output=True,
        timeout=900,
    )
    binary = os.path.join(REPO, "parity", "ref_harness")
    return binary if r.returncode == 0 and os.path.exists(binary) else None


def pick_point(points, target):
    """Smallest-ef point with recall >= target, else the highest-recall one."""
    hit = [p for p in points if p["recall"] >= target]
    if hit:
        return min(hit, key=lambda p: p["ef"]), True
    return (max(points, key=lambda p: p["recall"]), False) if points else (None, False)


def main():
    import jax

    dev = jax.devices()[0]
    if jax.default_backend() != "gpu" or dev.platform != "gpu":
        sys.exit(f"bench.py: needs a GPU; JAX's backend is "
                 f"{jax.default_backend()!r}")
    device = {"platform": dev.platform, "kind": dev.device_kind,
              "count": len(jax.devices())}

    from hnsw_slim_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    from hnsw_slim_tpu.graph.import_ref import slim_index_from_ref
    from hnsw_slim_tpu.index.bruteforce import BruteForceIndex
    from hnsw_slim_tpu.utils.data import clustered
    from hnsw_slim_tpu.utils.io import read_ivecs, write_fvecs

    log(f"device={device} n={N} dim={DIM} nq={NQ} host_cores={HOST_CORES}")
    # scale=0.3 calibrated so the recall@10-vs-ef curve matches real SIFT-like
    # behavior (0.95 crossing near ef 128-256 at 1M with M=30): scale 0.15
    # gives near-disconnected cluster islands where NO ef reaches 0.95 (round-1
    # probe: 0.91 at ef=512), scale >=0.45 is trivially easy (1.0 at ef=64).
    base, queries = clustered(
        N, DIM, n_queries=NQ, n_clusters=max(64, N // 1000), seed=7, scale=0.3
    )

    cdir = os.path.join(REPO, ".bench_cache")
    os.makedirs(cdir, exist_ok=True)
    tag = f"ref_{N}_{DIM}_{NQ}_v3"
    gpath = os.path.join(cdir, tag + ".slimgraph")
    spath = os.path.join(cdir, tag + ".json")

    harness = build_harness()
    ref = {}
    if harness and not (os.path.exists(gpath) and os.path.exists(spath)):
        bp = os.path.join(cdir, tag + "_b.fvecs")
        qp = os.path.join(cdir, tag + "_q.fvecs")
        rp = os.path.join(cdir, tag + "_r.ivecs")
        write_fvecs(bp, base)
        write_fvecs(qp, queries)
        out = subprocess.run(
            [harness, bp, qp, rp, "slim", "30", "128",
             ",".join(map(str, EFS)), "10", str(HOST_CORES), gpath],
            capture_output=True, text=True, timeout=7200,
        )
        if out.returncode == 0:
            stats = dict(
                l.split() for l in out.stdout.strip().splitlines()
                if len(l.split()) == 2
            )
            ref = {
                "build_ms": float(stats["build_ms"]),
                "convert_ms": float(stats["convert_ms"]),
                "index_bytes": int(stats["slim_index_bytes"]),
                "threads": HOST_CORES,
                "solve_ms": {
                    e: float(stats[f"solve_ms_ef{e}"]) for e in EFS
                    if f"solve_ms_ef{e}" in stats
                },
                "result_files": {e: f"{rp}.ef{e}" for e in EFS},
            }
            json.dump(ref, open(spath, "w"))
        else:
            log(f"reference harness failed: {out.stderr[-200:]}")
        for p in (bp, qp):  # the 512MB fvecs are regenerable; don't hoard
            if os.path.exists(p) and N >= 500_000:
                os.remove(p)
    elif os.path.exists(spath):
        ref = json.load(open(spath))
        ref["solve_ms"] = {int(k): v for k, v in ref["solve_ms"].items()}
        ref["result_files"] = {int(k): v for k, v in ref["result_files"].items()}

    bf = BruteForceIndex(base)
    _, gt = bf.search(queries, k=10)

    ref_points = []
    for e in sorted(ref.get("solve_ms", {})):
        try:
            ids = read_ivecs(ref["result_files"][e])
        except FileNotFoundError:
            continue
        r = recall(ids, gt)
        q = NQ / (ref["solve_ms"][e] / 1e3)
        log(f"reference ef={e}: recall={r:.4f} qps={q:.0f} "
            f"({ref.get('threads', 1)}-thread CPU)")
        ref_points.append({"ef": e, "recall": r, "qps": q})

    # the engine serves the reference-built graph (identical index)
    if ref and os.path.exists(gpath):
        idx = slim_index_from_ref(gpath, base)
        if os.environ.get("BENCH_DENSE0", "1") == "1":
            extra = idx.densify_level0()
            extra += idx.densify_upper()
            log(f"dense serving layouts (+{extra/1e6:.0f} MB HBM)")
        log(f"serving reference-built graph ({idx.index_size()} bytes)")
    else:
        from hnsw_slim_tpu.config import HnswConfig, SlimConfig
        from hnsw_slim_tpu.index.hnsw import HnswIndex
        from hnsw_slim_tpu.index.slim import HnswSlimIndex

        t0 = time.perf_counter()
        h = HnswIndex(HnswConfig(M=30, ef_construction=128), strategy="nnd")
        h.build(base)
        idx = HnswSlimIndex.from_hnsw(h, SlimConfig.from_ratios())
        log(f"nnd build {time.perf_counter() - t0:.1f}s")

    points = []
    stats_at = {}
    import dataclasses
    idx.scfg = dataclasses.replace(
        idx.scfg, straggler_stages=(2, 8, 32), seed_width=SEED_WIDTH
    )
    for ef in EFS:
        # per-graph serve-time calibration (replaces the r2 hand-tuned per-ef
        # knob table, which was overfit to this graph and non-monotone in ef)
        tune = idx.autotune(ef)
        log(f"autotune ef={ef}: {tune['knobs']} "
            f"probe_recall={tune['probe_recall']:.4f}")
        idx.set_ef(ef)
        _, ids = idx.search(queries, k=10)  # compile + warm
        # search() returns host arrays, so each timed call ends in a sync
        dt = min(_timed(idx.search, queries) for _ in range(3))
        r = recall(ids, gt)
        qps = NQ / dt
        log(f"ef={ef}: recall={r:.4f} qps={qps:.0f} "
            f"hops={idx.last_stats['hops']} dcomp={idx.last_stats['distance_computations']}")
        points.append({"ef": ef, "recall": r, "qps": qps})
        stats_at[ef] = dict(idx.last_stats)
        if r >= TARGET:
            break

    best, hit = pick_point(points, TARGET)
    ref_best, ref_hit = pick_point(ref_points, TARGET)
    ef64 = next((p for p in points if p["ef"] == 64), None)
    ref64 = next((p for p in ref_points if p["ef"] == 64), None)

    baseline_qps = ref_best["qps"] if ref_best else PAPER_BASELINE_QPS
    st = stats_at.get(best["ef"], {})
    out = {
        "metric": f"qps@recall{TARGET}_synth{N//1000}k_d{DIM}",
        "device": device,
        "value": round(best["qps"], 1),
        "unit": "qps",
        "vs_baseline": round(best["qps"] / baseline_qps, 3),
        "baseline": (
            f"reference-c++-{ref.get('threads', 1)}core-same-graph"
            if ref_best else "paper-table5-interpolated"
        ),
        "baseline_qps": round(baseline_qps, 1),
        "baseline_threads": ref.get("threads", None),
        "host_cpu_cores": HOST_CORES,
        "recall": round(best["recall"], 4),
        "recall_target_reached": bool(hit),
        "baseline_recall": round(ref_best["recall"], 4) if ref_best else None,
        "baseline_recall_target_reached": bool(ref_hit),
        "ef": best["ef"],
        "matched_ef64_qps": round(ef64["qps"], 1) if ef64 else None,
        "matched_ef64_recall": round(ef64["recall"], 4) if ef64 else None,
        "matched_ef64_vs_baseline": (
            round(ef64["qps"] / ref64["qps"], 3) if ef64 and ref64 else None
        ),
        "hops": st.get("hops"),
        "distance_computations": st.get("distance_computations"),
        "bytes_gathered": (
            st.get("distance_computations", 0) * DIM * 4 or None
        ),
        "ref_build_ms": ref.get("build_ms"),
        "index_bytes": int(idx.index_size()),
        "n": N,
        "dim": DIM,
        "batch": NQ,
        "seed_width": SEED_WIDTH,
    }
    print(json.dumps(out))


def _timed(search_fn, queries):
    t0 = time.perf_counter()
    search_fn(queries, k=10)
    return time.perf_counter() - t0


if __name__ == "__main__":
    main()
