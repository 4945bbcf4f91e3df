"""Update-latency benchmark: /updateIndex semantics at reference scale.

Reference Table 4 (BASELINE.md:54-61): the C++ server completes 1000-vector
update batches in 1.4-7.9 s at 1-8M scale (insert + full convertFromHNSW
re-prune + changed-node diff, hnsw_slim_server.cc:115-142). This measures the
same pipeline here: reference-built 1M vanilla graph imported as the mutable
serving state, one 1000-vector batch through SlimServer.update_index.

Usage: python scripts/bench_update.py  (from the repository root)
"""

import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def main():
    from hnsw_slim_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    from hnsw_slim_tpu.graph.import_ref import hnsw_index_from_ref
    from hnsw_slim_tpu.persist.checkpoint import load_hnsw, save_hnsw
    from hnsw_slim_tpu.serve.server import SlimServer
    from hnsw_slim_tpu.utils.data import clustered

    N, DIM = int(os.environ.get("UPD_N", 1_000_000)), 128
    BATCH = int(os.environ.get("UPD_BATCH", 1000))
    TRIALS = int(os.environ.get("UPD_TRIALS", 3))
    g = os.path.join(REPO, f".bench_cache/ref_{N}_128_1024_v3.slimgraph.hnsw")
    # base MUST be byte-identical to bench.py's stream (the reference graph
    # was built on it): clustered(n) with a different n shifts the rng stream
    # and yields entirely different points — drawing N+TRIALS*BATCH here once
    # poisoned the npz cache (vectors from the wrong dataset paired with the
    # reference graph; recall 0.006 downstream). Update batches come from an
    # independent seed instead.
    base, _ = clustered(N, DIM, n_queries=0,
                        n_clusters=max(64, N // 1000), seed=7, scale=0.3)
    # update batches REUSE the base's cluster centers (same seed draws the
    # centers first, so a different n only changes the point noise): the
    # Table-4 workload re-inserts same-distribution points. Drawing NEW
    # centers instead (an out-of-distribution stream) is adversarial for
    # ANY insertion heuristic: the RNG rule keeps only ~4 of the exact
    # top-128 for such points (measured), reference semantics included.
    extra_base, _ = clustered(TRIALS * BATCH, DIM, n_queries=0,
                              n_clusters=max(64, N // 1000), seed=7,
                              scale=0.3)
    base = np.concatenate([base, extra_base])
    t0 = time.perf_counter()
    npz = g + ".npz"  # parsed-import cache (the binary parse costs ~17 min)
    if os.path.exists(npz):
        idx = load_hnsw(npz)
    else:
        idx = hnsw_index_from_ref(g, base[:N])
        save_hnsw(npz, idx)
    print(f"import 1M hnsw graph: {time.perf_counter()-t0:.1f}s", flush=True)

    t0 = time.perf_counter()
    server = SlimServer(idx)  # initial slim conversion (convertFromHNSW)
    print(f"initial slim convert: {time.perf_counter()-t0:.1f}s", flush=True)

    for trial in range(TRIALS):
        batch = base[N + trial * BATCH : N + (trial + 1) * BATCH]
        t0 = time.perf_counter()
        writer = server.update_index(batch)
        dt = time.perf_counter() - t0
        blob, finished = writer.next_chunk(1 << 30)
        print(f"update batch {trial}: {dt:.2f}s for {BATCH} vectors "
              f"(patch {len(blob)/1e6:.1f} MB, finished={finished}) — "
              f"reference Table 4 @1M: 1.4s", flush=True)

    # post-update serving correctness (the host-resident CHAL + dense
    # layouts must serve the updated graph, not a stale one)
    from hnsw_slim_tpu.index.bruteforce import exact_topk

    slim = server.slim
    ins = base[N : N + TRIALS * BATCH]
    nq = min(1024, len(ins))
    slim.set_ef(128)
    _, ids = slim.search(ins[:nq], k=1)
    self_hit = float((np.asarray(ids)[:, 0] == N + np.arange(nq)).mean())
    # self-hit tracks the graph's recall(ef) curve (a probe exactly on an
    # inserted point is just a recall@1 query); report the headline ef too
    slim.set_ef(384)
    _, ids384 = slim.search(ins[:nq], k=1)
    self_hit384 = float(
        (np.asarray(ids384)[:, 0] == N + np.arange(nq)).mean())
    rng = np.random.default_rng(5)
    qs = (base[rng.integers(0, N, 256)]
          + rng.normal(size=(256, DIM)).astype(np.float32) * 0.05)
    _, gt = exact_topk(slim.vectors, slim.vn, qs, k=10, metric="l2",
                       n_valid=slim.graph.n)
    slim.set_ef(384)
    _, got = slim.search(qs, k=10)
    gt, got = np.asarray(gt), np.asarray(got)
    rec = sum(len(set(a.tolist()) & set(b.tolist()))
              for a, b in zip(got, gt)) / gt.size
    print(f"post-update: self-hit@1(ef=128)={self_hit:.4f} "
          f"self-hit@1(ef=384)={self_hit384:.4f} "
          f"recall@10(ef=384)={rec:.4f}", flush=True)


if __name__ == "__main__":
    main()
