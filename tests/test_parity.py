"""Head-to-head parity against the ACTUAL reference C++ engine.

Builds parity/ref_harness (compiles the unmodified reference headers), runs
its slim build+search on shared data, then serves the exported graph with the
JAX engine: result sets must match and index-size accounting must be
byte-exact. Skips if the harness cannot build.
"""

import subprocess
from pathlib import Path

import numpy as np
import pytest

from hnsw_slim_tpu.graph.import_ref import slim_index_from_ref
from hnsw_slim_tpu.index.bruteforce import BruteForceIndex
from hnsw_slim_tpu.utils.data import clustered
from hnsw_slim_tpu.utils.io import read_ivecs, write_fvecs

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def harness():
    r = subprocess.run(["make", "-C", str(REPO / "parity")],
                       capture_output=True, timeout=300)
    binary = REPO / "parity" / "ref_harness"
    if r.returncode != 0 or not binary.exists():
        pytest.skip(f"reference harness unavailable: {r.stderr[-300:]}")
    return str(binary)


def test_same_graph_same_results(harness, tmp_path):
    base, queries = clustered(6000, 48, n_queries=100, seed=123)
    bp, qp = tmp_path / "b.fvecs", tmp_path / "q.fvecs"
    write_fvecs(bp, base)
    write_fvecs(qp, queries)
    rp = tmp_path / "r.ivecs"
    gp = tmp_path / "g.slimgraph"
    out = subprocess.run(
        [harness, str(bp), str(qp), str(rp), "slim", "30", "128", "64", "10",
         "1", str(gp)],
        capture_output=True, text=True, timeout=600,
    )
    assert out.returncode == 0, out.stderr[-300:]
    stats = dict(l.split() for l in out.stdout.strip().splitlines()
                 if len(l.split()) == 2)
    ref_ids = read_ivecs(rp)

    idx = slim_index_from_ref(str(gp), base)
    idx.check_integrity()
    # byte-exact index size accounting (hnswalg_slim.h indexSize)
    assert idx.index_size() == int(stats["slim_index_bytes"])

    idx.set_ef(64)
    _, ours = idx.search(queries, k=10)
    overlap = np.mean([
        len(set(a.tolist()) & set(b.tolist())) / 10
        for a, b in zip(ours, ref_ids)
    ])
    assert overlap >= 0.97, overlap  # same graph -> near-identical results

    # and both must be high-recall against exact ground truth
    bf = BruteForceIndex(base, chunk=1024)
    _, gt = bf.search(queries, k=10)
    r_ref = sum(len(set(a.tolist()) & set(b.tolist()))
                for a, b in zip(ref_ids, gt)) / gt.size
    r_ours = sum(len(set(a.tolist()) & set(b.tolist()))
                 for a, b in zip(ours, gt)) / gt.size
    assert r_ours >= r_ref - 0.01, (r_ours, r_ref)


def test_slimzero_head_to_head_50k(harness, tmp_path):
    """SlimZero guard regression at scale: run the
    reference HierarchicalNSWSlimZero (hnswalg_slimzero.h:820-894) at 50k,
    convert the SAME vanilla graph with our adaptive chunk-ordered guard
    (graph/prune.py convert_to_slimzero), and require our recall to be at
    least the reference's at every matched ef. 50k is in the regime where a
    snapshot-only guard collapses (the motivation for the adaptive rewrite);
    the absolute floor pins that regression."""
    from hnsw_slim_tpu.config import SlimConfig
    from hnsw_slim_tpu.graph.import_ref import hnsw_index_from_ref
    from hnsw_slim_tpu.index.slimzero import HnswSlimZeroIndex

    n = 50_000
    base, queries = clustered(n, 64, n_queries=200, n_clusters=n // 1000,
                              seed=7, scale=0.3)
    bp, qp = tmp_path / "b.fvecs", tmp_path / "q.fvecs"
    write_fvecs(bp, base)
    write_fvecs(qp, queries)
    rp, gp = tmp_path / "r.ivecs", tmp_path / "g.szgraph"
    out = subprocess.run(
        [harness, str(bp), str(qp), str(rp), "slimzero", "30", "128",
         "64,128", "10", "1", str(gp)],
        capture_output=True, text=True, timeout=1200,
    )
    assert out.returncode == 0, out.stderr[-300:]

    bf = BruteForceIndex(base, chunk=4096)
    _, gt = bf.search(queries, k=10)
    gt_sets = [set(r.tolist()) for r in np.asarray(gt)]

    def recall(ids):
        return sum(len(set(a.tolist()) & s)
                   for a, s in zip(ids, gt_sets)) / gt.size

    ref_rec = {ef: recall(read_ivecs(f"{rp}.ef{ef}")) for ef in (64, 128)}

    hv = hnsw_index_from_ref(str(gp) + ".hnsw", base)
    ours = HnswSlimZeroIndex.from_hnsw(hv, SlimConfig.from_ratios())
    our_rec = {}
    for ef in (64, 128):
        ours.set_ef(ef)
        _, ids = ours.search(queries, k=10)
        our_rec[ef] = recall(np.asarray(ids))

    for ef in (64, 128):
        assert our_rec[ef] >= ref_rec[ef] - 0.02, (ef, our_rec, ref_rec)
    # absolute guard floor: a snapshot-only guard measured ~0.01 here
    assert our_rec[64] >= 0.40, our_rec
