"""End-to-end: batched HNSW build -> search -> recall vs brute force."""

import numpy as np
import pytest

from hnsw_slim_tpu.config import HnswConfig
from hnsw_slim_tpu.graph.build import sample_levels
from hnsw_slim_tpu.index.bruteforce import BruteForceIndex
from hnsw_slim_tpu.index.hnsw import HnswIndex
from hnsw_slim_tpu.utils.data import clustered


def test_sample_levels_distribution():
    lv = sample_levels(200000, mult=1.0 / np.log(32.0), seed=0)
    frac1 = (lv >= 1).mean()
    assert abs(frac1 - 1 / 32) < 0.005  # geometric with p = 1/32
    assert lv.min() == 0


def test_hnsw_build_search_recall():
    base, queries = clustered(n=5000, dim=32, n_queries=100, seed=11)
    cfg = HnswConfig(M=16, ef_construction=100, ef_search=64, branching_factor="32")
    idx = HnswIndex(cfg, max_batch=512)
    idx.build(base)

    stats = idx.check_integrity()
    assert stats["connections"] > 0

    bf = BruteForceIndex(base, chunk=1024)
    _, gt = bf.search(queries, k=10)
    d, ids = idx.search(queries, k=10)
    hits = sum(len(set(a.tolist()) & set(b.tolist())) for a, b in zip(ids, gt))
    recall = hits / gt.size
    assert recall >= 0.95, recall

    # distances must be true distances of returned ids
    valid = ids >= 0
    true_d = ((queries[:, None, :] - base[np.maximum(ids, 0)]) ** 2).sum(-1)
    np.testing.assert_allclose(d[valid], true_d[valid], rtol=1e-3, atol=1e-3)


def test_insert_build_adjacency_invariants():
    """The bulk insertion build runs entirely on device (one fused
    apply_insert per batch/level, graph/revconn.py) with a degree array
    driving reverse-append columns — a rank/column bug there would write
    duplicate or out-of-range edges without failing a recall test. Assert
    after a build that exercises both the append and the overflow-re-prune
    paths: no duplicate ids within any row, no self-loops, all ids in
    range, deg == row occupancy, edges left-packed, inactive rows -1, and
    the end-of-build host mirror equals the device adjacency."""
    from hnsw_slim_tpu.graph.build import HnswBuilder

    base, _ = clustered(n=3000, dim=16, n_queries=1, seed=3)
    b = HnswBuilder(HnswConfig(M=8, ef_construction=48), max_batch=256)
    g, levels = b.build(base)
    n = len(base)
    for lvl, dev in enumerate(g.adjs):
        adj = np.asarray(dev)
        act = levels >= lvl
        np.testing.assert_array_equal(
            adj, b.adj_np[lvl],
            err_msg=f"host mirror pull diverged at level {lvl}",
        )
        assert (adj[~act] == -1).all(), "inactive rows must stay -1"
        rows = adj[act]
        assert rows.min() >= -1 and rows.max() < n
        assert (rows != np.nonzero(act)[0][:, None]).all(), "self-loop"
        # left-packed: a -1 lane is never followed by a valid lane
        occ = rows >= 0
        assert (occ[:, 1:] <= occ[:, :-1]).all(), "row not left-packed"
        deg = np.asarray(b._deg_dev[lvl])[act]
        np.testing.assert_array_equal(deg, occ.sum(axis=1))
        # no duplicate edges within a row
        s = np.sort(np.where(occ, rows, 2**30 + np.arange(len(rows))[:, None]
                             * 64 + np.arange(rows.shape[1])[None]), axis=1)
        assert (s[:, 1:] != s[:, :-1]).all(), "duplicate edge in a row"


def test_hnsw_ip_metric():
    base, queries = clustered(n=2000, dim=24, n_queries=50, seed=12)
    # normalize for a meaningful IP space
    base /= np.linalg.norm(base, axis=1, keepdims=True)
    queries /= np.linalg.norm(queries, axis=1, keepdims=True)
    cfg = HnswConfig(M=16, ef_construction=100, ef_search=64, metric="ip")
    idx = HnswIndex(cfg, max_batch=512)
    idx.build(base)
    bf = BruteForceIndex(base, metric="ip", chunk=1024)
    _, gt = bf.search(queries, k=10)
    _, ids = idx.search(queries, k=10)
    hits = sum(len(set(a.tolist()) & set(b.tolist())) for a, b in zip(ids, gt))
    assert hits / gt.size >= 0.9


def test_bf16_storage_recall():
    base, queries = clustered(n=3000, dim=32, n_queries=50, seed=13)
    cfg = HnswConfig(M=16, ef_construction=100, ef_search=64,
                     store_dtype="bfloat16")
    idx = HnswIndex(cfg, max_batch=512)
    idx.build(base)
    import jax.numpy as jnp
    assert idx.vectors.dtype == jnp.bfloat16
    bf = BruteForceIndex(base, chunk=1024)
    _, gt = bf.search(queries, k=10)
    _, ids = idx.search(queries, k=10)
    hits = sum(len(set(a.tolist()) & set(b.tolist())) for a, b in zip(ids, gt))
    assert hits / gt.size >= 0.93, hits / gt.size


def test_degenerate_duplicates_and_zeros():
    # many exact duplicates + zero vectors must not break build or search
    rng = np.random.default_rng(15)
    uniq = rng.standard_normal((300, 16)).astype(np.float32)
    base = np.concatenate([
        uniq,
        np.repeat(uniq[:50], 5, axis=0),  # 250 duplicates
        np.zeros((20, 16), np.float32),
    ])
    idx = HnswIndex(HnswConfig(M=8, ef_construction=48, ef_search=48))
    idx.build(base)
    idx.check_integrity()
    q = uniq[:10]
    d, ids = idx.search(q, k=1)
    # nearest neighbor of an exact dataset point must have distance 0
    np.testing.assert_allclose(d[:, 0], 0.0, atol=1e-5)


def test_auto_build_strategy_selection():
    # defaults must pick the at-scale-servable build without a strategy knob
    # NND only below the convergence-safe size
    from hnsw_slim_tpu.index.hnsw import AUTO_NND_MAX_N, resolve_build_strategy

    assert resolve_build_strategy("auto", 1_000) == "nnd"
    assert resolve_build_strategy("auto", AUTO_NND_MAX_N - 1) == "nnd"
    assert resolve_build_strategy("auto", AUTO_NND_MAX_N) == "insert"
    assert resolve_build_strategy("auto", 1_000_000) == "insert"
    # explicit choices are always honored
    assert resolve_build_strategy("insert", 100) == "insert"
    assert resolve_build_strategy("nnd", 10_000_000) == "nnd"
