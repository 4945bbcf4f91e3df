"""Tests for the batched best-first search kernels on synthetic graphs."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from hnsw_slim_tpu.graph import search as gs
from hnsw_slim_tpu.graph.types import pack_chal
from hnsw_slim_tpu.index.bruteforce import BruteForceIndex
from hnsw_slim_tpu.ops import distance

P = jax.lax.Precision.HIGHEST


def _knn_graph(base, deg, rng):
    """Exact kNN graph + 2 random long edges per node (keeps it connected)."""
    n = len(base)
    full = ((base[:, None, :] - base[None, :, :]) ** 2).sum(-1)
    np.fill_diagonal(full, np.inf)
    nn = np.argsort(full, axis=1)[:, :deg].astype(np.int32)
    rnd = rng.integers(0, n, (n, 2)).astype(np.int32)
    return np.concatenate([nn, rnd], axis=1)


def _symmetrized(adj, cap):
    """Union of out- and in-edges (navigable, like HNSW's reverse linking)."""
    n = len(adj)
    outs = [set(adj[v].tolist()) for v in range(n)]
    for v in range(n):
        for u in adj[v]:
            outs[u].add(v)
    return [np.array(sorted(outs[v]), np.int32)[:cap] for v in range(n)]


def test_pack_chal_fetch():
    # handcrafted 2-level graph: node 0 at level 1, others level 0
    levels = np.array([1, 0, 0], np.int32)
    nbl = [
        [np.array([1, 2]), np.array([2])],  # node 0: L0 = {1,2}, L1 = {2}
        [np.array([0]), None],
        [np.array([0, 1]), None],
    ]
    g = pack_chal(nbl, levels, entry=0, max_level=1, threshold_level=0, cap0=4, cap=2)
    f0 = gs.make_chal_fetch(g.nbr, g.lvl_off, 0, 4)
    f1 = gs.make_chal_fetch(g.nbr, g.lvl_off, 1, 2)
    np.testing.assert_array_equal(
        np.asarray(f0(jnp.array([0, 1, 2]))),
        [[1, 2, -1, -1], [0, -1, -1, -1], [0, 1, -1, -1]],
    )
    np.testing.assert_array_equal(
        np.asarray(f1(jnp.array([0, 1, 2]))), [[2, -1], [-1, -1], [-1, -1]]
    )
    assert g.chal_bytes() == 16 * 3 + 2 * 1 + 4 * 6


def test_beam_search_knn_graph_recall():
    rng = np.random.default_rng(5)
    n, dim, nq, k = 2000, 16, 64, 10
    base = rng.standard_normal((n, dim)).astype(np.float32)
    queries = rng.standard_normal((nq, dim)).astype(np.float32)
    adj = _knn_graph(base, deg=10, rng=rng)

    levels = np.zeros(n, np.int32)
    nbl = [[row] for row in _symmetrized(adj, cap=24)]
    g = pack_chal(nbl, levels, entry=0, max_level=0, threshold_level=0, cap0=24, cap=24)

    vecs = jnp.asarray(base)
    vn = distance.sq_norms(vecs)
    d, ids, hops, dcomp = gs.chal_search(
        g.nbr, g.lvl_off, g.entry, vecs, vn, jnp.asarray(queries),
        max_level=0, threshold_level=0, cap0=24, cap=24, ef=64, k=k,
        max_iters=300, metric="l2", precision=P,
    )
    ids = np.asarray(ids)
    d = np.asarray(d)
    assert np.asarray(hops).min() > 0 and np.asarray(dcomp).min() > 0

    bf = BruteForceIndex(base, chunk=1024)
    _, gt = bf.search(queries, k=k)
    hits = sum(
        len(set(a.tolist()) & set(b.tolist())) for a, b in zip(ids, gt)
    )
    recall = hits / (nq * k)
    assert recall > 0.99, recall
    # returned dists must equal true distances of returned ids
    true_d = ((queries[:, None, :] - base[ids]) ** 2).sum(-1)
    np.testing.assert_allclose(d, true_d, rtol=1e-3, atol=1e-3)
    # buffer sorted ascending
    assert np.all(np.diff(d, axis=1) >= -1e-6)


def test_greedy_descent_moves_to_local_min():
    rng = np.random.default_rng(6)
    n, dim = 500, 8
    base = rng.standard_normal((n, dim)).astype(np.float32)
    adj = _knn_graph(base, deg=8, rng=rng)
    vecs = jnp.asarray(base)
    vn = distance.sq_norms(vecs)
    q = jnp.asarray(base[:16] + 0.01)  # queries near known nodes
    qn = distance.sq_norms(q)
    fetch = gs.make_dense_fetch(jnp.asarray(adj))
    cur = jnp.zeros((16,), jnp.int32)
    curdist = distance.gathered_dist(q, vecs[cur][:, None, :], "l2", qn=qn,
                                     vn=vn[cur][:, None], precision=P)[:, 0]
    cur2, curdist2 = gs.greedy_level(
        fetch, vecs, vn, q, qn, cur, curdist,
        jnp.ones((16,), bool), "l2", P,
    )
    assert np.all(np.asarray(curdist2) <= np.asarray(curdist) + 1e-6)
    # each final node must be a local minimum among its neighbors
    cur2 = np.asarray(cur2)
    qn_ = np.asarray(q)
    for i, v in enumerate(cur2):
        dv = ((qn_[i] - base[v]) ** 2).sum()
        dn = ((qn_[i] - base[adj[v]]) ** 2).sum(-1)
        assert dv <= dn.min() + 1e-5


def test_seed_width_recall_and_superset():
    """Exact-seed multi-entry (seed_width + up table) must (a) never return
    ids worse than the unseeded search's termination bound allows, and (b)
    lift recall on clustered data (the cluster-local-minimum failure mode
    it exists for). Uses chal_search directly with a 2-level graph."""
    from hnsw_slim_tpu.config import HnswConfig, SlimConfig
    from hnsw_slim_tpu.index.hnsw import HnswIndex
    from hnsw_slim_tpu.index.slim import HnswSlimIndex
    from hnsw_slim_tpu.utils.data import clustered
    import dataclasses

    base, queries = clustered(8000, 24, n_queries=64, n_clusters=40,
                              seed=3, scale=0.3)
    h = HnswIndex(HnswConfig(M=10, ef_construction=48), strategy="insert")
    h.build(base)
    idx = HnswSlimIndex.from_hnsw(
        h, SlimConfig.from_ratios(top_M0=16, Mm_ratio=25, level_ratio=50)
    )
    bf = BruteForceIndex(base)
    _, gt = bf.search(queries, k=10)

    def recall(ids):
        return sum(
            len(set(a.tolist()) & set(b.tolist()))
            for a, b in zip(np.asarray(ids), gt)
        ) / gt.size

    idx.scfg = dataclasses.replace(idx.scfg, ef=32, pop_width=4)
    _, ids0 = idx.search(queries, k=10)
    idx.scfg = dataclasses.replace(idx.scfg, seed_width=16)
    _, ids1 = idx.search(queries, k=10)
    r0, r1 = recall(ids0), recall(ids1)
    assert r1 >= r0, (r0, r1)
    assert r1 >= min(r0 + 0.05, 0.95), (r0, r1)
    # up table rebuilds when the graph object changes (serving growth)
    assert idx.up_ids is not None
    n_up = int(np.sum(np.asarray(h.levels) >= 1))
    assert int(np.sum(np.asarray(idx.up_ids) >= 0)) == n_up


@pytest.fixture(scope="module")
def knn_chal_3k():
    rng = np.random.default_rng(11)
    n, dim, nq = 3000, 16, 32
    base = rng.standard_normal((n, dim)).astype(np.float32)
    queries = rng.standard_normal((nq, dim)).astype(np.float32)
    adj = _knn_graph(base, deg=10, rng=rng)
    nbl = [[row] for row in _symmetrized(adj, cap=24)]
    g = pack_chal(nbl, np.zeros(n, np.int32), entry=0, max_level=0,
                  threshold_level=0, cap0=24, cap=24)
    _, gt = BruteForceIndex(base, chunk=1024).search(queries, k=10)
    return g, base, queries, gt


@pytest.mark.parametrize("ef", [256, 320, 384, 512])
def test_chal_search_high_ef_matches_brute_force(knn_chal_3k, ef):
    """High-ef buffers (the widths whose merge dominates an iteration) must
    return the exact top-10, with true distances, sorted ascending."""
    g, base, queries, gt = knn_chal_3k
    vecs = jnp.asarray(base)
    d, ids, hops, _ = gs.chal_search(
        g.nbr, g.lvl_off, g.entry, vecs, distance.sq_norms(vecs),
        jnp.asarray(queries), max_level=0, threshold_level=0, cap0=24,
        cap=24, ef=ef, k=10, max_iters=(2 * ef + 16) // 4 + 8, metric="l2",
        precision=P, pop_width=4,
    )
    d, ids = np.asarray(d), np.asarray(ids)
    assert np.asarray(hops).min() > 0
    hits = sum(len(set(a.tolist()) & set(b.tolist()))
               for a, b in zip(ids, gt))
    assert hits == gt.size, hits / gt.size
    true_d = ((queries[:, None, :] - base[ids]) ** 2).sum(-1)
    np.testing.assert_allclose(d, true_d, rtol=1e-4, atol=1e-4)
    assert np.all(np.diff(d, axis=1) >= 0)
