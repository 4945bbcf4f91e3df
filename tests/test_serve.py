"""End-to-end client/server: query, setEf, updateIndex + patch sync, delete."""

import numpy as np
import pytest

from hnsw_slim_tpu.config import HnswConfig, SlimConfig
from hnsw_slim_tpu.index.bruteforce import BruteForceIndex
from hnsw_slim_tpu.serve.client import SlimClient
from hnsw_slim_tpu.serve.server import SlimServer
from hnsw_slim_tpu.utils.data import clustered


@pytest.fixture(scope="module")
def served():
    base, queries = clustered(n=2200, dim=16, n_queries=20, seed=51)
    server = SlimServer(
        base[:2000],
        hnsw_cfg=HnswConfig(M=12, ef_construction=64),
        slim_cfg=SlimConfig.from_ratios(),
        port=18472,
    )
    server.start_background()
    yield server, SlimClient(port=18472), base, queries
    server.shutdown()


def test_query_and_set_ef(served):
    server, client, base, queries = served
    assert client.set_ef(80)
    bf = BruteForceIndex(base[:2000], chunk=1024)
    _, gt = bf.search(queries, k=5)
    hits = 0
    for q, g in zip(queries, gt):
        d, labels = client.query(q, k=5)
        assert len(labels) == 5
        assert np.all(np.diff(d) >= -1e-6)
        hits += len(set(labels.tolist()) & set(g.tolist()))
    assert hits / gt.size >= 0.85


def test_update_index_and_patch_sync(served):
    server, client, base, queries = served
    # client-side mirror of the pre-update index
    import copy

    local = copy.copy(server.slim)
    blob, finished = client.update_index(
        ids=range(2000, 2200), vectors=base[2000:2200]
    )
    assert len(blob) > 0
    local = client.sync_patches(local, blob, finished)
    assert local.graph.n == 2200

    # patched client index must serve the new points
    bf = BruteForceIndex(base, chunk=1024)
    _, gt = bf.search(queries, k=5)
    local.set_ef(80)
    _, ids = local.search(queries, k=5)
    hits = sum(len(set(a.tolist()) & set(b.tolist())) for a, b in zip(ids, gt))
    assert hits / gt.size >= 0.8

    # server must also serve them directly
    d, labels = client.query(base[2100], k=3)
    assert 2100 in labels


def test_mark_delete(served):
    server, client, base, queries = served
    d, labels = client.query(base[100], k=3)
    assert 100 in labels
    assert client.mark_delete([100]) == 1
    d, labels = client.query(base[100], k=3)
    assert 100 not in labels


def test_hnsw_serve_mode():
    base, queries = clustered(n=1200, dim=16, n_queries=10, seed=52)
    server = SlimServer(
        base,
        hnsw_cfg=HnswConfig(M=12, ef_construction=64),
        port=18475,
        serve_index="hnsw",
    )
    server.start_background()
    try:
        client = SlimClient(port=18475)
        client.set_ef(64)
        bf = BruteForceIndex(base, chunk=1024)
        _, gt = bf.search(queries, k=5)
        hits = 0
        for q, g in zip(queries, gt):
            _, labels = client.query(q, k=5)
            hits += len(set(labels.tolist()) & set(g.tolist()))
        assert hits / gt.size >= 0.9
    finally:
        server.shutdown()


def test_replace_deleted_slot_reuse():
    base, _ = clustered(n=1500, dim=16, n_queries=0, seed=53)
    server = SlimServer(
        base[:1400],
        hnsw_cfg=HnswConfig(M=12, ef_construction=64),
        port=18476,
    )
    n0 = server.hnsw.graph.n
    # delete 50 labels, then insert 60 new vectors: 50 reuse slots, 10 append
    server.mark_delete(range(100, 150))
    writer = server.update_index(base[1400:1460])
    assert server.hnsw.graph.n == n0 + 10  # only the overflow appended
    assert not server.deleted[100:150].any()
    assert (server.labels[100:150] >= 1400).all()  # relabeled slots

    # replaced vectors are served under their new labels
    d, labels = server.query(base[1405], k=3)
    assert 1405 in labels.tolist()
    # patch records for reused slots carry vectors (classified as new)
    blob, fin = writer.next_chunk()
    assert fin and len(blob) > 0


def test_incremental_dense0_matches_full_rebuild(served):
    """update_index maintains the dense level-0 serving layout with a sparse
    row scatter (update_dense0); it must equal a from-scratch densify of the
    post-update graph. Runs after the module's update/delete tests so the
    layout has survived several mutations."""
    server, client, base, queries = served
    assert server.slim.dense0 is not None  # dense0 serving is the default
    # one more mutation (reuses the deleted slot + appends); offset keeps the
    # new points far from every query's true top-5, so later recall tests
    # against the pre-update ground truth stay meaningful
    server.update_index(base[:50] + 5.0)
    inc_rows = np.asarray(server.slim.dense0)
    full = server.slim.densify_level0()
    assert full == inc_rows.nbytes
    np.testing.assert_array_equal(
        inc_rows, np.asarray(server.slim.dense0),
        err_msg="incremental dense0 diverged from full densify",
    )


def test_bootstrap_and_vector_fetch(served):
    server, client, base, queries = served
    local = client.bootstrap()
    assert local.graph.n == server.slim.graph.n
    local.set_ef(64)
    d1, i1 = local.search(queries[:5], k=5)
    d2, i2 = server.slim.search(queries[:5], k=5)
    np.testing.assert_array_equal(i1, i2)
    vecs = client.get_vectors(10, 7)
    np.testing.assert_allclose(
        vecs, np.asarray(server.slim.vectors)[10:17], rtol=1e-6
    )


def test_concurrent_queries_batched(served):
    from concurrent.futures import ThreadPoolExecutor

    server, client, base, queries = served
    bf = BruteForceIndex(base[:2000], chunk=1024)
    _, gt = bf.search(queries, k=5)

    def one(i):
        _, labels = client.query(queries[i], k=5)
        return len(set(labels.tolist()) & set(gt[i].tolist()))

    with ThreadPoolExecutor(max_workers=10) as ex:
        hits = sum(ex.map(one, range(len(queries))))
    assert hits / gt.size >= 0.8


def test_update_index_respects_client_labels():
    base, _ = clustered(n=1300, dim=16, n_queries=0, seed=54)
    server = SlimServer(
        base[:1200], hnsw_cfg=HnswConfig(M=12, ef_construction=64), port=18483
    )
    server.start_background()
    try:
        client = SlimClient(port=18483)
        client.mark_delete([3, 4])
        client.update_index(range(9000, 9100), base[1200:1300])
        _, labels = client.query(base[1250], k=3)
        assert 9050 in labels.tolist()
        assert (server.labels[[3, 4]] >= 9000).all()  # reused slots relabeled
    finally:
        server.shutdown()

