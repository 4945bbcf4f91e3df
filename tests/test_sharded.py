"""Mesh-sharded search on the virtual 8-device CPU mesh."""

import numpy as np
import jax
import pytest

from hnsw_slim_tpu.config import HnswConfig, SlimConfig
from hnsw_slim_tpu.index.bruteforce import BruteForceIndex
from hnsw_slim_tpu.parallel.sharded import (
    ShardedSlimIndex, check_matches_host_merge, make_mesh,
)
from hnsw_slim_tpu.utils.data import clustered


def test_sharded_search_recall():
    assert len(jax.devices()) == 8, jax.devices()
    mesh = make_mesh(8, dp=2)
    assert mesh.shape == {"dp": 2, "shard": 4}

    base, queries = clustered(n=2400, dim=16, n_queries=30, seed=42)
    idx = ShardedSlimIndex(mesh)
    idx.build(
        base,
        hnsw_cfg=HnswConfig(M=12, ef_construction=64),
        slim_cfg=SlimConfig.from_ratios(),
    )
    idx.scfg = type(idx.scfg)(ef=64)

    bf = BruteForceIndex(base, chunk=1024)
    _, gt = bf.search(queries, k=10)
    d, ids = idx.search(queries, k=10)
    assert ids.shape == (30, 10)
    hits = sum(len(set(a.tolist()) & set(b.tolist())) for a, b in zip(ids, gt))
    recall = hits / gt.size
    assert recall >= 0.9, recall
    # merged distances ascending and true
    valid = ids >= 0
    true_d = ((queries[:, None, :] - base[np.maximum(ids, 0)]) ** 2).sum(-1)
    np.testing.assert_allclose(d[valid], true_d[valid], rtol=1e-3, atol=1e-3)

    # odd batch size (not divisible by dp)
    d1, i1 = idx.search(queries[:3], k=5)
    assert i1.shape == (3, 5)


def test_sharded_save_load_and_size(tmp_path):
    import jax

    from hnsw_slim_tpu.config import SearchConfig

    mesh = make_mesh(8, dp=2)
    base, queries = clustered(n=1000, dim=16, n_queries=10, seed=43)
    idx = ShardedSlimIndex(mesh, search_cfg=SearchConfig(ef=32))
    idx.build(base, hnsw_cfg=HnswConfig(M=8, ef_construction=32))
    assert idx.index_size() > 0
    d1, i1 = idx.search(queries, k=5)
    assert (i1 >= 0).all() and (i1 < 1000).all()
    # uneven shard count: last shard padded, padded slots never surface
    base2 = base[:997]
    idx2 = ShardedSlimIndex(mesh, search_cfg=SearchConfig(ef=32))
    idx2.build(base2, hnsw_cfg=HnswConfig(M=8, ef_construction=32))
    _, i2 = idx2.search(queries, k=5)
    assert (i2 >= 0).all() and (i2 < 997).all()

    # save/load roundtrip: identical results
    p = tmp_path / "sharded.npz"
    idx.save(p)
    loaded = ShardedSlimIndex.load(p, mesh, search_cfg=SearchConfig(ef=32))
    d3, i3 = loaded.search(queries, k=5)
    np.testing.assert_array_equal(i3, i1)


def test_sharded_from_prebuilt_indexes():
    # the 100M recipe: shards built independently, mesh-served together
    from hnsw_slim_tpu.config import SlimConfig
    from hnsw_slim_tpu.index.slim import HnswSlimIndex

    mesh = make_mesh(8, dp=2)
    s = mesh.shape["shard"]
    base, queries = clustered(n=1600, dim=16, n_queries=10, seed=44)
    shard_indexes = []
    for si in range(s):
        gids = np.arange(si, 1600, s, dtype=np.int32)
        idx = HnswSlimIndex.build(
            base[gids], HnswConfig(M=8, ef_construction=32),
            SlimConfig.from_ratios(),
        )
        shard_indexes.append((idx, gids))
    from hnsw_slim_tpu.config import SearchConfig

    sharded = ShardedSlimIndex.from_indexes(
        mesh, shard_indexes, search_cfg=SearchConfig(ef=32)
    )
    # dense serving layouts on the mesh path (same layouts as single-chip)
    assert sharded.densify_level0() > 0
    sharded.densify_upper()
    bf = BruteForceIndex(base, chunk=1024)
    _, gt = bf.search(queries, k=5)
    d, ids = sharded.search(queries, k=5)
    hits = sum(len(set(a.tolist()) & set(b.tolist())) for a, b in zip(ids, gt))
    assert hits / gt.size >= 0.9

    # mesh == flat parity (README claim): per-shard searches merged on the
    # host must match the shard_map + all_gather path, dense layouts on
    for sub, _ in shard_indexes:
        sub.scfg = SearchConfig(ef=32)
        sub.densify_level0()
        sub.densify_upper()
    check_matches_host_merge(d, ids, shard_indexes, queries, 5)

    # the check compares IDs, not only distances: right distances under a
    # wrong global-ID table must fail it
    swapped = [(sub, shard_indexes[(si + 1) % s][1])
               for si, (sub, _) in enumerate(shard_indexes)]
    with pytest.raises(AssertionError, match="mesh ids"):
        check_matches_host_merge(d, ids, swapped, queries, 5)
