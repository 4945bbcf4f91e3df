"""Import a reference-built slim graph (parity/ref_harness.cc dump format).

SURVEY §7 step 2's oracle: serve the EXACT graph the reference C++ engine
built and compare search behavior — this isolates the search kernels from the
build pipeline, and lets reference-speed CPU builds feed device serving.

Dump format (parity/ref_harness.cc dump_slim_graph):
    u32 magic 'HSLG' | u32 n | i32 maxlevel | u32 entry | i32 Lt |
    u32 maxM | u32 maxM0 | per node: i32 level | u32 total |
    u32 end_off[level+1] | i32 ids[total]
"""

from __future__ import annotations

import struct

import jax.numpy as jnp
import numpy as np

from .types import ChalGraph

MAGIC = 0x48534C47


def load_ref_slim_graph(path: str, return_host: bool = False):
    """return_host=True also returns the host {nbr, lvl_off, level} dict so
    densify/patch consumers skip the ~130 MB D2H round trip at 1M."""
    with open(path, "rb") as f:
        data = f.read()
    magic, n, maxlevel, entry, lt, maxm, maxm0 = struct.unpack_from(
        "<IIiIiII", data, 0
    )
    if magic != MAGIC:
        raise ValueError("bad slim graph dump")
    pos = 28

    from ..utils import native

    parsed = native.slim_graph_parse(path, n, maxlevel)
    if parsed is not None:  # mmap C scan: ~1 s at 1M vs ~2 min in Python
        levels, lvl_off32, flat = parsed
        total_edges = len(flat)
        e_pad = max(1024, 1 << max(0, total_edges - 1).bit_length())
        nbr = np.full(e_pad, -1, np.int32)
        nbr[:total_edges] = flat
        graph = ChalGraph(
            nbr=jnp.asarray(nbr),
            lvl_off=jnp.asarray(lvl_off32),
            level=jnp.asarray(levels),
            entry=jnp.asarray(np.int32(entry)),
            max_level=int(maxlevel),
            threshold_level=int(lt),
            cap0=int(maxm0),
            cap=int(maxm),
        )
        if return_host:
            return graph, dict(nbr=nbr, lvl_off=lvl_off32, level=levels)
        return graph

    levels = np.zeros(n, np.int32)
    lvl_off = np.zeros((n, maxlevel + 2), np.int64)
    chunks = []
    total_edges = 0
    for v in range(n):
        lv, total = struct.unpack_from("<iI", data, pos)
        pos += 8
        ends = np.frombuffer(data, np.uint32, lv + 1, pos)
        pos += 4 * (lv + 1)
        ids = np.frombuffer(data, np.int32, total, pos)
        pos += 4 * total
        levels[v] = lv
        lvl_off[v, 0] = total_edges
        for l in range(maxlevel + 1):
            end = ends[min(l, lv)] if l <= lv else ends[lv]
            lvl_off[v, l + 1] = total_edges + int(end)
        chunks.append(ids)
        total_edges += total
    flat = np.concatenate(chunks) if chunks else np.zeros(0, np.int32)
    e_pad = max(1024, 1 << (total_edges - 1).bit_length())
    nbr = np.full(e_pad, -1, np.int32)
    nbr[:total_edges] = flat

    graph = ChalGraph(
        nbr=jnp.asarray(nbr),
        lvl_off=jnp.asarray(lvl_off.astype(np.int32)),
        level=jnp.asarray(levels),
        entry=jnp.asarray(np.int32(entry)),
        max_level=int(maxlevel),
        threshold_level=int(lt),
        cap0=int(maxm0),
        cap=int(maxm),
    )
    if return_host:
        return graph, dict(nbr=nbr, lvl_off=lvl_off.astype(np.int32),
                           level=levels)
    return graph


HNSW_MAGIC = 0x484E5347


def load_ref_hnsw_graph(path: str, return_host: bool = False):
    """Import an UNPRUNED reference HNSW adjacency (ref_harness
    dump_hnsw_graph format: u32 'HNSG' | u32 n | i32 maxlevel | u32 entry |
    u32 maxM | u32 maxM0 | per node: i32 level | per l: u32 cnt | i32 ids)
    as a LevelGraph — the mutable serving state updates operate on."""
    from .types import LevelGraph

    with open(path, "rb") as f:
        data = f.read()
    magic, n, maxlevel, entry, maxm, maxm0 = struct.unpack_from(
        "<IIiIII", data, 0
    )
    if magic != HNSW_MAGIC:
        raise ValueError("bad hnsw graph dump")
    pos = 24

    from ..utils import native

    parsed = native.hnsw_graph_parse(path, n, maxlevel, maxm, maxm0)
    if parsed is not None:  # mmap C scan: ~1 s at 1M vs ~17 min in Python
        levels, adjs = parsed
        lg = LevelGraph(
            adjs=tuple(jnp.asarray(a) for a in adjs),
            level=jnp.asarray(levels),
            entry=jnp.asarray(np.int32(entry)),
            max_level=int(maxlevel),
        )
        return (lg, adjs) if return_host else lg

    levels = np.zeros(n, np.int32)
    adjs = [
        np.full((n, maxm0 if l == 0 else maxm), -1, np.int32)
        for l in range(maxlevel + 1)
    ]
    for v in range(n):
        (lv,) = struct.unpack_from("<i", data, pos)
        pos += 4
        levels[v] = lv
        for l in range(lv + 1):
            (cnt,) = struct.unpack_from("<I", data, pos)
            pos += 4
            ids = np.frombuffer(data, np.int32, cnt, pos)
            pos += 4 * cnt
            adjs[l][v, :cnt] = ids
    lg = LevelGraph(
        adjs=tuple(jnp.asarray(a) for a in adjs),
        level=jnp.asarray(levels),
        entry=jnp.asarray(np.int32(entry)),
        max_level=int(maxlevel),
    )
    return (lg, adjs) if return_host else lg


def hnsw_index_from_ref(graph_path: str, vectors: np.ndarray, metric="l2",
                        M: int = 30, ef_construction: int = 128):
    """HnswIndex serving/updating a reference-built vanilla graph."""
    from ..config import HnswConfig
    from ..index.hnsw import HnswIndex
    from ..ops import distance

    cfg = HnswConfig(M=M, ef_construction=ef_construction, metric=metric)
    idx = HnswIndex(cfg)
    idx.graph, host_adjs = load_ref_hnsw_graph(graph_path, return_host=True)
    idx.levels = np.asarray(idx.graph.level)
    # seed the host mirror from the parse (host_adj() would otherwise pull
    # the whole adjacency back from the device)
    idx._adj_np = host_adjs
    idx.vectors = jnp.asarray(np.asarray(vectors, np.float32))
    idx.vn = distance.sq_norms(idx.vectors)
    return idx


def slim_index_from_ref(graph_path: str, vectors: np.ndarray, metric="l2",
                        store_dtype: str = "float32", upload: bool = True):
    """upload=False keeps the vector store host-side (numpy) — for shards
    that only feed a union assembly (FlatUnionIndex/ShardedSlimIndex copy
    the vectors into their own layout; S per-shard HBM uploads at 16 x
    512 MB would exhaust the chip before the union exists)."""
    from ..index.slim import HnswSlimIndex
    from ..ops import distance

    idx = HnswSlimIndex(metric=metric)
    idx.graph, idx.host_chal = load_ref_slim_graph(graph_path,
                                                   return_host=True)
    host = np.asarray(vectors, np.float32)
    if not upload:
        idx.vectors = host
        idx.vn = (host.astype(np.float64) ** 2).sum(axis=1).astype(np.float32)
        return idx
    idx.vectors = jnp.asarray(host)
    if store_dtype == "bfloat16":
        idx.vectors = idx.vectors.astype(jnp.bfloat16)
    idx.vn = distance.sq_norms(idx.vectors)
    return idx
