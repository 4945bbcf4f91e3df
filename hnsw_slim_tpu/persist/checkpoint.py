"""Index persistence: the index files ARE the checkpoints.

Reference: versionless writeBinaryPOD streams (hnswalg_slim.h saveIndex
:717-751, loadIndex :753-815). Here: one .npz of arrays + a JSON metadata
header (versioned), with derived state rebuilt on load.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np

from ..config import SearchConfig
from ..graph.types import ChalGraph, LevelGraph

FORMAT_VERSION = 1


def save_slim(path: str | Path, index) -> None:
    """Save an HnswSlim(Zero)Index (graph + vectors + metadata)."""
    g = index.graph
    meta = dict(
        version=FORMAT_VERSION,
        kind=type(index).__name__,
        metric=index.metric,
        max_level=g.max_level,
        threshold_level=g.threshold_level,
        cap0=g.cap0,
        cap=g.cap,
        entry=int(np.asarray(g.entry)),
    )
    n = g.n  # slice off capacity padding: files hold the logical index
    np.savez(
        path,
        meta=np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8),
        nbr=np.asarray(g.nbr),
        lvl_off=np.asarray(g.lvl_off)[:n],
        level=np.asarray(g.level)[:n],
        vectors=np.asarray(index.vectors)[:n],
    )


def load_slim(path: str | Path, search_cfg: SearchConfig | None = None):
    """Load an HnswSlim(Zero)Index; visited pools etc. are rebuilt lazily
    (mirrors loadIndex's derived-state reconstruction)."""
    from ..index.slim import HnswSlimIndex
    from ..index.slimzero import HnswSlimZeroIndex
    from ..ops import distance

    with np.load(path) as z:
        meta = json.loads(bytes(z["meta"].tobytes()).decode())
        if meta["version"] > FORMAT_VERSION:
            raise ValueError(f"unsupported index version {meta['version']}")
        cls = {"HnswSlimIndex": HnswSlimIndex,
               "HnswSlimZeroIndex": HnswSlimZeroIndex}[meta["kind"]]
        idx = cls(metric=meta["metric"], search_cfg=search_cfg)
        idx.graph = ChalGraph(
            nbr=jnp.asarray(z["nbr"]),
            lvl_off=jnp.asarray(z["lvl_off"]),
            level=jnp.asarray(z["level"]),
            entry=jnp.asarray(np.int32(meta["entry"])),
            max_level=meta["max_level"],
            threshold_level=meta["threshold_level"],
            cap0=meta["cap0"],
            cap=meta["cap"],
        )
        idx.vectors = jnp.asarray(z["vectors"])
        idx.vn = distance.sq_norms(idx.vectors)
    return idx


def save_slimq(path: str | Path, index) -> None:
    """Save an HnswSlimQIndex: graph + quantized payload + rotator flip bits
    + centroids (hnswalg_slimq.h saveIndex :1183-1202 scope; no raw
    vectors — the dataset stays external)."""
    g = index.graph
    c = index.codes
    meta = dict(
        version=FORMAT_VERSION,
        kind="HnswSlimQIndex",
        metric=index.metric,
        max_level=g.max_level,
        threshold_level=g.threshold_level,
        cap0=g.cap0,
        cap=g.cap,
        entry=int(np.asarray(g.entry)),
        ex_bits=c.ex_bits,
        dim=index.rotator.dim,
    )
    np.savez(
        path,
        meta=np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8),
        nbr=np.asarray(g.nbr),
        lvl_off=np.asarray(g.lvl_off)[: g.n],
        level=np.asarray(g.level)[: g.n],
        bin_code=np.asarray(c.bin_code),
        f_add=np.asarray(c.f_add),
        f_rescale=np.asarray(c.f_rescale),
        f_error=np.asarray(c.f_error),
        ex_planes=np.asarray(c.ex_planes),
        f_add_ex=np.asarray(c.f_add_ex),
        f_rescale_ex=np.asarray(c.f_rescale_ex),
        f_error_ex=np.asarray(c.f_error_ex),
        cluster_ids=np.asarray(index.cluster_ids),
        centroids_rot=np.asarray(index.centroids_rot),
        flip_bits=index.rotator.state(),
    )


def load_slimq(path: str | Path, search_cfg: SearchConfig | None = None):
    from ..index.slimq import HnswSlimQIndex
    from ..quant.rabitq import QuantizedCodes
    from ..quant.rotator import FhtKacRotator

    with np.load(path) as z:
        meta = json.loads(bytes(z["meta"].tobytes()).decode())
        idx = HnswSlimQIndex(metric=meta["metric"], search_cfg=search_cfg)
        idx.graph = ChalGraph(
            nbr=jnp.asarray(z["nbr"]),
            lvl_off=jnp.asarray(z["lvl_off"]),
            level=jnp.asarray(z["level"]),
            entry=jnp.asarray(np.int32(meta["entry"])),
            max_level=meta["max_level"],
            threshold_level=meta["threshold_level"],
            cap0=meta["cap0"],
            cap=meta["cap"],
        )
        idx.codes = QuantizedCodes(
            bin_code=jnp.asarray(z["bin_code"]),
            f_add=jnp.asarray(z["f_add"]),
            f_rescale=jnp.asarray(z["f_rescale"]),
            f_error=jnp.asarray(z["f_error"]),
            ex_planes=jnp.asarray(z["ex_planes"]),
            f_add_ex=jnp.asarray(z["f_add_ex"]),
            f_rescale_ex=jnp.asarray(z["f_rescale_ex"]),
            f_error_ex=jnp.asarray(z["f_error_ex"]),
            ex_bits=meta["ex_bits"],
        )
        idx.cluster_ids = jnp.asarray(z["cluster_ids"])
        idx.centroids_rot = jnp.asarray(z["centroids_rot"])
        idx.rotator = FhtKacRotator.from_state(meta["dim"], z["flip_bits"])
    return idx


def save_hnsw(path: str | Path, index) -> None:
    g = index.graph
    meta = dict(
        version=FORMAT_VERSION,
        kind="HnswIndex",
        metric=index.cfg.metric,
        max_level=g.max_level,
        entry=int(np.asarray(g.entry)),
        cfg=dataclasses.asdict(index.cfg),
    )
    n = g.n  # slice off capacity padding: files hold the logical index
    arrays = {f"adj{l}": np.asarray(a)[:n] for l, a in enumerate(g.adjs)}
    np.savez(
        path,
        meta=np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8),
        level=np.asarray(g.level)[:n],
        vectors=np.asarray(index.vectors)[:n],
        **arrays,
    )


def load_hnsw(path: str | Path):
    from ..config import HnswConfig
    from ..index.hnsw import HnswIndex
    from ..ops import distance

    with np.load(path) as z:
        meta = json.loads(bytes(z["meta"].tobytes()).decode())
        cfg = HnswConfig(**meta["cfg"])
        idx = HnswIndex(cfg)
        adjs = tuple(
            jnp.asarray(z[f"adj{l}"]) for l in range(meta["max_level"] + 1)
        )
        idx.graph = LevelGraph(
            adjs=adjs,
            level=jnp.asarray(z["level"]),
            entry=jnp.asarray(np.int32(meta["entry"])),
            max_level=meta["max_level"],
        )
        idx.levels = np.asarray(z["level"])
        # seed the host adjacency mirror from the file (host_adj() would
        # otherwise pull the whole adjacency back from the device)
        idx._adj_np = [np.asarray(z[f"adj{l}"])
                       for l in range(meta["max_level"] + 1)]
        idx.vectors = jnp.asarray(z["vectors"])
        idx.vn = distance.sq_norms(idx.vectors)
    return idx
