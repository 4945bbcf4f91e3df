"""Mesh-sharded Slim search: the 100M-scale serving path.

The reference serves everything from one host (hnswalg.h:123-124 single
allocation); its only distribution axis is the HTTP client/server split.
Here the scale axis is the device mesh: nodes are round-robin sharded across
the "shard" axis (each shard holds its own subgraph + vectors), queries are
data-parallel over the "dp" axis, and per-shard top-k results are merged with
an all_gather + sort across the devices (NVLink between GPUs of one host).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..config import HnswConfig, SearchConfig, SlimConfig
from ..graph import search as gs


def make_mesh(n_devices: int | None = None, dp: int | None = None) -> Mesh:
    """2-axis mesh ("dp", "shard"): queries over dp, index nodes over shard."""
    devs = np.array(jax.devices())
    n = n_devices or len(devs)
    devs = devs[:n]
    dp = dp or (2 if n % 2 == 0 and n > 2 else 1)
    return Mesh(devs.reshape(dp, n // dp), ("dp", "shard"))


def _local_search(nbr, lvl_off, entry, vecs, vn, gids, q, *, max_level,
                  threshold_level, cap0, cap, ef, k, max_iters, metric,
                  pop_width, stages=(), scan_width=0, dense0=None,
                  dense_up=None, rank_up=None):
    d, i, hops, dcomp = gs.chal_search(
        nbr, lvl_off, entry, vecs, vn, q,
        max_level=max_level, threshold_level=threshold_level, cap0=cap0,
        cap=cap, ef=ef, k=k, max_iters=max_iters, metric=metric,
        precision=jax.lax.Precision.HIGHEST, pop_width=pop_width,
        stages=stages, scan_width=scan_width, dense0=dense0,
        dense_up=dense_up, rank_up=rank_up,
    )
    gi = jnp.where(i >= 0, gids[jnp.maximum(i, 0)], -1)
    d = jnp.where(gi >= 0, d, jnp.inf)  # padded nodes never surface
    return d, gi, hops, dcomp


class ShardedSlimIndex:
    """Round-robin sharded Slim index over a jax Mesh.

    Global node g lives on shard g % S as local node g // S. Each shard's
    subgraph is built independently over its local vectors; a query runs on
    every shard and the per-shard top-k are merged globally.
    """

    def __init__(self, mesh: Mesh, metric: str = "l2",
                 search_cfg: SearchConfig | None = None):
        self.mesh = mesh
        self.metric = metric
        self.scfg = search_cfg or SearchConfig()
        self.arrays = None  # dict of stacked [S, ...] arrays
        self.meta = None  # static search params

    @property
    def n_shards(self) -> int:
        return self.mesh.shape["shard"]

    def build(self, vectors: np.ndarray, hnsw_cfg: HnswConfig | None = None,
              slim_cfg: SlimConfig | None = None, verbose: bool = False):
        from ..index.slim import HnswSlimIndex

        hnsw_cfg = hnsw_cfg or HnswConfig()
        slim_cfg = slim_cfg or SlimConfig.from_ratios()
        s = self.n_shards
        n, dim = vectors.shape
        n_per = -(-n // s)

        shard_graphs = []
        for si in range(s):
            gids = np.arange(si, n, s, dtype=np.int32)
            local = vectors[gids]
            if len(gids) < n_per:  # pad the short last shard
                pad = n_per - len(gids)
                local = np.concatenate([local, np.repeat(local[:1], pad, 0)])
                gids = np.concatenate([gids, np.full(pad, -1, np.int32)])
            idx = HnswSlimIndex.build(local, hnsw_cfg, slim_cfg)
            shard_graphs.append((idx, gids))
            if verbose:
                print(f"  shard {si}: {idx.index_size()} graph bytes")

        self._stack(shard_graphs, dim, slim_cfg)
        return self

    @classmethod
    def from_indexes(cls, mesh: Mesh, shard_indexes, metric: str = "l2",
                     search_cfg: SearchConfig | None = None):
        """Assemble from pre-built per-shard slim indexes.

        shard_indexes: list of (HnswSlimIndex, global_ids i32[n_per]) — one
        per mesh shard, all with equal node counts (pad the last shard's
        vectors and set its padding gids to -1). This is the 100M recipe:
        shards build independently (reference-binary CPU builds or NND) and
        the mesh serves them with the all_gather top-k merge.
        """
        import numpy as np

        s = mesh.shape["shard"]
        assert len(shard_indexes) == s, (len(shard_indexes), s)
        idx = cls(mesh, metric=metric, search_cfg=search_cfg)
        dim = int(np.asarray(shard_indexes[0][0].vectors).shape[1])
        idx._stack(shard_indexes, dim, None)
        return idx

    def _stack(self, shard_graphs, dim, slim_cfg):
        s = len(shard_graphs)
        lmax = max(g.graph.max_level for g, _ in shard_graphs)
        e_pad = max(g.graph.nbr.shape[0] for g, _ in shard_graphs)
        n_per = shard_graphs[0][0].graph.n

        nbr = np.full((s, e_pad), -1, np.int32)
        off = np.zeros((s, n_per, lmax + 2), np.int32)
        lvl = np.zeros((s, n_per), np.int32)
        ent = np.zeros((s,), np.int32)
        vecs = np.zeros((s, n_per, dim), np.float32)
        gid = np.zeros((s, n_per), np.int32)
        for i, (g, gids) in enumerate(shard_graphs):
            gr = g.graph
            nbr[i, : gr.nbr.shape[0]] = np.asarray(gr.nbr)
            o = np.asarray(gr.lvl_off)
            off[i, :, : o.shape[1]] = o
            off[i, :, o.shape[1] :] = o[:, -1:]  # saturate missing levels
            lvl[i] = np.asarray(gr.level)
            ent[i] = int(np.asarray(gr.entry))
            vecs[i] = np.asarray(g.vectors)
            gid[i] = gids

        mesh = self.mesh
        sh = lambda *spec: NamedSharding(mesh, P(*spec))
        self.arrays = dict(
            nbr=jax.device_put(nbr, sh("shard")),
            off=jax.device_put(off, sh("shard")),
            ent=jax.device_put(ent, sh("shard")),
            vecs=jax.device_put(vecs, sh("shard")),
            vn=jax.device_put(
                (vecs.astype(np.float32) ** 2).sum(-1), sh("shard")
            ),
            gid=jax.device_put(gid, sh("shard")),
            lvl=jax.device_put(lvl, sh("shard")),
        )
        g0 = shard_graphs[0][0].graph
        self.meta = dict(
            max_level=lmax, threshold_level=g0.threshold_level,
            cap0=g0.cap0, cap=g0.cap,
        )

    def densify_level0(self) -> int:
        """Stacked dense level-0 rows [S, n_per, cap0] (same +QPS lever as
        HnswSlimIndex.densify_level0, applied per shard)."""
        nbr = np.asarray(self.arrays["nbr"])
        off = np.asarray(self.arrays["off"])
        s, n_per = off.shape[:2]
        cap0 = self.meta["cap0"]
        rows = np.full((s, n_per, cap0), -1, np.int32)
        for i in range(s):
            start = off[i, :, 0].astype(np.int64)
            end = off[i, :, 1].astype(np.int64)
            idx = start[:, None] + np.arange(cap0)[None, :]
            valid = idx < end[:, None]
            rows[i] = np.where(
                valid, nbr[i][np.minimum(idx, nbr.shape[1] - 1)], -1
            )
        self.arrays["dense0"] = jax.device_put(
            rows, NamedSharding(self.mesh, P("shard"))
        )
        return int(rows.nbytes)

    def densify_upper(self, bucket: int = 1024) -> int:
        """Stacked dense upper-level serving layout per shard: rank
        indirection i32[S, n_per] (-1 for level-0-only nodes) + dense rows
        i32[S, L, R_pad, cap] — the same layout HnswSlimIndex.densify_upper
        builds single-device, so the mesh path serves identical layouts
        instead of walking upper levels via flat-CHAL scalar gathers."""
        off = np.asarray(self.arrays["off"])
        nbr = np.asarray(self.arrays["nbr"])
        lvl = np.asarray(self.arrays["lvl"])
        s, n_per = off.shape[:2]
        cap = self.meta["cap"]
        lmax = self.meta["max_level"]
        if lmax < 1:
            return 0
        rank = np.full((s, n_per), -1, np.int32)
        up_list = []
        r_max = 1
        for i in range(s):
            up = np.nonzero(lvl[i] >= 1)[0]
            rank[i, up] = np.arange(len(up), dtype=np.int32)
            up_list.append(up)
            r_max = max(r_max, len(up))
        r_pad = -(-r_max // bucket) * bucket
        dense = np.full((s, lmax, r_pad, cap), -1, np.int32)
        for i in range(s):
            up = up_list[i]
            for l in range(1, lmax + 1):
                sel = up[lvl[i, up] >= l]
                if not len(sel):
                    continue
                start = off[i, sel, l].astype(np.int64)
                end = off[i, sel, l + 1].astype(np.int64)
                idx = start[:, None] + np.arange(cap)[None, :]
                valid = idx < end[:, None]
                dense[i, l - 1, rank[i, sel]] = np.where(
                    valid, nbr[i][np.minimum(idx, nbr.shape[1] - 1)], -1
                )
        shn = NamedSharding(self.mesh, P("shard"))
        self.arrays["rank_up"] = jax.device_put(rank, shn)
        self.arrays["dense_up"] = jax.device_put(dense, shn)
        return int(rank.nbytes + dense.nbytes)

    def search(self, queries: np.ndarray, k: int):
        q = np.asarray(queries, np.float32)
        b = q.shape[0]
        dp = self.mesh.shape["dp"]
        bpad = -(-b // dp) * dp
        if bpad != b:
            q = np.concatenate([q, np.repeat(q[:1], bpad - b, 0)])
        ef = max(self.scfg.ef, k)
        b_loc = bpad // dp  # per-device batch inside shard_map
        stages = tuple(
            b_loc // f for f in self.scfg.straggler_stages if b_loc // f >= 32
        )
        out = _sharded_search_jit(
            self.mesh, self.arrays, jnp.asarray(q), ef=ef, k=k,
            max_iters=self.scfg.iters(), metric=self.metric,
            pop_width=self.scfg.pop_width, stages=stages,
            scan_width=self.scfg.scan_width, **self.meta,
        )
        d, i, hops, dcomp = jax.device_get(out)
        self.last_stats = {
            "hops": int(hops[:b].sum()),
            "distance_computations": int(dcomp[:b].sum()),
        }
        return d[:b], i[:b]

    def save(self, path) -> None:
        """Persist the stacked shard arrays + metadata (one npz)."""
        import json

        import numpy as np

        meta = dict(meta=self.meta, metric=self.metric,
                    mesh_shape=dict(self.mesh.shape))
        np.savez(
            path,
            meta_json=np.frombuffer(json.dumps(meta).encode(), np.uint8),
            **{k: np.asarray(v) for k, v in self.arrays.items()},
        )

    @classmethod
    def load(cls, path, mesh: Mesh, search_cfg: SearchConfig | None = None):
        import json

        import numpy as np

        with np.load(path) as z:
            meta = json.loads(bytes(z["meta_json"].tobytes()).decode())
            idx = cls(mesh, metric=meta["metric"], search_cfg=search_cfg)
            sh = lambda *spec: NamedSharding(mesh, P(*spec))
            idx.arrays = {
                k: jax.device_put(z[k], sh("shard"))
                for k in z.files if k != "meta_json"
            }
            idx.meta = meta["meta"]
        return idx

    def index_size(self) -> int:
        nbr = np.asarray(self.arrays["nbr"])
        off = np.asarray(self.arrays["off"])
        total_nbrs = int((off[:, :, -1] - off[:, :, 0]).sum())
        n_total = off.shape[0] * off.shape[1]
        return 24 * n_total + 4 * total_nbrs


def check_matches_host_merge(d, i, shard_indexes, q, k: int) -> None:
    """Raise AssertionError unless mesh results (d, i) equal the per-shard
    searches merged on the host: distances to rtol 1e-5, and the ID set of
    every row. Where the merged k-th and (k+1)-th distances tie, either tied
    ID may be kept: every ID in one set and not the other must then sit at
    the tied distance. shard_indexes as in ShardedSlimIndex.from_indexes,
    with the mesh's search config."""
    flat_d, flat_i = [], []
    for sub, gids in shard_indexes:
        sd, sids = sub.search(q, k=k)
        sids = np.asarray(sids)
        flat_d.append(np.asarray(sd))
        flat_i.append(np.where(sids >= 0, gids[np.maximum(sids, 0)], -1))
    cat_d = np.concatenate(flat_d, axis=1)
    cat_i = np.concatenate(flat_i, axis=1)
    order = np.argsort(cat_d, axis=1, kind="stable")
    srt_d = np.take_along_axis(cat_d, order, axis=1)
    ref_d = srt_d[:, :k]
    ref_i = np.take_along_axis(cat_i, order[:, :k], axis=1)
    d, i = np.asarray(d), np.asarray(i)
    np.testing.assert_allclose(d, ref_d, rtol=1e-5, atol=1e-5)
    close = functools.partial(np.isclose, rtol=1e-5, atol=1e-5)
    for r, (row_i, row_d) in enumerate(zip(i, d)):
        if set(row_i.tolist()) == set(ref_i[r].tolist()):
            continue
        tied = srt_d.shape[1] > k and close(srt_d[r, k - 1], srt_d[r, k])
        off = np.concatenate([row_d[~np.isin(row_i, ref_i[r])],
                              ref_d[r][~np.isin(ref_i[r], row_i)]])
        if not (tied and close(off, srt_d[r, k - 1]).all()):
            raise AssertionError(
                f"row {r}: mesh ids {row_i.tolist()} != host-merged "
                f"{ref_i[r].tolist()} (distances {ref_d[r].tolist()})")


@functools.partial(
    jax.jit,
    static_argnames=(
        "mesh", "ef", "k", "max_iters", "metric", "max_level",
        "threshold_level", "cap0", "cap", "pop_width", "stages",
        "scan_width",
    ),
)
def _sharded_search_jit(mesh, arrays, q, *, ef, k, max_iters, metric,
                        max_level, threshold_level, cap0, cap,
                        pop_width=4, stages=(), scan_width=0):
    # optional serving layouts, threaded positionally through shard_map
    opt_keys = tuple(
        kk for kk in ("dense0", "rank_up", "dense_up") if kk in arrays
    )

    def fn(nbr, off, ent, vecs, vn, gid, q, *rest):
        # block views: leading shard dim is 1 inside shard_map
        opt = dict(zip(opt_keys, rest))
        dense_up = opt.get("dense_up")
        if dense_up is not None:
            # [1, L, R_pad, cap] block -> per-level tuple for chal_search
            dense_up = tuple(
                dense_up[0][l] for l in range(dense_up.shape[1])
            )
        rank_up = opt.get("rank_up")
        d, gi, hops, dcomp = _local_search(
            nbr[0], off[0], ent[0], vecs[0], vn[0], gid[0], q,
            max_level=max_level, threshold_level=threshold_level,
            cap0=cap0, cap=cap, ef=ef, k=k, max_iters=max_iters,
            metric=metric, pop_width=pop_width, stages=stages,
            scan_width=scan_width,
            dense0=opt["dense0"][0] if "dense0" in opt else None,
            dense_up=dense_up,
            rank_up=rank_up[0] if rank_up is not None else None,
        )
        # merge across shards
        dg = lax.all_gather(d, "shard")  # [S, b, k]
        ig = lax.all_gather(gi, "shard")
        b = q.shape[0]
        s = dg.shape[0]
        cat_d = jnp.moveaxis(dg, 0, 1).reshape(b, s * k)
        cat_i = jnp.moveaxis(ig, 0, 1).reshape(b, s * k)
        sd, si = lax.sort((cat_d, cat_i), dimension=1, num_keys=1)
        # total per-query search effort = sum across shards (each shard
        # traverses its own subgraph) — metric_hops/metric_distance_
        # computations parity for the sharded path
        hops = lax.psum(hops, "shard")
        dcomp = lax.psum(dcomp, "shard")
        return sd[:, :k], si[:, :k], hops, dcomp

    extra = tuple(P("shard") for _ in opt_keys)
    mapped = jax.shard_map(
        fn,
        mesh=mesh,
        in_specs=(
            P("shard"), P("shard"), P("shard"), P("shard"), P("shard"),
            P("shard"), P("dp", None),
        ) + extra,
        out_specs=(P("dp", None), P("dp", None), P("dp"), P("dp")),
        check_vma=False,
    )
    a = arrays
    args = (a["nbr"], a["off"], a["ent"], a["vecs"], a["vn"], a["gid"], q)
    args += tuple(a[kk] for kk in opt_keys)
    return mapped(*args)
