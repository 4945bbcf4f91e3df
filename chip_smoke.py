"""End-to-end smoke run of the Slim vector store on one NVIDIA GPU.

Drives the serving path through the entry points a user calls, at SIFT1M's
shape: 1M x 128-d f32 clustered vectors made from a seed (the bench recipe),
built, pruned and served by SlimServer over HTTP. Each phase prints its
result and wall time, and any failure ends the run with a non-zero exit.

  0 device     JAX's backend is a GPU; card name and power limit
  1 data       exact ground truth on the card against float64 numpy
  2 serve      SlimServer start-up, /setEf and /query over HTTP; one direct
               batched search on the seeded top-k branch
  3 update     /updateIndex and patch drain (the patch applies idempotently
               and reproduces the server's graph); /markDelete
  4 cpu check  the same search and prune programs on JAX's CPU backend
  5 variants   SlimQ built at 200k; SlimZero converted from the served graph
               on the GPU and on JAX's CPU backend
  6 memory     peak device bytes

`--multi` runs only the four-card phase instead: two 250k shards on a
("dp", "shard") = (2, 2) mesh through ShardedSlimIndex, checked against the
per-shard searches merged on the host.

Usage: python chip_smoke.py [--multi]

Needs a GPU: with any other JAX backend it exits non-zero and prints no
result. The last line of stdout is one JSON object naming the device.
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import json
import socket
import subprocess
import sys
import time

import numpy as np

F32_EPS = float(np.finfo(np.float32).eps)


@dataclasses.dataclass(frozen=True)
class Sizes:
    n: int = 1_000_000
    dim: int = 128
    n_queries: int = 1000
    n_insert: int = 1000
    n_served: int = 200  # single /query requests
    n_gt_check: int = 64  # ground-truth rows checked in float64
    n_cpu: int = 256  # queries of the CPU-backend comparison
    n_prune: int = 4096  # candidate rows of the CPU-backend prune check
    n_delete: int = 10
    slimq_n: int = 200_000
    shard_n: int = 250_000  # per shard, --multi

    @property
    def n_clusters(self) -> int:  # the bench recipe: ~1000 points a cluster
        return max(64, self.n // 1000)


def _phase(name: str):
    def wrap(fn):
        def run(self, *a, **kw):
            t0 = time.perf_counter()
            out = fn(self, *a, **kw)
            print(f"phase {name}: ok ({time.perf_counter() - t0:.1f} s)",
                  flush=True)
            return out
        return run
    return wrap


class SmokeError(AssertionError):
    """A phase's result is wrong."""


def _check(ok, what) -> None:
    """Fail the phase unless ok; unlike assert, kept under python -O."""
    if not ok:
        raise SmokeError(what)


def _recall(ids, gt) -> float:
    ids, gt = np.asarray(ids), np.asarray(gt)
    return sum(len(set(a.tolist()) & set(b.tolist()))
               for a, b in zip(ids, gt)) / gt.size


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def card_name_and_power() -> str:
    """`name, power.limit` of the card, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip()


def _prune_tie_margin(vecs: np.ndarray, base: int, cand: np.ndarray) -> float:
    """Smallest gap, in float64, between two distances that the RNG prune of
    one row compares (sorted candidate distances, and each pairwise distance
    against the candidate's own), over the fp32 resolution of the norm
    expansion those distances are computed with on the device."""
    b = vecs[base].astype(np.float64)
    c = vecs[cand[cand >= 0]].astype(np.float64)
    d = ((c - b) ** 2).sum(1)
    order = np.argsort(d)
    c, d = c[order], d[order]
    pd = ((c[:, None, :] - c[None, :, :]) ** 2).sum(-1)
    gaps = [np.abs(np.diff(d))]
    lower = np.tril_indices(len(d), -1)  # (i, j) with j < i: pd[j, i] vs d[i]
    gaps.append(np.abs(pd[lower[1], lower[0]] - d[lower[0]]))
    gap = min((g.min() for g in gaps if g.size), default=np.inf)
    norm2 = max(float((b ** 2).sum()), float((c ** 2).sum(1).max()))
    return gap / (F32_EPS * norm2)


class Smoke:
    """The phases, in order; each keeps what the later ones need."""

    # below this many fp32 ulps of the norm scale, two distances are tied
    TIE_ULPS = 64.0

    def __init__(self, sizes: Sizes = Sizes()):
        self.s = sizes
        self.server = None

    # ---- 0 ------------------------------------------------------------
    @_phase("0 device")
    def device(self, require_gpu: bool = True) -> dict:
        import jax

        backend = jax.default_backend()
        dev = jax.devices()[0]
        if require_gpu and (backend != "gpu" or dev.platform != "gpu"):
            raise RuntimeError(
                f"needs a GPU; JAX's backend is {backend!r} "
                f"({dev.platform}, {dev.device_kind})")
        import jaxlib

        from hnsw_slim_tpu.utils import native

        print(f"  device_kind={dev.device_kind} count={len(jax.devices())} "
              f"jax={jax.__version__} jaxlib={jaxlib.__version__}")
        if dev.platform == "gpu":
            print(f"  nvidia-smi: {card_name_and_power()}")
        print("  native data plane: " + (
            "native/libdataplane.so loaded" if native._lib() is not None
            else "numpy codec (libdataplane.so not loaded)"))
        return {"platform": dev.platform, "kind": dev.device_kind,
                "count": len(jax.devices())}

    # ---- 1 ------------------------------------------------------------
    @_phase("1 data")
    def data(self) -> None:
        from hnsw_slim_tpu.index.bruteforce import BruteForceIndex
        from hnsw_slim_tpu.utils.data import clustered

        s = self.s
        self.base, self.queries = clustered(
            s.n, s.dim, n_queries=s.n_queries, n_clusters=s.n_clusters,
            seed=7, scale=0.3)
        # same centers (seed 7), new points: a smaller n shifts the stream
        self.inserts, _ = clustered(
            s.n_insert, s.dim, n_clusters=s.n_clusters, seed=7, scale=0.3)
        # exact GT on the device at Precision.HIGHEST (full fp32, no TF32)
        gt_d, self.gt = BruteForceIndex(self.base).search(self.queries, k=10)

        m = s.n_gt_check
        base64 = self.base.astype(np.float64)
        q64 = self.queries[:m].astype(np.float64)
        d64 = ((base64 ** 2).sum(1)[None, :] + (q64 ** 2).sum(1)[:, None]
               - 2.0 * q64 @ base64.T)
        rows = np.arange(m)[:, None]
        np.testing.assert_allclose(gt_d[:m], d64[rows, self.gt[:m]],
                                   rtol=1e-5)
        top11 = np.argpartition(d64, 11, axis=1)[:, :11]
        top11 = np.take_along_axis(
            top11, np.argsort(d64[rows, top11], axis=1), axis=1)
        d10, d11 = d64[rows[:, 0], top11[:, 9]], d64[rows[:, 0], top11[:, 10]]
        untied = (d11 - d10) > 1e-4 * d10
        for r in np.nonzero(untied)[0]:
            _check(set(self.gt[r].tolist()) == set(top11[r, :10].tolist()), r)
        print(f"  ground truth: {s.n} x {s.dim}, {s.n_queries} queries; "
              f"{m} rows vs float64: distances rtol 1e-5, top-10 sets equal "
              f"in all {int(untied.sum())} rows without a 10th/11th tie")

    # ---- 2 ------------------------------------------------------------
    @_phase("2 serve")
    def serve(self, card: str = "") -> None:
        from hnsw_slim_tpu.serve.client import SlimClient
        from hnsw_slim_tpu.serve.server import SlimServer

        s = self.s
        port = _free_port()
        self.server = SlimServer(self.base, serve_index="slim",
                                 host="127.0.0.1", port=port)
        setup = " ".join(f"{k}={v:.1f}s"
                         for k, v in self.server.setup_seconds.items())
        print(f"  set-up: {setup} ({card or 'no card name'})")
        self.server.start_background()
        self.client = SlimClient(port=port)
        _check(self.client.set_ef(384), "/setEf 384 not acknowledged")

        served = []
        for q in self.queries[: s.n_served]:
            d, labels = self.client.query(q, k=10)
            _check(labels.shape == (10,) and np.isfinite(d).all()
                   and (np.diff(d) >= 0).all(), (labels, d))
            served.append(labels)
        self.served = np.stack(served)
        rec = _recall(self.served, self.gt[: s.n_served])
        print(f"  served /query ef=384: recall@10={rec:.4f} "
              f"over {s.n_served} requests")
        _check(rec >= 0.90, rec)

        slim = self.server.slim
        saved = slim.scfg
        slim.scfg = dataclasses.replace(
            saved, ef=64, seed_width=32, straggler_stages=(2, 8, 32))
        d, ids = slim.search(self.queries, k=10)
        slim.scfg = saved
        _check(ids.shape == (s.n_queries, 10) and np.isfinite(d).all(),
               ids.shape)
        print(f"  direct search ef=64 seed_width=32 B={s.n_queries}: "
              f"recall@10={_recall(ids, self.gt):.4f}")

    # ---- 3 ------------------------------------------------------------
    @_phase("3 update")
    def update(self) -> None:
        from hnsw_slim_tpu.persist import patch as patchlib

        s, server, client = self.s, self.server, self.client
        pre = server.chal_unpadded
        host_pre = dataclasses.replace(
            pre, nbr=np.asarray(pre.nbr), lvl_off=np.asarray(pre.lvl_off),
            level=np.asarray(pre.level))
        vecs_pre = np.array(server.vectors_np)

        new_labels = np.arange(s.n, s.n + s.n_insert)
        chunk, finished = client.update_index(new_labels, self.inserts)
        chunks = [chunk]
        while not finished:
            chunk, finished = client.get_last_batch()
            chunks.append(chunk)

        def apply(graph, vecs):
            for c in chunks:
                graph, vecs = patchlib.apply_patch(graph, c, vecs)
            return graph, vecs

        once, v1 = apply(host_pre, vecs_pre)
        twice, v2 = apply(once, v1)
        for a, b in zip(patchlib.to_np(once).values(),
                        patchlib.to_np(twice).values()):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(v1, v2)
        _check(patchlib.compute_diff(once, server.chal_unpadded) == ([], []),
               "patched graph differs from the server's")
        print(f"  /updateIndex {s.n_insert} vectors: "
              f"{sum(map(len, chunks))} patch bytes in {len(chunks)} chunk(s);"
              " applied twice == once == server graph")

        _, ids = server.slim.search(self.inserts, k=1)  # served ef 384
        hit = float((server.labels[ids[:, 0]] == new_labels).mean())
        print(f"  self-hit@1 of the inserted vectors at ef=384: {hit:.4f}")
        _check(hit >= 0.90, hit)

        victims = list(dict.fromkeys(self.served[:, 0].tolist()))
        victims = victims[: s.n_delete]
        _check(client.mark_delete(victims) == len(victims), victims)
        for q in self.queries[: s.n_served]:
            _, labels = client.query(q, k=10)
            _check(not set(victims) & set(labels.tolist()), labels)
        print(f"  /markDelete {len(victims)} labels: none returned by "
              f"{s.n_served} later queries")

    # ---- 4 ------------------------------------------------------------
    @_phase("4 cpu check")
    def cpu_check(self) -> None:
        import jax

        from hnsw_slim_tpu.graph.heuristic import prune_batch

        s, server = self.s, self.server
        cpu = jax.devices("cpu")[0]
        slim = server.slim
        saved = slim.scfg
        slim.scfg = dataclasses.replace(saved, ef=128, seed_width=0)
        mirror = copy.copy(slim)
        for name in ("graph", "vectors", "vn", "dense0", "dense_up",
                     "rank_up"):
            setattr(mirror, name, jax.device_put(getattr(slim, name), cpu))
        q = self.queries[: s.n_cpu]
        d_dev, i_dev = slim.search(q, k=10)
        with jax.default_device(cpu):
            d_cpu, i_cpu = mirror.search(q, k=10)
        slim.scfg = saved
        same = i_dev == i_cpu
        share = float(same.mean())
        np.testing.assert_allclose(d_dev[same], d_cpu[same], rtol=1e-5)
        print(f"  search ef=128 seed_width=0 B={s.n_cpu}: {share:.4%} of "
              "(row, rank) ids equal the CPU backend's")
        _check(share >= 0.999, share)

        hnsw = server.hnsw
        adj0 = hnsw.host_adj()[0][: s.n]
        rng = np.random.default_rng(3)
        rows = np.nonzero((adj0 >= 0).any(axis=1))[0]
        rows = np.sort(rng.choice(rows, min(s.n_prune, len(rows)),
                                  replace=False)).astype(np.int32)
        cand = adj0[rows]
        kw = dict(M=server.slim_cfg.top_M0, keep_all_under_m=False)
        sel_dev, _ = prune_batch(hnsw.vectors, hnsw.vn, rows, cand,
                                 cand >= 0, **kw)
        with jax.default_device(cpu):
            sel_cpu, _ = prune_batch(
                jax.device_put(hnsw.vectors, cpu),
                jax.device_put(hnsw.vn, cpu), rows, cand, cand >= 0, **kw)
        sel_dev, sel_cpu = np.asarray(sel_dev), np.asarray(sel_cpu)
        differ = [r for r in range(len(rows))
                  if set(sel_dev[r].tolist()) != set(sel_cpu[r].tolist())]
        margins = [_prune_tie_margin(server.vectors_np, rows[r], cand[r])
                   for r in differ]
        print(f"  prune_batch {len(rows)} level-0 rows: "
              f"{len(rows) - len(differ)} kept sets equal the CPU backend's; "
              f"{len(differ)} differ, at tie margins (fp32 ulps of the norm "
              f"scale) {[round(m, 1) for m in margins]}")
        _check(len(differ) <= 0.001 * len(rows), differ)
        _check(all(m <= self.TIE_ULPS for m in margins), margins)

    # ---- 5 ------------------------------------------------------------
    @_phase("5 variants")
    def variants(self) -> None:
        import jax

        from hnsw_slim_tpu.config import SlimConfig
        from hnsw_slim_tpu.index.bruteforce import BruteForceIndex, exact_topk
        from hnsw_slim_tpu.index.slimq import HnswSlimQIndex
        from hnsw_slim_tpu.index.slimzero import HnswSlimZeroIndex
        from hnsw_slim_tpu.persist.patch import compute_diff
        from hnsw_slim_tpu.utils.data import manifold

        s, hnsw = self.s, self.server.hnsw
        mb, mq = manifold(s.slimq_n, s.dim, latent_dim=min(24, s.dim),
                          n_queries=s.n_queries, seed=7)
        t0 = time.perf_counter()
        q_idx = HnswSlimQIndex.build(mb)
        t_q = time.perf_counter() - t0
        q_idx.set_ef(128)
        _, ids = q_idx.search(mq, k=10, rerank=True)
        _, gt = BruteForceIndex(mb).search(mq, k=10)
        rec = _recall(ids, gt)
        print(f"  SlimQ {s.slimq_n} x {s.dim} manifold: build {t_q:.1f}s, "
              f"recall@10 ef=128 with rerank {rec:.4f}")
        _check(rec >= 0.80, rec)

        cfg = SlimConfig.from_ratios()
        t0 = time.perf_counter()
        zero = HnswSlimZeroIndex.from_hnsw(hnsw, cfg)
        t_zero = time.perf_counter() - t0
        # the same conversion on JAX's CPU backend
        cpu = jax.devices("cpu")[0]
        donor = copy.copy(hnsw)
        for name in ("graph", "vectors", "vn"):
            setattr(donor, name, jax.device_put(getattr(hnsw, name), cpu))
        with jax.default_device(cpu):
            zero_cpu = HnswSlimZeroIndex.from_hnsw(donor, cfg)
        changed, _ = compute_diff(zero.graph, zero_cpu.graph)
        same = 1.0 - len(changed) / hnsw.graph.n
        # the served graph now also holds the inserted vectors
        _, gt = exact_topk(hnsw.vectors, hnsw.vn, self.queries, k=10,
                           n_valid=hnsw.graph.n)
        zero.set_ef(384)
        rec = _recall(zero.search(self.queries, k=10)[1], gt)
        zero_cpu.graph = jax.device_put(zero_cpu.graph, jax.devices()[0])
        zero_cpu.vectors, zero_cpu.vn = hnsw.vectors, hnsw.vn
        zero_cpu.set_ef(384)
        rec_cpu = _recall(zero_cpu.search(self.queries, k=10)[1], gt)
        zero.scfg = dataclasses.replace(zero.scfg, seed_width=32)
        rec_seeded = _recall(zero.search(self.queries, k=10)[1], gt)
        print(f"  SlimZero from the served HNSW graph: convert {t_zero:.1f}s;"
              f" {same:.4%} of nodes identical to the CPU backend's "
              f"conversion; recall@10 ef=384 {rec:.4f} (CPU-converted graph "
              f"{rec_cpu:.4f}), with seed_width=32 {rec_seeded:.4f}")
        _check(same >= 0.999, same)
        _check(abs(rec - rec_cpu) <= 0.005, (rec, rec_cpu))
        # a floor under the 0.513-0.515 measured at 1M: unseeded SlimZero
        # is far below Slim at this scale, but must not fall further
        _check(rec >= 0.48, rec)
        _check(rec_seeded >= 0.90, rec_seeded)

    # ---- 6 ------------------------------------------------------------
    @_phase("6 memory")
    def memory(self) -> None:
        import jax

        stats = jax.devices()[0].memory_stats()
        peak = (stats or {}).get("peak_bytes_in_use")
        print(f"  peak_bytes_in_use: {peak if peak is not None else 'n/a'}")

    def shutdown(self) -> None:
        if self.server is not None:
            self.server.shutdown()

    # ---- --multi ------------------------------------------------------
    @_phase("multi")
    def multi(self) -> None:
        import jax

        from hnsw_slim_tpu.config import SearchConfig
        from hnsw_slim_tpu.index.bruteforce import BruteForceIndex
        from hnsw_slim_tpu.index.slim import HnswSlimIndex
        from hnsw_slim_tpu.parallel.sharded import (
            ShardedSlimIndex, check_matches_host_merge, make_mesh,
        )
        from hnsw_slim_tpu.utils.data import clustered

        s = self.s
        mesh = make_mesh(4)
        _check(dict(mesh.shape) == {"dp": 2, "shard": 2}, mesh.shape)
        n = 2 * s.shard_n
        base, queries = clustered(n, s.dim, n_queries=s.n_queries,
                                  n_clusters=max(64, n // 1000), seed=7,
                                  scale=0.3)
        scfg = SearchConfig(ef=128)
        shards = []
        t0 = time.perf_counter()
        for si in range(2):
            gids = np.arange(si, n, 2, dtype=np.int32)
            sub = HnswSlimIndex.build(base[gids])
            sub.scfg = scfg
            shards.append((sub, gids))
        print(f"  built 2 shards of {s.shard_n} in "
              f"{time.perf_counter() - t0:.1f}s")
        idx = ShardedSlimIndex.from_indexes(mesh, shards, search_cfg=scfg)
        for name, arr in idx.arrays.items():
            devs = {sh.device for sh in arr.addressable_shards}
            _check(len(devs) == 4, (name, devs))
        print(f"  stacked arrays on devices "
              f"{sorted(d.id for d in jax.devices()[:4])}")
        d, i = idx.search(queries, k=10)
        check_matches_host_merge(d, i, shards, queries, 10)
        _, gt = BruteForceIndex(base).search(queries, k=10)
        rec = _recall(i, gt)
        print(f"  mesh == host merge over {s.n_queries} queries; "
              f"recall@10 ef=128 {rec:.4f}")
        _check(rec >= 0.90, rec)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--multi", action="store_true",
                    help="run only the four-card ShardedSlimIndex phase")
    args = ap.parse_args(argv)

    import jax

    backend = jax.default_backend()
    if backend != "gpu" or jax.devices()[0].platform != "gpu":
        print(f"chip_smoke: needs a GPU; JAX's backend is {backend!r}",
              file=sys.stderr)
        return 2
    if args.multi and len(jax.devices()) < 4:
        print(f"chip_smoke --multi: needs 4 GPUs, found {len(jax.devices())}",
              file=sys.stderr)
        return 2

    from hnsw_slim_tpu.utils.compile_cache import enable_compile_cache

    print(f"compile cache: {enable_compile_cache()}", flush=True)
    smoke = Smoke()
    device = smoke.device()
    card = card_name_and_power()
    try:
        if args.multi:
            smoke.multi()
        else:
            smoke.data()
            smoke.serve(card)
            smoke.update()
            smoke.cpu_check()
            smoke.variants()
            smoke.memory()
    finally:
        smoke.shutdown()
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
