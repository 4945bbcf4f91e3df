"""HTTP serving daemon: query + incremental-update protocol.

Counterpart of hnsw_slim_server.cc / hnsw_slim_server_patch.cc:
the server owns the mutable vanilla HNSW plus its Slim mirror; /updateIndex
inserts a batch, re-prunes the whole graph, and ships only the changed-node
patch; /getLastBatch streams size-limited patch chunks with a finished flag
(hnsw_slim_server_patch.cc:253-296). Wire messages are proto3
(serve/query.proto, coded by serve/wire.py); patches are the binary record
stream from persist/patch.

Queries are micro-batched: concurrent /query requests within a small window
are fused into one device call (the reference serves one query per request,
hnsw_server.cc:69-96 — batching keeps the device busy).
"""

from __future__ import annotations

import json
import threading
import time
import zlib
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import jax.numpy as jnp
import numpy as np

from ..config import HnswConfig, SlimConfig
from ..index.hnsw import HnswIndex
from ..index.slim import HnswSlimIndex
from ..persist import patch as patchlib
from . import wire


class _Batcher:
    """Fuse concurrent single-query requests into one device call."""

    def __init__(self, index, window_ms: float = 2.0, max_batch: int = 256):
        self.index = index
        self.window = window_ms / 1e3
        self.max_batch = max_batch
        self.lock = threading.Lock()
        self.pending: list = []
        self.cv = threading.Condition(self.lock)
        # live-delete filter, applied IN-KERNEL (FilterTrack k-guarantee)
        self.filter_mask: np.ndarray | None = None

    def query(self, vec: np.ndarray, k: int):
        slot = {"vec": vec, "k": k, "done": threading.Event(), "out": None}
        with self.lock:
            self.pending.append(slot)
            leader = len(self.pending) == 1
        if leader:
            time.sleep(self.window)
            with self.lock:
                batch, self.pending = self.pending, []
            kmax = max(s["k"] for s in batch)
            q = np.stack([s["vec"] for s in batch])
            d, i = self.index.search(q, k=kmax, filter_mask=self.filter_mask)
            for r, s in enumerate(batch):
                s["out"] = (d[r, : s["k"]], i[r, : s["k"]])
                s["done"].set()
        slot["done"].wait(timeout=60.0)
        if slot["out"] is None:  # leader raced away without us; run solo
            d, i = self.index.search(vec[None], k=k,
                                     filter_mask=self.filter_mask)
            return d[0], i[0]
        return slot["out"]


class SlimServer:
    # host-mirror growth quantum (rows). 262144 x 128 f32 = 134 MB: one
    # ~20 s page-fault hit per ~260 warm 1000-vector batches instead of a
    # full-mirror re-fault every batch.
    HOST_GROW = 262144

    def __init__(
        self,
        base_vectors: np.ndarray,
        hnsw_cfg: HnswConfig | None = None,
        slim_cfg: SlimConfig | None = None,
        build_strategy: str = "auto",
        host: str = "0.0.0.0",
        port: int = 8080,
        patch_chunk_bytes: int = 200 * 1024 * 1024,  # hnsw_slim_server_patch.cc:154
        serve_index: str = "slim",  # "slim" (hnsw_slim_server.cc),
        # "hnsw" (hnsw_server.cc — serve the unpruned graph directly), or
        # "slimzero" (in-degree-guarded conversion, hnswalg_slimzero.h)
        dense0: bool = True,  # dense level-0 serving layout (+~25% QPS;
        # maintained incrementally across /updateIndex via update_dense0)
    ):
        self.hnsw_cfg = hnsw_cfg or HnswConfig()
        self.slim_cfg = slim_cfg or SlimConfig.from_ratios()
        self.serve_index = serve_index
        # wall seconds of each start-up step (build, convert, prewarm,
        # layouts); set-up costs, reported beside the serving metrics
        self.setup_seconds: dict[str, float] = {}
        t0 = time.perf_counter()
        if isinstance(base_vectors, HnswIndex):
            # take over an already-built index as the mutable serving state
            # (e.g. a reference-built graph via graph.import_ref)
            self.hnsw = base_vectors
            self.hnsw_cfg = self.hnsw.cfg
        else:
            self.hnsw = HnswIndex(self.hnsw_cfg, strategy=build_strategy)
            self.hnsw.build(np.asarray(base_vectors, np.float32))
        self.setup_seconds["build"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        # stateful conversion: /updateIndex re-prunes only touched nodes
        # (the reference re-runs convertFromHNSWWithDiff over the whole
        # graph, hnswalg_slim.h:1110-1424 — same output, less work).
        # serve_index="slimzero" swaps in the in-degree-guarded converter
        # (hnswalg_slimzero.h:1590-1660 WithDiff counterpart).
        from ..graph.incremental import IncrementalSlim, IncrementalSlimZero

        inc_cls = (IncrementalSlimZero if serve_index == "slimzero"
                   else IncrementalSlim)
        self.inc = inc_cls(self.slim_cfg, metric=self.hnsw.cfg.metric)
        chal = self.inc.full(
            self.hnsw.host_adj(), np.asarray(self.hnsw.levels),
            int(np.asarray(self.hnsw.graph.entry)),
            self.hnsw.vectors, self.hnsw.vn,
        )
        self.setup_seconds["convert"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        if self.hnsw.graph.n >= 200_000 and hasattr(self.inc, "prewarm"):
            # compile every cap-reprune width bucket NOW (one-time, during
            # startup) so no warm /updateIndex batch pays a fresh-shape
            # compile
            self.inc.prewarm(self.hnsw.vectors, self.hnsw.vn)
        self.setup_seconds["prewarm"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        self.slim = HnswSlimIndex(metric=self.hnsw.cfg.metric)
        # serve a node-padded graph so the compiled search survives growth
        # across /updateIndex (same traversal; padding rows unreachable);
        # the unpadded graph stays the persistence/patch source of truth
        from ..graph.types import pad_chal_nodes

        self.chal_unpadded = chal
        self.node_bucket = max(4096, 1 << max(0, (chal.n - 1).bit_length() - 4))
        self.slim.graph = pad_chal_nodes(chal, self.node_bucket)
        self.slim.vectors = self.hnsw.vectors
        self.slim.vn = self.hnsw.vn
        if dense0 and serve_index != "hnsw":
            self.slim.host_chal = getattr(self.inc, "host_chal", None)
            self.slim.densify_level0()
            self.slim.densify_upper()
        self.setup_seconds["layouts"] = time.perf_counter() - t0
        # host vector mirror for patch encoding (no device->host round trip).
        # Capacity-bucketed buffers with logical-length views: a fresh
        # np.concatenate per /updateIndex batch re-faulted the whole ~512 MB
        # mirror on this hypervisor-backed host (~30 s/batch of the measured
        # warm insert time); growth now touches only the appended rows, with
        # one amortized realloc per HOST_GROW inserts.
        n0 = self.hnsw.graph.n
        cap0 = n0 + self.HOST_GROW
        self._vec_buf = np.empty((cap0, self.hnsw.vectors.shape[1]),
                                 np.float32)
        self._vec_buf[:n0] = np.asarray(self.hnsw.vectors)[:n0]
        self._del_buf = np.zeros(cap0, bool)
        # external label layer (reference label_lookup_): internal slot ->
        # label; deleted slots are reused by later inserts (replace_deleted)
        self._lab_buf = np.arange(cap0, dtype=np.int64)
        self.vectors_np = self._vec_buf[:n0]
        self.deleted = self._del_buf[:n0]
        self.labels = self._lab_buf[:n0]
        self.next_label = int(self.hnsw.graph.n)
        self.lock = threading.Lock()
        self.batcher = _Batcher(
            self.hnsw if serve_index == "hnsw" else self.slim
        )
        self.pending_writer: patchlib.PatchWriter | None = None
        self.patch_chunk_bytes = patch_chunk_bytes
        # cumulative /query phase costs (reference hnsw_server.cc:41-95)
        self.query_cost = {"parse": 0.0, "search": 0.0, "serialize": 0.0,
                           "resp": 0.0, "n": 0}
        self.host, self.port = host, port
        self._httpd = None

    def _ensure_host_capacity(self, n: int) -> None:
        """Grow the host mirrors to >= n rows (amortized; see HOST_GROW)."""
        cap = len(self._vec_buf)
        if n <= cap:
            return
        new_cap = -(-n // self.HOST_GROW) * self.HOST_GROW + self.HOST_GROW
        live = len(self.vectors_np)
        vb = np.empty((new_cap, self._vec_buf.shape[1]), np.float32)
        vb[:live] = self._vec_buf[:live]
        db = np.zeros(new_cap, bool)
        db[:live] = self._del_buf[:live]
        lb = np.empty(new_cap, np.int64)
        lb[:live] = self._lab_buf[:live]
        self._vec_buf, self._del_buf, self._lab_buf = vb, db, lb
        self.vectors_np = vb[:live]
        self.deleted = db[:live]
        self.labels = lb[:live]

    # ---- operations -------------------------------------------------

    def query(self, vec: np.ndarray, k: int):
        # deleted nodes are excluded by the in-kernel allowed-track (the
        # reference's isMarkedDeleted check inside searchBaseLayerST), so a
        # query still returns k live results even under heavy delete load
        self.batcher.filter_mask = ~self.deleted if self.deleted.any() else None
        d, i = self.batcher.query(vec, k)
        out = np.where(i >= 0, self.labels[np.maximum(i, 0)], -1)
        return d, out

    def set_ef(self, ef: int) -> None:
        self.slim.set_ef(ef)
        self.hnsw.set_ef(ef)

    def update_index(self, new_vectors: np.ndarray,
                     new_labels=None) -> patchlib.PatchWriter:
        """Insert + incremental re-prune + diff (hnsw_slim_server.cc:115-142,
        here via graph/incremental.py instead of a whole-graph pass).
        Deleted slots are reused first (replace_deleted=true, deferred
        reinsert — hnsw_slim_server_patch.cc:268-270); the rest append."""
        import os
        import time as _time

        timing = os.environ.get("SLIM_TIMING")
        t0 = _time.perf_counter()
        with self.lock:
            new_vectors = np.asarray(new_vectors, np.float32)
            if new_labels is None:
                new_labels = range(
                    self.next_label, self.next_label + len(new_vectors)
                )
            new_labels = np.asarray(list(new_labels), np.int64)
            prev_count = self.hnsw.graph.n

            free = np.nonzero(self.deleted)[0]
            n_reuse = min(len(free), len(new_vectors))
            reused = free[:n_reuse]
            touched = [np.asarray(reused, np.int64)]
            level_changed = np.zeros(0, np.int64)
            if n_reuse:
                t_rp = _time.perf_counter()
                t, level_changed = self.hnsw.replace_points(
                    reused, new_vectors[:n_reuse]
                )
                if timing:
                    print(f"  srv timing: replace_points="
                          f"{_time.perf_counter()-t_rp:.2f}s", flush=True)
                touched.append(t)
                self.vectors_np[reused] = new_vectors[:n_reuse]
                self.labels[reused] = new_labels[:n_reuse]
                self.deleted[reused] = False
            if n_reuse < len(new_vectors):
                t_ap = _time.perf_counter()
                touched.append(self.hnsw.add_points(new_vectors[n_reuse:]))
                if timing:
                    print(f"  srv timing: add_points call="
                          f"{_time.perf_counter()-t_ap:.2f}s", flush=True)
                t_cc = _time.perf_counter()
                n_now = self.hnsw.graph.n
                self._ensure_host_capacity(n_now)
                self._vec_buf[prev_count:n_now] = new_vectors[n_reuse:]
                self._lab_buf[prev_count:n_now] = new_labels[n_reuse:]
                self._del_buf[prev_count:n_now] = False
                self.vectors_np = self._vec_buf[:n_now]
                self.labels = self._lab_buf[:n_now]
                self.deleted = self._del_buf[:n_now]
                if timing:
                    print(f"  srv timing: host_grow="
                          f"{_time.perf_counter()-t_cc:.2f}s", flush=True)
            self.next_label = max(
                self.next_label, int(new_labels.max(initial=0)) + 1
            )
            if timing:
                print(f"  srv timing: insert={_time.perf_counter()-t0:.2f}s",
                      flush=True)
                t0 = _time.perf_counter()

            t_ha = _time.perf_counter()
            adj = self.hnsw.host_adj()
            if timing:
                print(f"  srv timing: host_adj="
                      f"{_time.perf_counter()-t_ha:.2f}s", flush=True)
            # dense serving layouts for BOTH level-0 and the upper levels
            # mean the device never reads the flat CHAL arrays — the
            # re-prune packs to host numpy only (device_pack=False) and the
            # serving graph carries tiny device placeholders. This removes
            # the ~130 MB nbr+lvl_off re-upload that was the largest single
            # term of the warm /updateIndex at 1M.
            host_mode = (
                self.slim.dense0 is not None
                and self.slim.dense_up is not None
                and getattr(self.inc, "host_chal", None) is not None
            )
            chal, changed = self.inc.update(
                adj, np.asarray(self.hnsw.levels),
                int(np.asarray(self.hnsw.graph.entry)),
                self.hnsw.vectors, self.hnsw.vn,
                touched=np.concatenate(touched),
                level_changed=level_changed,
                device_pack=not host_mode,
            )
            from ..graph.types import pad_chal_nodes

            t_pd = _time.perf_counter()
            self.chal_unpadded = chal
            if host_mode:
                import dataclasses as _dc

                hc = self.inc.host_chal
                n = chal.n
                # host arrays carry the hnsw capacity padding (level -1
                # rows); the serving pad mirrors pad_chal_nodes: round the
                # ARRAY length up to the node bucket
                n_src = len(hc["level"])
                n_pad = -(-n_src // self.node_bucket) * self.node_bucket
                lvl_pad = np.full(n_pad, -1, np.int32)
                lvl_pad[:n_src] = hc["level"]
                if getattr(self, "_ph", None) is None:
                    self._ph = (jnp.zeros(8, jnp.int32),
                                jnp.zeros((8, 8), jnp.int32))
                self.slim.graph = _dc.replace(
                    chal, nbr=self._ph[0], lvl_off=self._ph[1],
                    level=jnp.asarray(lvl_pad), n_real=n,
                )
                self.slim.host_chal = hc
            else:
                self.slim.graph = pad_chal_nodes(chal, self.node_bucket)
                self.slim.host_chal = None
            self.slim.vectors = self.hnsw.vectors
            self.slim.vn = self.hnsw.vn
            if self.slim.dense0 is not None:
                host_chal = getattr(self.inc, "host_chal", None)
                if host_chal is not None:
                    # scatter only rows whose CHAL content changed (plus
                    # appended and reused slots) instead of re-uploading
                    # the whole [N, cap0] layout (256 MB of H2D at 1M)
                    upd_ids = np.concatenate([
                        changed,
                        np.arange(prev_count, self.hnsw.graph.n,
                                  dtype=np.int64),
                        np.asarray(reused, np.int64),
                    ])
                    self.slim.update_dense0(host_chal, upd_ids)
                    if self.slim.dense_up is not None:
                        self.slim.update_dense_upper(host_chal, upd_ids)
                else:
                    self.slim.densify_level0()
                    if self.slim.dense_up is not None:
                        self.slim.densify_upper()
            if timing:
                print(f"  srv timing: pad+densify="
                      f"{_time.perf_counter()-t_pd:.2f}s", flush=True)
            t_pw = _time.perf_counter()
            self.batcher.index = (
                self.hnsw if self.serve_index == "hnsw" else self.slim
            )
            # reused slots must ship their new vectors: classify as new
            reused_set = set(int(v) for v in reused)
            changed_old = sorted(
                int(v) for v in changed
                if v < prev_count and int(v) not in reused_set
            )
            changed_new = sorted(
                set(range(prev_count, self.hnsw.graph.n)) | reused_set
            )
            writer = patchlib.PatchWriter(
                self.chal_unpadded, changed_old, changed_new,
                vectors=self.vectors_np,
                host_chal=getattr(self.inc, "host_chal", None),
            )
            self.pending_writer = writer
            if timing:
                print(f"  srv timing: patch_writer="
                      f"{_time.perf_counter()-t_pw:.2f}s", flush=True)
                print(f"  srv timing: reprune+patch="
                      f"{_time.perf_counter()-t0:.2f}s", flush=True)
            return writer

    def mark_delete(self, labels) -> int:
        """markDelete by external label (hnsw_slim_server_patch.cc:230-241)."""
        with self.lock:
            want = set(int(x) for x in labels)
            ids = np.nonzero(np.isin(self.labels, list(want)))[0]
            self.deleted[ids] = True
            return int(len(ids))

    # ---- HTTP -------------------------------------------------------

    def serve_forever(self):
        server = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):
                pass

            def _body(self):
                length = int(self.headers.get("Content-Length", 0))
                data = self.rfile.read(length)
                if self.headers.get("Content-Encoding") == "deflate":
                    data = zlib.decompress(data)
                return data

            def _send(self, data: bytes, ctype="application/octet-stream",
                      extra=None):
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(data)))
                for k, v in (extra or {}).items():
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(data)

            def do_POST(self):
                try:
                    if self.path == "/query":
                        # per-phase counters, reference hnsw_server.cc:41-95
                        # (parse/search/resp/serialize; cumulative print
                        # every 10k queries)
                        import time as _t

                        t0 = _t.perf_counter()
                        req = wire.decode(wire.QueryRequest, self._body())
                        t1 = _t.perf_counter()
                        d, i = server.query(req.vector, req.k or 10)
                        t2 = _t.perf_counter()
                        blob = wire.encode(wire.QueryResponse(
                            labels=[int(x) for x in i], distances=d,
                        ))
                        t3 = _t.perf_counter()
                        self._send(blob)
                        c = server.query_cost
                        c["parse"] += t1 - t0
                        c["search"] += t2 - t1
                        c["serialize"] += t3 - t2
                        c["resp"] += _t.perf_counter() - t3
                        c["n"] += 1
                        if c["n"] % 10000 == 0:
                            print(
                                f"query {c['n']}: parse={c['parse']:.2f}s "
                                f"search={c['search']:.2f}s "
                                f"serialize={c['serialize']:.2f}s "
                                f"resp={c['resp']:.2f}s (cumulative)",
                                flush=True,
                            )
                    elif self.path == "/setEf":
                        req = wire.decode(wire.SetEfRequest, self._body())
                        server.set_ef(req.ef_search)
                        self._send(wire.encode(wire.SetEfResponse(
                            status="ok", new_ef_search=req.ef_search
                        )))
                    elif self.path == "/updateIndex":
                        req = wire.decode(wire.UpdateIndexRequest,
                                          self._body())
                        vecs = np.asarray(
                            [v.vector for v in req.vectors], np.float32
                        )
                        ids = [v.id for v in req.vectors]
                        # proto3 default id=0 for every entry means the
                        # client did not set ids: let the server assign
                        if all(i == 0 for i in ids):
                            ids = None
                        writer = server.update_index(vecs, new_labels=ids)
                        blob, finished = writer.next_chunk(
                            server.patch_chunk_bytes
                        )
                        self._send(blob, extra={"X-Patch-Finished": str(int(finished))})
                    elif self.path == "/markDelete":
                        ids = json.loads(self._body())
                        n = server.mark_delete(ids)
                        self._send(json.dumps({"deleted": n}).encode(),
                                   "application/json")
                    else:
                        self.send_error(404)
                except Exception as e:  # pragma: no cover
                    self.send_error(500, str(e))

            def do_GET(self):
                if self.path.startswith("/getIndex"):
                    # client bootstrap: the full slim checkpoint (the
                    # reference ships the initial index file out-of-band)
                    import io as _io

                    from ..index.slim import HnswSlimIndex as _HSI
                    from ..persist import checkpoint as _cp
                    buf = _io.BytesIO()
                    logical = _HSI(metric=server.slim.metric)
                    logical.graph = server.chal_unpadded  # no serving padding
                    logical.vectors = server.slim.vectors
                    logical.vn = server.slim.vn
                    _cp.save_slim(buf, logical)
                    self._send(buf.getvalue())
                elif self.path.startswith("/getVectors"):
                    # bulk raw-vector range (putVector/getVectorFromBatch,
                    # hnswalg_slim.h:2254-2290)
                    from urllib.parse import parse_qs, urlparse

                    q = parse_qs(urlparse(self.path).query)
                    start = int(q.get("start", ["0"])[0])
                    count = int(q.get("count", ["65536"])[0])
                    end = min(start + count, server.slim.graph.n)
                    arr = np.asarray(server.slim.vectors)[start:end]
                    self._send(
                        np.ascontiguousarray(arr, np.float32).tobytes(),
                        extra={"X-Dim": str(arr.shape[1]),
                               "X-Count": str(arr.shape[0])},
                    )
                elif self.path == "/getLastBatch":
                    w = server.pending_writer
                    if w is None:
                        self._send(b"", extra={"X-Patch-Finished": "1"})
                        return
                    blob, finished = w.next_chunk(server.patch_chunk_bytes)
                    if finished:
                        server.pending_writer = None
                    self._send(blob, extra={"X-Patch-Finished": str(int(finished))})
                elif self.path == "/stats":
                    self._send(
                        json.dumps({
                            "n": int(server.hnsw.graph.n),
                            "index_bytes": server.slim.index_size(),
                        }).encode(),
                        "application/json",
                    )
                else:
                    self.send_error(404)

        self._httpd = ThreadingHTTPServer((self.host, self.port), Handler)
        self._httpd.serve_forever()

    def start_background(self):
        t = threading.Thread(target=self.serve_forever, daemon=True)
        t.start()
        while self._httpd is None:
            time.sleep(0.01)
        return t

    def shutdown(self):
        if self._httpd:
            self._httpd.shutdown()
