"""HTTP client: remote query + incremental index sync.

Counterpart of hnsw_client.cc (remote query + recall, :19-180) and
hnsw_slim_client_update(_patch).cc (batch insert + patch application,
:24-104 / :81-264): the client holds its own Slim index (arrays) and applies
binary patches received from the server.
"""

from __future__ import annotations

import http.client
import json
import zlib

import numpy as np

from ..persist import patch as patchlib
from . import wire


class SlimClient:
    def __init__(self, host: str = "127.0.0.1", port: int = 8080,
                 timeout: float = 120.0):
        self.host, self.port, self.timeout = host, port, timeout

    def _conn(self):
        return http.client.HTTPConnection(self.host, self.port,
                                          timeout=self.timeout)

    def _post(self, path: str, body: bytes, headers=None):
        c = self._conn()
        try:
            c.request("POST", path, body, headers or {})
            r = c.getresponse()
            data = r.read()
            if r.status != 200:
                raise RuntimeError(f"{path}: HTTP {r.status} {data[:200]!r}")
            return data, dict(r.getheaders())
        finally:
            c.close()

    def query(self, vector: np.ndarray, k: int = 10):
        req = wire.QueryRequest(vector=vector, k=k)
        data, _ = self._post("/query", wire.encode(req))
        resp = wire.decode(wire.QueryResponse, data)
        return resp.distances, np.asarray(resp.labels, np.int64)

    def set_ef(self, ef: int) -> bool:
        data, _ = self._post(
            "/setEf", wire.encode(wire.SetEfRequest(ef_search=ef))
        )
        resp = wire.decode(wire.SetEfResponse, data)
        return resp.status == "ok" and resp.new_ef_search == ef

    def update_index(self, ids, vectors: np.ndarray, compress: bool = True):
        """Send a vector batch; returns the first patch chunk + finished flag
        (zlib request compression mirrors hnsw_slim_client_update.cc:83-84)."""
        body = wire.encode(wire.UpdateIndexRequest(vectors=[
            wire.VectorData(id=int(i), vector=v) for i, v in zip(ids, vectors)
        ]))
        headers = {}
        if compress:
            body = zlib.compress(body)
            headers["Content-Encoding"] = "deflate"
        data, h = self._post("/updateIndex", body, headers)
        return data, h.get("X-Patch-Finished") == "1"

    def get_last_batch(self):
        c = self._conn()
        try:
            c.request("GET", "/getLastBatch")
            r = c.getresponse()
            data = r.read()
            return data, r.getheader("X-Patch-Finished") == "1"
        finally:
            c.close()

    def bootstrap(self):
        """Fetch the server's full slim index (fresh-client join)."""
        import io as _io

        from ..persist import checkpoint as _cp

        c = self._conn()
        try:
            c.request("GET", "/getIndex")
            r = c.getresponse()
            data = r.read()
        finally:
            c.close()
        return _cp.load_slim(_io.BytesIO(data))

    def get_vectors(self, start: int, count: int):
        import http.client as _hc  # noqa: F401

        c = self._conn()
        try:
            c.request("GET", f"/getVectors?start={start}&count={count}")
            r = c.getresponse()
            data = r.read()
            dim = int(r.getheader("X-Dim"))
            n = int(r.getheader("X-Count"))
        finally:
            c.close()
        return np.frombuffer(data, np.float32).reshape(n, dim)

    def mark_delete(self, ids) -> int:
        data, _ = self._post(
            "/markDelete", json.dumps([int(i) for i in ids]).encode()
        )
        return json.loads(data)["deleted"]

    def sync_patches(self, local_index, first_chunk: bytes,
                     first_finished: bool):
        """Apply the first patch chunk then drain /getLastBatch until done
        (hnsw_slim_client_update_patch.cc:177-190)."""
        vecs = np.asarray(local_index.vectors)
        graph = local_index.graph
        graph, vecs = patchlib.apply_patch(graph, first_chunk, vecs)
        finished = first_finished
        while not finished:
            blob, finished = self.get_last_batch()
            if not blob:
                break
            graph, vecs = patchlib.apply_patch(graph, blob, vecs)
        import jax.numpy as jnp

        from ..ops import distance

        local_index.graph = graph
        local_index.vectors = jnp.asarray(vecs)
        local_index.vn = distance.sq_norms(local_index.vectors)
        if getattr(local_index, "dense0", None) is not None:
            # the dense serving layout must track the patched graph
            local_index.densify_level0()
        return local_index
