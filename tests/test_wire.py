"""Proto3 wire codec (serve/wire.py) against bytes protobuf itself wrote.

The golden bytes were serialized by the protobuf runtime from
serve/query.proto; the codec must write them byte for byte and read them
back, so clients built against the reference's query.proto interoperate.
"""

import subprocess
import sys

import numpy as np
import pytest

from hnsw_slim_tpu.serve import wire as w

GOLDEN = [
    ("QueryRequest", w.QueryRequest(vector=[1.0, -2.5, 0.125], k=7),
     b"\n\x0c\x00\x00\x80?\x00\x00 \xc0\x00\x00\x00>\x10\x07"),
    ("QueryRequest_negative_k", w.QueryRequest(vector=[0.5], k=-3),
     b"\n\x04\x00\x00\x00?\x10\xfd\xff\xff\xff\xff\xff\xff\xff\xff\x01"),
    ("QueryResponse",
     w.QueryResponse(labels=[3, -1, 1000000],
                     distances=[0.5, 1.5, float("inf")]),
     b"\n\x0e\x03\xff\xff\xff\xff\xff\xff\xff\xff\xff\x01\xc0\x84=\x12\x0c"
     b"\x00\x00\x00?\x00\x00\xc0?\x00\x00\x80\x7f"),
    ("SetEfRequest", w.SetEfRequest(ef_search=384), b"\x08\x80\x03"),
    ("SetEfResponse", w.SetEfResponse(status="ok", new_ef_search=384),
     b"\n\x02ok\x10\x80\x03"),
    ("VectorData", w.VectorData(id=-42, vector=[1.0, 2.0]),
     b"\x08\xd6\xff\xff\xff\xff\xff\xff\xff\xff\x01\x12\x08\x00\x00\x80?"
     b"\x00\x00\x00@"),
    ("UpdateIndexRequest",
     w.UpdateIndexRequest(vectors=[w.VectorData(id=5, vector=[1.0]),
                                   w.VectorData(id=2**40),
                                   w.VectorData()]),
     b"\n\x08\x08\x05\x12\x04\x00\x00\x80?\n\x07\x08\x80\x80\x80\x80\x80 "
     b"\n\x00"),
]
MESSAGES = [w.QueryRequest, w.QueryResponse, w.SetEfRequest, w.SetEfResponse,
            w.VectorData, w.UpdateIndexRequest]


def _same(a, b):
    """Field-by-field equality (float fields compare as arrays)."""
    assert type(a) is type(b)
    for name in a.__dataclass_fields__:
        x, y = getattr(a, name), getattr(b, name)
        if isinstance(x, list) and x and not isinstance(x[0], (int, float)):
            assert len(x) == len(y)
            for u, v in zip(x, y):
                _same(u, v)
        elif isinstance(x, (list, np.ndarray)) or isinstance(y, np.ndarray):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
        else:
            assert x == y, (name, x, y)


@pytest.mark.parametrize("name,msg,blob", GOLDEN, ids=[g[0] for g in GOLDEN])
def test_encode_matches_protobuf_bytes(name, msg, blob):
    assert w.encode(msg) == blob


@pytest.mark.parametrize("name,msg,blob", GOLDEN, ids=[g[0] for g in GOLDEN])
def test_decode_roundtrip(name, msg, blob):
    back = w.decode(type(msg), blob)
    _same(back, msg)
    assert w.encode(back) == blob


@pytest.mark.parametrize("cls", MESSAGES, ids=lambda c: c.__name__)
def test_empty_message(cls):
    assert w.encode(cls()) == b""
    _same(w.decode(cls, b""), cls())


@pytest.mark.parametrize("blob,k", [
    # unpacked (one fixed32 record per float), as proto2 writers emit them
    (b"\x0d\x00\x00\x80\x3f\x0d\x00\x00\x00\x40\x10\x05", 5),
    # packed and unpacked runs of the same field concatenate
    (b"\n\x04\x00\x00\x80\x3f\x0d\x00\x00\x00\x40\x10\x05", 5),
])
def test_packed_and_unpacked_floats(blob, k):
    msg = w.decode(w.QueryRequest, blob)
    np.testing.assert_array_equal(msg.vector, np.float32([1.0, 2.0]))
    assert msg.vector.dtype == np.float32 and msg.k == k


def test_unpacked_repeated_ints():
    msg = w.decode(w.QueryResponse, b"\x08\x03\x08\xff\xff\xff\xff\xff\xff"
                                    b"\xff\xff\xff\x01")
    assert msg.labels == [3, -1]


@pytest.mark.parametrize("blob", [
    # varint #3, bytes #4, fixed64 #5, fixed32 #6 around a known field
    b"\x18\x96\x01\x22\x02ab\x29" + b"\x00" * 8 + b"\x35" + b"\x00" * 4
    + b"\x10\x05",
    # a known field number with a foreign wire type is skipped, as protobuf
    # keeps it among the unknown fields
    b"\x12\x01\x07\x10\x05",
])
def test_unknown_fields_skipped(blob):
    msg = w.decode(w.QueryRequest, blob)
    assert msg.k == 5 and msg.vector.size == 0


def test_truncated_message_rejected():
    with pytest.raises(ValueError):
        w.decode(w.QueryRequest, b"\n\x0c\x00\x00\x80?")


def test_serving_imports_without_protobuf():
    code = ("import sys; sys.modules['google'] = None; "
            "import hnsw_slim_tpu.serve.server, hnsw_slim_tpu.serve.client")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=300)
