"""Proto3 wire codec for the six messages of serve/query.proto.

Hand-written so that the serving path needs no protobuf runtime. Encoding
follows the proto3 rules that protoc-generated code follows, so the bytes are
identical: fields in field-number order, scalars at their default value left
out, repeated scalars packed. Decoding also accepts unpacked repeated scalars
(proto2 writers) and skips fields it does not know, as protobuf does.

Repeated floats decode to float32 numpy arrays; repeated integers to lists.
"""

from __future__ import annotations

import dataclasses

import numpy as np

_VARINT, _I64, _LEN, _I32 = 0, 1, 2, 5
_MASK64 = (1 << 64) - 1


@dataclasses.dataclass
class QueryRequest:
    vector: np.ndarray | list = dataclasses.field(default_factory=list)
    k: int = 0


@dataclasses.dataclass
class QueryResponse:
    labels: list = dataclasses.field(default_factory=list)
    distances: np.ndarray | list = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class SetEfRequest:
    ef_search: int = 0


@dataclasses.dataclass
class SetEfResponse:
    status: str = ""
    new_ef_search: int = 0


@dataclasses.dataclass
class VectorData:
    id: int = 0
    vector: np.ndarray | list = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class UpdateIndexRequest:
    vectors: list = dataclasses.field(default_factory=list)


# (field number, attribute, type, repeated) per message, as in query.proto
_SCHEMA = {
    QueryRequest: ((1, "vector", "float", True), (2, "k", "int32", False)),
    QueryResponse: ((1, "labels", "int32", True),
                    (2, "distances", "float", True)),
    SetEfRequest: ((1, "ef_search", "int32", False),),
    SetEfResponse: ((1, "status", "string", False),
                    (2, "new_ef_search", "int32", False)),
    VectorData: ((1, "id", "int64", False), (2, "vector", "float", True)),
    UpdateIndexRequest: ((1, "vectors", VectorData, True),),
}
_BITS = {"int32": 32, "int64": 64}


def _varint(v: int) -> bytes:
    v &= _MASK64  # negative ints take ten bytes, as in protobuf
    out = bytearray()
    while v >= 0x80:
        out.append((v & 0x7F) | 0x80)
        v >>= 7
    out.append(v)
    return bytes(out)


def _read_varint(data: bytes, pos: int) -> tuple[int, int]:
    v = shift = 0
    while True:
        if pos >= len(data) or shift > 63:
            raise ValueError("truncated or overlong varint")
        b = data[pos]
        pos += 1
        v |= (b & 0x7F) << shift
        if b < 0x80:
            return v & _MASK64, pos
        shift += 7


def _signed(v: int, bits: int) -> int:
    v &= (1 << bits) - 1
    return v - (1 << bits) if v >> (bits - 1) else v


def _len_field(num: int, body: bytes) -> bytes:
    return _varint(num << 3 | _LEN) + _varint(len(body)) + body


def encode(msg) -> bytes:
    """Serialize a message dataclass to proto3 wire bytes."""
    out = bytearray()
    for num, name, kind, repeated in _SCHEMA[type(msg)]:
        val = getattr(msg, name)
        if kind == "float":
            arr = np.asarray(val, "<f4")
            if arr.size:
                out += _len_field(num, arr.tobytes())
        elif not repeated and kind in _BITS:
            if val:
                out += _varint(num << 3 | _VARINT) + _varint(int(val))
        elif kind in _BITS:
            if len(val):
                out += _len_field(num, b"".join(_varint(int(x)) for x in val))
        elif kind == "string":
            if val:
                out += _len_field(num, val.encode("utf-8"))
        else:
            for sub in val:
                out += _len_field(num, encode(sub))
    return bytes(out)


def _skip(data: bytes, pos: int, wire_type: int) -> int:
    if wire_type == _VARINT:
        return _read_varint(data, pos)[1]
    if wire_type == _I64:
        return pos + 8
    if wire_type == _I32:
        return pos + 4
    if wire_type == _LEN:
        n, pos = _read_varint(data, pos)
        return pos + n
    raise ValueError(f"unsupported wire type {wire_type}")


def decode(cls, data: bytes):
    """Parse proto3 wire bytes into an instance of message class `cls`."""
    fields = {num: (name, kind, rep) for num, name, kind, rep in _SCHEMA[cls]}
    msg = cls()
    floats: dict[str, list] = {}
    pos, end = 0, len(data)
    while pos < end:
        key, pos = _read_varint(data, pos)
        num, wt = key >> 3, key & 7
        name, kind, repeated = fields.get(num, (None, None, False))
        if kind == "float" and wt in (_LEN, _I32):
            if wt == _LEN:
                n, pos = _read_varint(data, pos)
            else:
                n = 4
            if n % 4 or pos + n > end:
                raise ValueError(f"bad float field {name}")
            floats.setdefault(name, []).append(
                np.frombuffer(data, "<f4", n // 4, pos))
            pos += n
        elif kind in _BITS and (wt == _VARINT or (wt == _LEN and repeated)):
            if wt == _VARINT:
                raw, pos = _read_varint(data, pos)
                items = [raw]
            else:
                n, pos = _read_varint(data, pos)
                stop, items = pos + n, []
                while pos < stop:
                    raw, pos = _read_varint(data, pos)
                    items.append(raw)
            items = [_signed(v, _BITS[kind]) for v in items]
            if repeated:
                getattr(msg, name).extend(items)
            else:
                setattr(msg, name, items[-1])  # last one wins
        elif kind is not None and not isinstance(kind, str) and wt == _LEN:
            n, pos = _read_varint(data, pos)
            getattr(msg, name).append(decode(kind, data[pos:pos + n]))
            pos += n
        elif kind == "string" and wt == _LEN:
            n, pos = _read_varint(data, pos)
            setattr(msg, name, bytes(data[pos:pos + n]).decode("utf-8"))
            pos += n
        else:  # unknown field, or a known one with a foreign wire type
            pos = _skip(data, pos, wt)
        if pos > end:
            raise ValueError("truncated message")
    for name, parts in floats.items():
        setattr(msg, name, np.concatenate(parts).astype(np.float32))
    for _, name, kind, _ in _SCHEMA[cls]:
        if kind == "float" and name not in floats:
            setattr(msg, name, np.zeros(0, np.float32))
    return msg
