"""Minimal ONNX weight reader and writer, no ``onnx`` package (the port's
copy of ``obs_rvc_tpu/models/onnx_reader.py``).

Users migrating from the reference plugin hold ``.onnx`` artifacts
(``vec-{256,768}-layer-*.onnx``, ``rmvpe.onnx``, the RVC model), not torch
checkpoints. This module parses the protobuf wire format directly and
returns the graph initializers as ``{name: ndarray}``: for torch-exported
models the initializer names are the state-dict names, so
``models/checkpoints.py`` loads them like a ``.pth``. ``build_index`` also
writes retrieval tables in this container.

Wire-format subset (ONNX proto3):

- ``ModelProto.graph``        = field 7 (message)
- ``GraphProto.initializer``  = field 5 (repeated TensorProto)
- ``TensorProto``: ``dims``=1 (int64), ``data_type``=2, ``float_data``=4,
  ``int32_data``=5, ``int64_data``=7, ``name``=8, ``raw_data``=9,
  ``double_data``=10
"""

from __future__ import annotations

import pathlib
from typing import Iterator

import numpy as np

# TensorProto.DataType
_DTYPES = {
    1: np.dtype("<f4"),    # FLOAT
    2: np.dtype("<u1"),    # UINT8
    3: np.dtype("<i1"),    # INT8
    6: np.dtype("<i4"),    # INT32
    7: np.dtype("<i8"),    # INT64
    10: np.dtype("<f2"),   # FLOAT16
    11: np.dtype("<f8"),   # DOUBLE
}


def _read_varint(buf: memoryview, pos: int) -> tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _fields(buf: memoryview) -> Iterator[tuple[int, int, memoryview | int]]:
    """Yield (field_number, wire_type, value) over a message buffer."""
    pos = 0
    n = len(buf)
    while pos < n:
        key, pos = _read_varint(buf, pos)
        field, wt = key >> 3, key & 7
        if wt == 0:  # varint
            val, pos = _read_varint(buf, pos)
            yield field, wt, val
        elif wt == 1:  # 64-bit
            yield field, wt, buf[pos : pos + 8]
            pos += 8
        elif wt == 2:  # length-delimited
            ln, pos = _read_varint(buf, pos)
            yield field, wt, buf[pos : pos + ln]
            pos += ln
        elif wt == 5:  # 32-bit
            yield field, wt, buf[pos : pos + 4]
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wt} at {pos}")


def _parse_tensor(buf: memoryview) -> tuple[str, np.ndarray]:
    dims: list[int] = []
    data_type = 1
    name = ""
    raw = None
    floats: list[memoryview] = []
    doubles: list[memoryview] = []
    int32s: list[int] = []
    int64s: list[int] = []
    for field, wt, val in _fields(buf):
        if field == 1:  # dims
            if wt == 0:
                dims.append(val)
            else:  # packed
                p = 0
                while p < len(val):
                    v, p = _read_varint(val, p)
                    dims.append(v)
        elif field == 2 and wt == 0:
            data_type = val
        elif field == 4:  # float_data (packed or fixed32)
            floats.append(val if wt == 2 else bytes(val))
        elif field == 5:
            if wt == 0:
                int32s.append(val)
            else:
                p = 0
                while p < len(val):
                    v, p = _read_varint(val, p)
                    int32s.append(v)
        elif field == 7:
            if wt == 0:
                int64s.append(val)
            else:
                p = 0
                while p < len(val):
                    v, p = _read_varint(val, p)
                    int64s.append(v)
        elif field == 8 and wt == 2:
            name = bytes(val).decode("utf-8")
        elif field == 9 and wt == 2:
            raw = val
        elif field == 10:
            doubles.append(val if wt == 2 else bytes(val))

    dtype = _DTYPES.get(data_type)
    if dtype is None:
        raise ValueError(f"initializer {name!r}: unsupported data_type {data_type}")

    if raw is not None:
        arr = np.frombuffer(raw, dtype=dtype)
    elif floats:
        arr = np.frombuffer(b"".join(bytes(f) for f in floats), dtype="<f4")
    elif doubles:
        arr = np.frombuffer(b"".join(bytes(d) for d in doubles), dtype="<f8")
    elif int64s:
        arr = np.asarray(int64s, dtype=np.int64)
    elif int32s:
        arr = np.asarray(int32s, dtype=np.int32)
    else:
        arr = np.zeros(0, dtype=dtype)

    if arr.dtype == np.float16:
        arr = arr.astype(np.float32)
    return name, arr.reshape(dims) if dims else arr


def read_onnx_initializers(path: str | pathlib.Path) -> dict[str, np.ndarray]:
    """Parse an ONNX file → ``{initializer_name: array}``."""
    data = memoryview(pathlib.Path(path).read_bytes())
    out: dict[str, np.ndarray] = {}
    for field, wt, val in _fields(data):
        if field == 7 and wt == 2:  # ModelProto.graph
            for gfield, gwt, gval in _fields(val):
                if gfield == 5 and gwt == 2:  # GraphProto.initializer
                    name, arr = _parse_tensor(gval)
                    out[name] = arr
    if not out:
        raise ValueError(
            f"{path}: no graph initializers found (not an ONNX model, or weights "
            "are stored as Constant nodes — unsupported)"
        )
    return out


# ---------------------------------------------------------------------------
# tiny encoder (tests / export)
# ---------------------------------------------------------------------------


def _varint(v: int) -> bytes:
    out = b""
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out += bytes([b | 0x80])
        else:
            return out + bytes([b])


def _ld(field: int, payload: bytes) -> bytes:
    return _varint(field << 3 | 2) + _varint(len(payload)) + payload


def write_onnx_weights(path: str | pathlib.Path, tensors: dict[str, np.ndarray]) -> None:
    """Write a minimal ONNX file carrying only initializers (round-trip
    partner of :func:`read_onnx_initializers`; consumable by onnx loaders as
    a weights container)."""
    inits = b""
    rev = {v: k for k, v in _DTYPES.items()}
    for name, arr in tensors.items():
        arr = np.ascontiguousarray(arr)
        dt = rev.get(arr.dtype.newbyteorder("<"), 1)
        t = b""
        for d in arr.shape:
            t += _varint(1 << 3 | 0) + _varint(d)
        t += _varint(2 << 3 | 0) + _varint(dt)
        t += _ld(8, name.encode("utf-8"))
        t += _ld(9, arr.astype(arr.dtype.newbyteorder("<")).tobytes())
        inits += _ld(5, t)
    graph = inits + _ld(2, b"obs_rvc_tpu_weights")
    model = _varint(1 << 3 | 0) + _varint(8) + _ld(7, graph)
    pathlib.Path(path).write_bytes(model)
