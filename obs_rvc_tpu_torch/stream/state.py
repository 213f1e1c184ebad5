"""Streaming state of one stream, or of ``B`` with each tensor ``[B, n]``
(counterpart of ``obs_rvc_tpu/stream/state.py``):

- ``input_buffer``      device-rate input ring
- ``input_buffer_16k``  16 kHz ring fed to the networks
- ``sola_buffer``       saved crossfade tail
- ``cache_pitchf``      1024-frame sliding f0 cache (100 Hz)

``to_bytes``/``from_bytes`` keep the JAX package's snapshot format (flax's
msgpack of the field map, each array an ext of type 1 holding the msgpack of
``(shape, dtype name, raw C-order bytes)``), so a snapshot taken by a session
of either package resumes in the other. :func:`pack_tree` and
:func:`unpack_tree` below are that codec for any tree of maps and arrays,
flax's ``msgpack_serialize``/``msgpack_restore`` byte for byte (keys
sorted, arrays over 1 GiB split into flax's chunked form, bfloat16 kept):
``models/checkpoints.py`` writes and reads parameter files with them.
"""

from __future__ import annotations

import dataclasses
import struct

import numpy as np
import torch

from obs_rvc_tpu_torch.config import ChunkConfig
from obs_rvc_tpu_torch.device import resolve_device

_EXT_NDARRAY = 1
_EXT_NPSCALAR = 2
#: flax's MAX_CHUNK_SIZE: arrays of more bytes are written as chunks of at most this many
MAX_CHUNK_SIZE = 2**30
_CHUNKED = "__msgpack_chunked_array__"


@dataclasses.dataclass
class StreamState:
    input_buffer: torch.Tensor
    input_buffer_16k: torch.Tensor
    sola_buffer: torch.Tensor
    cache_pitchf: torch.Tensor

    @staticmethod
    def init(cfg: ChunkConfig, device=None) -> "StreamState":
        """Zeroed state; ``device=None`` means the card (an error without one)."""
        device = resolve_device(device)

        def zeros(n):
            return torch.zeros(n, dtype=torch.float32, device=device)

        return StreamState(
            input_buffer=zeros(cfg.input_buffer_size),
            input_buffer_16k=zeros(cfg.input_buffer_16k_size),
            sola_buffer=zeros(cfg.sola_buffer_frame_size),
            cache_pitchf=zeros(cfg.pitch_cache_len),
        )

    @staticmethod
    def init_batch(cfg: ChunkConfig, batch: int, device=None) -> "StreamState":
        """Zeroed state of ``batch`` streams, each tensor ``[batch, n]``
        (the batched step's form); ``device=None`` means the card."""
        return StreamState.init(cfg, device).map(lambda t: t.expand(batch, -1).contiguous())

    def map(self, fn) -> "StreamState":
        """``fn`` applied to each tensor."""
        return StreamState(**{f.name: fn(getattr(self, f.name)) for f in dataclasses.fields(self)})

    def clear(self) -> "StreamState":
        return StreamState(**{f.name: torch.zeros_like(getattr(self, f.name))
                              for f in dataclasses.fields(self)})

    def to(self, device) -> "StreamState":
        return StreamState(**{f.name: getattr(self, f.name).to(device)
                              for f in dataclasses.fields(self)})

    def to_bytes(self) -> bytes:
        """The snapshot bytes, identical to the JAX ``StreamState.to_bytes``
        of the same arrays (keys in sorted order, as flax writes them)."""
        return pack_tree({f.name: getattr(self, f.name) for f in dataclasses.fields(self)})

    @staticmethod
    def from_bytes(data: bytes, device=None) -> "StreamState":
        """Read a snapshot written by either package onto ``device``
        (``None`` means the card)."""
        device = resolve_device(device)
        fields = unpack_tree(data)
        if not isinstance(fields, dict):
            raise ValueError("snapshot is not a map of arrays")
        want = {f.name for f in dataclasses.fields(StreamState)}
        if set(fields) != want:
            raise ValueError(f"snapshot fields {sorted(fields)} differ from {sorted(want)}")
        return StreamState(**{k: v.to(device, torch.float32) for k, v in fields.items()})


# ---------------------------------------------------------------------------
# the msgpack subset of flax's format
# ---------------------------------------------------------------------------


def pack_tree(tree) -> bytes:
    """flax's ``msgpack_serialize`` of a tree of maps (keys sorted, as flax
    writes a tree it has mapped over) whose leaves are numpy arrays or torch
    tensors, each written as an ext of type 1."""
    out: list[bytes] = []
    _pack(_chunked(tree), out)
    return b"".join(out)


def unpack_tree(data: bytes):
    """flax's ``msgpack_restore``: the tree of maps, each array leaf a CPU
    torch tensor (bfloat16 included), chunked arrays joined."""
    return _unchunk(_Reader(data).read())


def _chunked(tree):
    """The tree with its keys sorted and each array leaf as (array, dtype
    name), an array over MAX_CHUNK_SIZE bytes as flax's chunked map."""
    if isinstance(tree, dict):
        return {k: _chunked(tree[k]) for k in sorted(tree)}
    arr, name = _leaf(tree)
    if arr.nbytes <= MAX_CHUNK_SIZE:
        return arr, name
    size = max(1, MAX_CHUNK_SIZE // arr.itemsize)
    flat = arr.reshape(-1)
    return {_CHUNKED: True, "shape": {str(i): int(d) for i, d in enumerate(arr.shape)},
            "chunks": {str(j): (flat[i : i + size], name) for j, i in enumerate(range(0, flat.size, size))}}


def _leaf(x) -> tuple[np.ndarray, str]:
    """An array leaf as (C-order numpy array, dtype name); bfloat16, which
    numpy lacks, as its 16-bit words."""
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy(), "bfloat16"
        x = t.numpy()
    arr = np.asarray(x)
    if arr.dtype.name == "bfloat16":  # a JAX array's ml_dtypes bfloat16
        return np.ascontiguousarray(arr).view(np.int16).reshape(arr.shape), "bfloat16"
    return arr, arr.dtype.name


def _pack(obj, out: list) -> None:
    if isinstance(obj, dict):
        out.append(_map_header(len(obj)))
        for k, v in obj.items():
            out.append(_pack_str(k))
            _pack(v, out)
    elif isinstance(obj, bool):
        out.append(b"\xc3" if obj else b"\xc2")
    elif isinstance(obj, int):
        out.append(_pack_uint(obj))
    else:
        out.append(_pack_ext(_EXT_NDARRAY, _pack_ndarray(*obj)))


def _map_header(n: int) -> bytes:
    if n < 16:
        return bytes([0x80 | n])
    return b"\xde" + struct.pack(">H", n) if n < 1 << 16 else b"\xdf" + struct.pack(">I", n)


def _pack_str(s: str) -> bytes:
    b = s.encode()
    if len(b) < 32:
        return bytes([0xA0 | len(b)]) + b
    if len(b) < 1 << 8:
        return b"\xd9" + struct.pack(">B", len(b)) + b
    return b"\xda" + struct.pack(">H", len(b)) + b


def _pack_uint(v: int) -> bytes:
    if v < 0x80:
        return bytes([v])
    for tag, fmt, lim in ((0xCC, ">B", 1 << 8), (0xCD, ">H", 1 << 16), (0xCE, ">I", 1 << 32)):
        if v < lim:
            return bytes([tag]) + struct.pack(fmt, v)
    return b"\xcf" + struct.pack(">Q", v)


def _pack_bin(b: bytes) -> bytes:
    n = len(b)
    if n < 1 << 8:
        return b"\xc4" + struct.pack(">B", n) + b
    if n < 1 << 16:
        return b"\xc5" + struct.pack(">H", n) + b
    return b"\xc6" + struct.pack(">I", n) + b


def _pack_ext(code: int, payload: bytes) -> bytes:
    n = len(payload)
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixed:
        return bytes([fixed[n], code]) + payload
    if n < 1 << 8:
        return b"\xc7" + struct.pack(">Bb", n, code) + payload
    if n < 1 << 16:
        return b"\xc8" + struct.pack(">Hb", n, code) + payload
    return b"\xc9" + struct.pack(">Ib", n, code) + payload


def _pack_ndarray(arr: np.ndarray, name: str) -> bytes:
    """msgpack of ``(shape, dtype name, raw bytes)``: a 3-array."""
    shape = b"".join(_pack_uint(int(d)) for d in arr.shape)
    shape_hdr = bytes([0x90 | arr.ndim]) if arr.ndim < 16 else b"\xdc" + struct.pack(">H", arr.ndim)
    return b"\x93" + shape_hdr + shape + _pack_str(name) + _pack_bin(arr.tobytes("C"))


class _Reader:
    """Decode the msgpack values flax's format uses: maps, arrays, strings,
    binaries, booleans, nil, integers and ext types 1 (arrays) and 2
    (numpy scalars)."""

    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        out = self.data[self.pos : self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def read(self):
        t = self.take(1)[0]
        if t < 0x80:
            return t
        if t >= 0xE0:
            return t - 0x100
        if 0x80 <= t <= 0x8F:
            return self._map(t & 0x0F)
        if 0x90 <= t <= 0x9F:
            return [self.read() for _ in range(t & 0x0F)]
        if 0xA0 <= t <= 0xBF:
            return bytes(self.take(t & 0x1F)).decode()
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if t in simple:
            return simple[t]
        sized = {0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}
        if t in sized:
            return bytes(self.take(self.unpack(sized[t]))).decode()
        sized = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}
        if t in sized:
            return self.take(self.unpack(sized[t]))
        ints = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q", 0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if t in ints:
            return self.unpack(ints[t])
        if t in (0xDC, 0xDD):
            return [self.read() for _ in range(self.unpack(">H" if t == 0xDC else ">I"))]
        if t in (0xDE, 0xDF):
            return self._map(self.unpack(">H" if t == 0xDE else ">I"))
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if t in fixext:
            n = fixext[t]
        elif t in (0xC7, 0xC8, 0xC9):
            n = self.unpack({0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}[t])
        else:
            raise ValueError(f"unsupported msgpack type byte 0x{t:02x}")
        code = self.unpack(">b")
        if code not in (_EXT_NDARRAY, _EXT_NPSCALAR):
            raise ValueError(f"unsupported msgpack ext type {code}")
        return _ndarray(self.take(n))

    def _map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.read()
            out[bytes(k).decode() if isinstance(k, memoryview) else k] = self.read()
        return out


def _ndarray(payload) -> torch.Tensor:
    shape, dtype_name, raw = _Reader(payload).read()
    if isinstance(dtype_name, memoryview):
        dtype_name = bytes(dtype_name).decode()
    if dtype_name == "bfloat16":
        return torch.from_numpy(np.frombuffer(raw, dtype=np.int16).reshape(shape).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.frombuffer(raw, dtype=np.dtype(dtype_name)).reshape(shape).copy())


def _unchunk(tree):
    if not isinstance(tree, dict):
        return tree
    if tree.get(_CHUNKED) is True:
        shape = [tree["shape"][str(i)] for i in range(len(tree["shape"]))]
        chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
        return torch.cat([c.reshape(-1) for c in chunks]).reshape(shape)
    return {k: _unchunk(v) for k, v in tree.items()}
