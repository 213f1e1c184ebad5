"""Streaming state of one stream, or of ``B`` with each tensor ``[B, n]``
(counterpart of ``obs_rvc_tpu/stream/state.py``):

- ``input_buffer``      device-rate input ring
- ``input_buffer_16k``  16 kHz ring fed to the networks
- ``sola_buffer``       saved crossfade tail
- ``cache_pitchf``      1024-frame sliding f0 cache (100 Hz)

``to_bytes``/``from_bytes`` keep the JAX package's snapshot format (flax's
msgpack of the field map, each array an ext of type 1 holding the msgpack of
``(shape, dtype name, raw C-order bytes)``), so a snapshot taken by a session
of either package resumes in the other. The encoder and decoder below cover
exactly that structure.
"""

from __future__ import annotations

import dataclasses
import struct

import numpy as np
import torch

from obs_rvc_tpu_torch.config import ChunkConfig
from obs_rvc_tpu_torch.device import resolve_device

_EXT_NDARRAY = 1


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
        names = sorted(f.name for f in dataclasses.fields(self))
        out = [_map_header(len(names))]
        for name in names:
            arr = getattr(self, name).detach().cpu().contiguous().numpy()
            out.append(_pack_str(name))
            out.append(_pack_ext(_EXT_NDARRAY, _pack_ndarray(arr)))
        return b"".join(out)

    @staticmethod
    def from_bytes(data: bytes, device=None) -> "StreamState":
        """Read a snapshot written by either package onto ``device``
        (``None`` means the card)."""
        device = resolve_device(device)
        fields = _Reader(data).read()
        if not isinstance(fields, dict):
            raise ValueError("snapshot is not a map of arrays")
        want = {f.name for f in dataclasses.fields(StreamState)}
        if set(fields) != want:
            raise ValueError(f"snapshot fields {sorted(fields)} differ from {sorted(want)}")
        return StreamState(**{k: torch.from_numpy(np.array(v, dtype=np.float32)).to(device)
                              for k, v in fields.items()})


# ---------------------------------------------------------------------------
# the msgpack subset of the snapshot format
# ---------------------------------------------------------------------------


def _map_header(n: int) -> bytes:
    return bytes([0x80 | n]) if n < 16 else b"\xde" + struct.pack(">H", n)


def _pack_str(s: str) -> bytes:
    b = s.encode()
    if len(b) < 32:
        return bytes([0xA0 | len(b)]) + b
    return b"\xd9" + struct.pack(">B", len(b)) + b


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


def _pack_ndarray(arr: np.ndarray) -> bytes:
    """msgpack of ``(shape, dtype name, raw bytes)``: a 3-array."""
    shape = b"".join(_pack_uint(int(d)) for d in arr.shape)
    shape_hdr = bytes([0x90 | arr.ndim]) if arr.ndim < 16 else b"\xdc" + struct.pack(">H", arr.ndim)
    return b"\x93" + shape_hdr + shape + _pack_str(arr.dtype.name) + _pack_bin(arr.tobytes("C"))


class _Reader:
    """Decode the msgpack values the snapshot format uses: maps, arrays,
    strings, binaries, unsigned and signed integers and ext type 1 arrays."""

    def __init__(self, data: bytes):
        self.data = memoryview(bytes(data))
        self.pos = 0

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError("truncated snapshot")
        out = bytes(self.data[self.pos : self.pos + n])
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
            return self.take(t & 0x1F).decode()
        sized = {0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}
        if t in sized:
            return self.take(self.unpack(sized[t])).decode()
        sized = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}
        if t in sized:
            return self.take(self.unpack(sized[t]))
        ints = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q", 0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if t in ints:
            return self.unpack(ints[t])
        if t == 0xDC:
            return [self.read() for _ in range(self.unpack(">H"))]
        if t == 0xDE:
            return self._map(self.unpack(">H"))
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if t in fixext:
            n = fixext[t]
        elif t in (0xC7, 0xC8, 0xC9):
            n = self.unpack({0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}[t])
        else:
            raise ValueError(f"unsupported msgpack type byte 0x{t:02x} in snapshot")
        code = self.unpack(">b")
        if code != _EXT_NDARRAY:
            raise ValueError(f"unsupported msgpack ext type {code} in snapshot")
        return _ndarray(self.take(n))

    def _map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.read()
            out[k.decode() if isinstance(k, bytes) else k] = self.read()
        return out


def _ndarray(payload: bytes) -> np.ndarray:
    shape, dtype_name, raw = _Reader(payload).read()
    if isinstance(dtype_name, bytes):
        dtype_name = dtype_name.decode()
    if dtype_name == "bfloat16":
        raise ValueError("bfloat16 snapshots are not supported by the port")
    return np.frombuffer(raw, dtype=np.dtype(dtype_name)).reshape(shape)
