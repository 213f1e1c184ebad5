"""Sample-granular single-producer single-consumer float ring buffers on the
host (counterpart of ``obs_rvc_tpu/stream/ringbuf.py``).

:class:`NativeRingBuffer` binds the repository's ``native/librvc_ringbuf.so``
(``make -C native``) with ``ctypes``; :class:`PyRingBuffer` is the same
contract in Python behind a lock. :func:`make_ring_buffer` takes the native
one where the library is built. The device plays no part here.
"""

from __future__ import annotations

import ctypes
import functools
import pathlib
import threading
from typing import Optional

import numpy as np

LIB_PATH = pathlib.Path(__file__).resolve().parents[2] / "native" / "librvc_ringbuf.so"


@functools.lru_cache(maxsize=1)
def native_library() -> Optional[ctypes.CDLL]:
    """The native ring buffer library with its signatures declared, or None
    where it is not built."""
    if not LIB_PATH.exists():
        return None
    lib = ctypes.CDLL(str(LIB_PATH))
    lib.rvc_ringbuf_create.restype = ctypes.c_void_p
    lib.rvc_ringbuf_create.argtypes = [ctypes.c_uint64]
    lib.rvc_ringbuf_destroy.restype = None
    lib.rvc_ringbuf_destroy.argtypes = [ctypes.c_void_p]
    for fn in ("rvc_ringbuf_capacity", "rvc_ringbuf_available", "rvc_ringbuf_free_space"):
        getattr(lib, fn).restype = ctypes.c_uint64
        getattr(lib, fn).argtypes = [ctypes.c_void_p]
    for fn in ("rvc_ringbuf_push", "rvc_ringbuf_pop", "rvc_ringbuf_pop_exact"):
        getattr(lib, fn).restype = ctypes.c_uint64
        getattr(lib, fn).argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_float), ctypes.c_uint64]
    lib.rvc_ringbuf_discard.restype = ctypes.c_uint64
    lib.rvc_ringbuf_discard.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
    return lib


def _float_ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


class NativeRingBuffer:
    """SPSC float ring buffer backed by ``native/librvc_ringbuf.so``."""

    def __init__(self, min_capacity: int):
        lib = native_library()
        if lib is None:
            raise RuntimeError(f"native ring buffer not built: {LIB_PATH} (make -C native)")
        self._lib = lib
        self._ptr = lib.rvc_ringbuf_create(min_capacity)
        if not self._ptr:
            raise MemoryError("rvc_ringbuf_create failed")

    def __del__(self):
        if getattr(self, "_ptr", None):
            self._lib.rvc_ringbuf_destroy(self._ptr)
            self._ptr = None

    @property
    def capacity(self) -> int:
        return self._lib.rvc_ringbuf_capacity(self._ptr)

    def available(self) -> int:
        return self._lib.rvc_ringbuf_available(self._ptr)

    def push(self, samples: np.ndarray) -> int:
        """Append as many samples as fit; returns how many were taken."""
        samples = np.ascontiguousarray(samples, dtype=np.float32).ravel()
        return self._lib.rvc_ringbuf_push(self._ptr, _float_ptr(samples), samples.size)

    def pop_exact(self, n: int) -> Optional[np.ndarray]:
        """``n`` samples, or None (consuming nothing) when fewer are there."""
        out = np.empty(n, dtype=np.float32)
        got = self._lib.rvc_ringbuf_pop_exact(self._ptr, _float_ptr(out), n)
        return out if got == n else None

    def pop(self, n: int) -> np.ndarray:
        """Up to ``n`` samples."""
        out = np.empty(n, dtype=np.float32)
        got = self._lib.rvc_ringbuf_pop(self._ptr, _float_ptr(out), n)
        return out[:got]

    def discard(self, n: int) -> int:
        return self._lib.rvc_ringbuf_discard(self._ptr, n)


class PyRingBuffer:
    """The same contract in Python, behind a lock."""

    def __init__(self, min_capacity: int):
        cap = 1
        while cap < min_capacity:
            cap <<= 1
        self.capacity = cap
        self._buf = np.zeros(0, dtype=np.float32)
        self._lock = threading.Lock()

    def available(self) -> int:
        with self._lock:
            return self._buf.size

    def push(self, samples: np.ndarray) -> int:
        samples = np.asarray(samples, dtype=np.float32).ravel()
        with self._lock:
            n = min(self.capacity - self._buf.size, samples.size)
            self._buf = np.concatenate([self._buf, samples[:n]])
            return n

    def pop_exact(self, n: int) -> Optional[np.ndarray]:
        with self._lock:
            if self._buf.size < n:
                return None
            out, self._buf = self._buf[:n].copy(), self._buf[n:]
            return out

    def pop(self, n: int) -> np.ndarray:
        with self._lock:
            n = min(n, self._buf.size)
            out, self._buf = self._buf[:n].copy(), self._buf[n:]
            return out

    def discard(self, n: int) -> int:
        with self._lock:
            n = min(n, self._buf.size)
            self._buf = self._buf[n:]
            return n


def make_ring_buffer(min_capacity: int):
    """Native where the library is built, else the Python one."""
    if native_library() is not None:
        return NativeRingBuffer(min_capacity)
    return PyRingBuffer(min_capacity)
