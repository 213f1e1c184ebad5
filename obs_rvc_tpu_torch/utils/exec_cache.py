"""Captured CUDA graphs shared by key within a process (counterpart of
``obs_rvc_tpu/utils/exec_cache.py``).

The JAX package serializes each compiled XLA executable to disk so a later
process loads it instead of compiling. A CUDA graph cannot be serialized:
it holds the device addresses of one process's tensors. So here two things
take the executable cache's place:

- across processes, the kernels' shared libraries under
  ``obs_rvc_tpu_torch/_build/``, which ``ops/_cuda.py`` names by a hash of
  their sources and flags, so a warm checkout builds nothing;
- within a process, :func:`cached_capture`: a graph captured once under a
  key is handed to every later caller with the same key while some caller
  still holds it (the cache keeps only weak references, so a graph is freed
  with the last session, engine geometry or pipeline that uses it).

The key is the JAX scheme's: :data:`KEY_VERSION`, the caller's semantic key
(``RvcPipeline.fingerprint()`` plus a call-site label),
:func:`traced_source_fingerprint` over the modules that define device work,
the arguments' shapes, dtypes and devices, the torch and CUDA versions and
the card's name. One part is the port's own: a graph reads its networks'
weights at fixed addresses, so the identity of those modules is in the key
too, where the function names them.

Usage::

    step, status = cached_capture(pipe.jit_step, (state, chunk, controls),
                                  semantic_key=pipe.fingerprint() + "|jit_step")
    # status is "hit" (this process already held a graph for the key) or
    # "miss" (captured now)
"""

from __future__ import annotations

import functools
import hashlib
import pathlib
import threading
import weakref
from typing import Any, Callable

import torch

from obs_rvc_tpu_torch.stream.graphs import GraphedFunction, leaves

#: bump to invalidate every key (key-scheme changes)
KEY_VERSION = "1"

#: the port's modules whose source defines device work: an edit to any of
#: them may change what a graph computes, so their bytes are in every key.
#: Host-side modules (serve/, stream/ringbuf.py, utils/) are left out.
_TRACED_GLOBS = (
    "config.py",
    "dsp/*.py",
    "models/*.py",
    "ops/*.py",
    "csrc/*.cu",
    "csrc/*.cuh",
    "stream/graphs.py",
    "stream/pipeline.py",
    "stream/state.py",
    "stream/engine.py",
    "stream/scheduler.py",
)

_held: "weakref.WeakValueDictionary[str, Any]" = weakref.WeakValueDictionary()
_held_lock = threading.Lock()


@functools.cache
def traced_source_fingerprint() -> str:
    """sha256 over the path and bytes of every module in :data:`_TRACED_GLOBS`,
    in sorted order; computed once per process."""
    pkg_root = pathlib.Path(__file__).resolve().parent.parent
    h = hashlib.sha256()
    for pattern in _TRACED_GLOBS:
        for p in sorted(pkg_root.glob(pattern)):
            h.update(str(p.relative_to(pkg_root)).encode())
            h.update(b"\x00")
            h.update(p.read_bytes())
    return h.hexdigest()


def _signature(args) -> str:
    def leaf(x):
        if isinstance(x, torch.Tensor):
            return f"{tuple(x.shape)}:{x.dtype}:{x.device}"
        return type(x).__name__

    return ",".join(leaf(x) for x in leaves(args))


def _device_name(args) -> str:
    for x in leaves(args):
        if isinstance(x, torch.Tensor) and x.device.type == "cuda":
            return torch.cuda.get_device_name(x.device)
    return "cpu"


def _cache_key(fn: Callable, example_args: tuple, semantic_key: str, tag: str = "") -> str:
    weights = getattr(fn, "weights", None)
    modules = ",".join(str(id(m)) for m in weights()) if weights is not None else ""
    parts = [KEY_VERSION, semantic_key, traced_source_fingerprint(), _signature(example_args),
             torch.__version__, str(torch.version.cuda), _device_name(example_args), modules, tag]
    return hashlib.sha256("\x00".join(parts).encode()).hexdigest()[:32]


def cached_capture(fn: Callable, example_args: tuple, *, semantic_key: str, tag: str = "") -> tuple[Any, str]:
    """The graphed form of ``fn`` for arguments like ``example_args``, and
    ``"hit"`` when this process already held one under the key, else
    ``"miss"`` (captured now).

    ``fn`` is a graphed callable of the port (``RvcPipeline.jit_step``,
    ``RvcPipeline.jit_infer``: anything with a ``capture()``), which is
    captured and held under the key; any other function is first wrapped in
    a :class:`GraphedFunction` over copies of ``example_args``. Callers own
    the key's contract: ``semantic_key`` tells apart every distinct function
    over the same pipeline, and nothing outside the key may change what the
    graph computes.
    """
    key = _cache_key(fn, example_args, semantic_key, tag)
    with _held_lock:
        held = _held.get(key)
        if held is not None:
            return held, "hit"
        if not hasattr(fn, "capture"):
            device = next((x.device for x in leaves(example_args) if isinstance(x, torch.Tensor)), "cpu")
            fn = GraphedFunction(fn, example_args, device=device, name=tag or semantic_key)
        fn.capture()
        _held[key] = fn
        return fn, "miss"
