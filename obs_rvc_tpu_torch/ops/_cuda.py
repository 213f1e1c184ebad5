"""Build and load the hand-written CUDA kernels under ``obs_rvc_tpu_torch/csrc``.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled with
``nvcc`` for ``sm_90a`` into its own shared library, loaded with ``ctypes``.
Builds happen at first use (one ``nvcc`` per source, all started together)
into ``obs_rvc_tpu_torch/_build/``, named by a hash of the source, the
headers (``csrc/*.cuh``) and the flags, so a changed source or header is
rebuilt. Nothing here runs at import time: the module imports on a machine
without a CUDA toolchain.

**The launch device.** A C entry launches on the calling thread's current
device, into the stream it is handed. So every wrapper makes its input's
card current around the C call (:func:`on_device_of`), after checking that
every tensor it passes lies on that card, and hands the C entry that card's
current stream (:func:`stream_of`). A kernel whose shared-memory cap must be
raised sets it once per device (``csrc/mma.cuh:smem_cap_once``).
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
import time

_PKG = pathlib.Path(__file__).resolve().parent.parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_libs: dict[str, ctypes.CDLL] = {}
#: held while a wrapper adds to its ``LAUNCHES`` count: a server launches
#: from several threads, and ``+=`` on a module global is not atomic
COUNT_LOCK = threading.Lock()
_LOAD_LOCK = threading.Lock()
#: ``-Xptxas -v`` output of each build made by this process, by source name
build_logs: dict[str, str] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a machine with the CUDA toolkit")


def sources() -> list[str]:
    return sorted(p.stem for p in SRC_DIR.glob("*.cu"))


def _lib_path(name: str) -> pathlib.Path:
    """The library's path, named by a hash of its source, every header under
    ``csrc/`` (a source may include any of them) and the flags."""
    h = hashlib.sha256((SRC_DIR / f"{name}.cu").read_bytes())
    for header in sorted(SRC_DIR.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    digest = h.hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names=None) -> float:
    """Compile the named sources (default: all) that are not built yet, one
    ``nvcc`` process per source, all in parallel. Raises with the compiler's
    output if any fails. Returns the wall seconds spent."""
    names = sources() if names is None else list(names)
    todo = [n for n in names if not _lib_path(n).exists()]
    if not todo:
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    t0 = time.perf_counter()
    procs = {}
    for n in todo:
        out = _lib_path(n)
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(out) + ".tmp", str(SRC_DIR / f"{n}.cu")]
        procs[n] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    failed = []
    for n, p in procs.items():
        log, _ = p.communicate()
        build_logs[n] = log
        if p.returncode != 0:
            failed.append(f"--- nvcc {n}.cu (exit {p.returncode}) ---\n{log}")
        else:
            os.replace(str(_lib_path(n)) + ".tmp", _lib_path(n))
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0


def library(name: str) -> ctypes.CDLL:
    """The loaded shared library of ``csrc/<name>.cu``, built on first use."""
    with _LOAD_LOCK:  # the first launches may come from several threads at once
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(_lib_path(name)))
            _libs[name] = lib
    return lib


def function(name: str, symbol: str, argtypes: list):
    """The C entry ``symbol`` of ``csrc/<name>.cu``, its arguments declared
    (pointers and the stream as ``c_void_p``, so none is cut to 32 bits) and
    its return type ``int``, a CUDA error code."""
    fn = getattr(library(name), symbol)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def check(rc: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc}")


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(0 if t is None else t.data_ptr())


def on_device_of(t, *others, what: str = "kernel"):
    """The context every wrapper makes its C call in: ``t``'s card current.
    Raises when one of ``others`` (tensors, or ``None``) lies on another device."""
    import torch

    for o in others:
        if o is not None and o.device != t.device:
            raise ValueError(f"{what}: a tensor on {o.device} beside the input on {t.device}")
    # the wrappers send a CPU tensor to the plain version; one reaches here only from the
    # tests' stand-in C entry, which launches nothing
    return torch.cuda.device(t.device) if t.device.type == "cuda" else contextlib.nullcontext()


def stream_of(t) -> ctypes.c_void_p:
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)
