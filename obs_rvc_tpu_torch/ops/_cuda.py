"""Build and load the hand-written CUDA kernels under ``obs_rvc_tpu_torch/csrc``,
and the host helper beside them.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled with
``nvcc`` for ``sm_90a`` into its own shared library, loaded with ``ctypes``.
Each ``csrc/<name>.cpp`` is host code only: a Python extension module
compiled by the host's C++ compiler against torch's own headers and
libraries, imported by :func:`extension` (``weights_snapshot``, the graphs'
weights check). Builds happen at first use into ``obs_rvc_tpu_torch/_build/``,
named by a hash of the source, the headers (``csrc/*.cuh``) and the flags
(for a ``.cpp``, also torch's and Python's versions), so a changed source or
header is rebuilt. On a machine with a card the first build starts every
source that is not built yet, one compiler process each, all together; a
file lock in ``_build/`` keeps two processes from building at once. Nothing
here runs at import time: the module imports on a machine without a CUDA
toolchain.

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
import fcntl
import hashlib
import importlib.util
import os
import pathlib
import shutil
import subprocess
import sys
import sysconfig
import threading
import time

_PKG = pathlib.Path(__file__).resolve().parent.parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

#: the host helpers' C++ flags; torch's ABI flag, include and library paths are added to them
CXX_FLAGS = ("-std=c++20", "-O2", "-shared", "-fPIC", "-w")

_libs: dict[str, ctypes.CDLL] = {}
_extensions: dict = {}
#: held while a wrapper adds to its ``LAUNCHES`` count: a server launches
#: from several threads, and ``+=`` on a module global is not atomic
COUNT_LOCK = threading.Lock()
_LOAD_LOCK = threading.Lock()
#: the compiler's output of each build made by this process, by source name (``-Xptxas -v`` for a kernel)
build_logs: dict[str, str] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a machine with the CUDA toolkit")


def cxx_path() -> str:
    found = shutil.which("c++") or shutil.which("g++")
    if found:
        return found
    raise RuntimeError("no C++ compiler (c++ or g++) found: the host helpers are built with one")


def sources() -> list[str]:
    """The kernels' sources (``csrc/*.cu``)."""
    return sorted(p.stem for p in SRC_DIR.glob("*.cu"))


def host_sources() -> list[str]:
    """The host helpers' sources (``csrc/*.cpp``)."""
    return sorted(p.stem for p in SRC_DIR.glob("*.cpp"))


def _cxx_command(name: str, out: str) -> list[str]:
    """A host helper's compile, against torch's include and library directories
    as ``torch.utils.cpp_extension`` names them."""
    import torch

    root = pathlib.Path(torch.__file__).resolve().parent
    lib = root / "lib"
    return [cxx_path(), *CXX_FLAGS, f"-D_GLIBCXX_USE_CXX11_ABI={int(torch._C._GLIBCXX_USE_CXX11_ABI)}",
            f"-I{sysconfig.get_paths()['include']}", f"-I{root / 'include'}",
            f"-I{root / 'include' / 'torch' / 'csrc' / 'api' / 'include'}",
            str(SRC_DIR / f"{name}.cpp"), "-o", out,
            f"-L{lib}", "-lc10", "-ltorch", "-ltorch_cpu", "-ltorch_python", f"-Wl,-rpath,{lib}"]


def _lib_path(name: str) -> pathlib.Path:
    """The library's path, named by a hash of its source, every header under
    ``csrc/`` (a source may include any of them) and the flags; a host
    helper's also by the torch and Python it is compiled against, since a
    checkout's ``_build/`` may travel to a machine with others."""
    if (SRC_DIR / f"{name}.cpp").exists():
        import torch

        h = hashlib.sha256((SRC_DIR / f"{name}.cpp").read_bytes())
        h.update(" ".join((*CXX_FLAGS, torch.__version__, str(torch._C._GLIBCXX_USE_CXX11_ABI),
                           sys.version, sysconfig.get_config_var("EXT_SUFFIX") or "")).encode())
        return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}{sysconfig.get_config_var('EXT_SUFFIX') or '.so'}"
    h = hashlib.sha256((SRC_DIR / f"{name}.cu").read_bytes())
    for header in sorted(SRC_DIR.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    digest = h.hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


@contextlib.contextmanager
def _build_lock():
    """Held across processes while one builds (the tests' workers, a server
    and a script started together in one checkout)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / ".lock", "w") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        yield


def build(names=None) -> float:
    """Compile the named sources (default: every kernel and host helper)
    that are not built yet, one compiler process per source, all in
    parallel. Raises with the compiler's output if any fails. Returns the
    wall seconds spent."""
    names = sources() + host_sources() if names is None else list(names)
    if all(_lib_path(n).exists() for n in names):
        return 0.0
    t0 = time.perf_counter()
    with _build_lock():
        todo = [n for n in names if not _lib_path(n).exists()]  # another process may have built them meanwhile
        host = host_sources()
        tmps = {n: f"{_lib_path(n)}.{os.getpid()}.tmp" for n in todo}
        # every command before any process starts: a missing compiler raises with none left running
        cmds = {n: _cxx_command(n, tmps[n]) if n in host else
                [nvcc_path(), *NVCC_FLAGS, "-o", tmps[n], str(SRC_DIR / f"{n}.cu")] for n in todo}
        procs = {n: (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), tmps[n])
                 for n, cmd in cmds.items()}
        failed = []
        for n, (p, tmp) in procs.items():
            log, _ = p.communicate()
            build_logs[n] = log
            if p.returncode != 0:
                failed.append(f"--- {pathlib.Path(p.args[0]).name} {n} (exit {p.returncode}) ---\n{log}")
            else:
                os.replace(tmp, _lib_path(n))
    if failed:
        raise RuntimeError("build of the port's native code failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0


def _first_build(name: str) -> None:
    """Build ``name`` if it is not built. On a machine with a card, every
    source not built yet starts with it, so a checkout's first run waits for
    the slowest compiler only; elsewhere (the CPU tests: no nvcc) ``name`` alone."""
    if _lib_path(name).exists():
        return
    import torch

    build(sources() + host_sources() if torch.cuda.is_available() else [name])


def library(name: str) -> ctypes.CDLL:
    """The loaded shared library of ``csrc/<name>.cu``, built on first use."""
    with _LOAD_LOCK:  # the first launches may come from several threads at once
        lib = _libs.get(name)
        if lib is None:
            _first_build(name)
            lib = ctypes.CDLL(str(_lib_path(name)))
            _libs[name] = lib
    return lib


def extension(name: str):
    """The imported extension module of ``csrc/<name>.cpp``, built on first use."""
    with _LOAD_LOCK:
        mod = _extensions.get(name)
        if mod is None:
            _first_build(name)
            spec = importlib.util.spec_from_file_location(name, _lib_path(name))
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            _extensions[name] = mod
    return mod


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
