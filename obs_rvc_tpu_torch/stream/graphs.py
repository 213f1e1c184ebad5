"""CUDA graphs of the step's functions: the port's counterpart of ``jax.jit``
in ``obs_rvc_tpu/stream/pipeline.py`` and ``obs_rvc_tpu/stream/engine.py``.

A :class:`GraphedFunction` holds static copies of a function's arguments.
Each call copies the caller's arguments into them, replays one CUDA graph
of the function, and hands back the graph's own output tensors. Controls
travel as 0-d tensors among those arguments, so a new value never needs a
new capture. Before the capture the function runs once on a side stream:
that builds cuFFT plans, the cuBLAS workspace, the kernels' weight packs and
every cached constant, none of which a capture may create. Every capture of
the process runs on one thread of its own (see :func:`_capture_thread`).

On the CPU there is no graph: the same object calls the function eagerly on
its static copies, the path the tests take. On a card a capture that fails
raises; nothing falls back to eager.

The graph bakes in the address of every weight it reads. A
:class:`WeightsVersion` watches the networks' parameters and buffers (their
storage and in-place version, and which modules they are), and a graph
captured over older weights is captured again at its next call.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import inspect
import itertools
import logging
import threading
import time
import weakref
from typing import Any, Callable, Iterable, Optional

import torch

logger = logging.getLogger(__name__)

#: calls of the function on a side stream before its capture
WARMUP_CALLS = 1
#: captures made by this process, all graphs together
CAPTURES = 0
_COUNT_LOCK = threading.Lock()
_capturer: Optional[concurrent.futures.ThreadPoolExecutor] = None


def _capture_thread() -> concurrent.futures.ThreadPoolExecutor:
    """The one thread that captures every graph of the process, started at
    the first capture. cuDNN and cuBLAS keep a handle per thread, made at the
    thread's first call; captured here, a new geometry's graph reuses the
    handles of the captures before it, whichever thread asked for it."""
    global _capturer
    with _COUNT_LOCK:
        if _capturer is None:
            _capturer = concurrent.futures.ThreadPoolExecutor(max_workers=1, thread_name_prefix="cuda-graph-capture")
        return _capturer


def leaves(tree) -> list:
    """The tensors, numbers and ``None``s of a tree of tuples, lists and dataclasses, in order."""
    if isinstance(tree, (tuple, list)):
        return [leaf for item in tree for leaf in leaves(item)]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [leaf for f in dataclasses.fields(tree) for leaf in leaves(getattr(tree, f.name))]
    return [tree]


def _rebuild(tree, it):
    if isinstance(tree, (tuple, list)):
        return type(tree)(_rebuild(item, it) for item in tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return type(tree)(**{f.name: _rebuild(getattr(tree, f.name), it) for f in dataclasses.fields(tree)})
    return next(it)


def tree_map(fn: Callable, tree):
    """``tree`` with each leaf replaced by ``fn(leaf)``."""
    return _rebuild(tree, iter([fn(leaf) for leaf in leaves(tree)]))


def weakly(fn: Callable) -> Callable:
    """``fn``, holding a bound method's object weakly: a graph that its
    object owns must not keep that object alive (the engine frees an evicted
    geometry's pipeline, graphs and pools as soon as it drops it)."""
    if not inspect.ismethod(fn):
        return fn
    ref = weakref.WeakMethod(fn)
    return lambda *args, **kwargs: ref()(*args, **kwargs)


def _static_leaf(leaf, device: torch.device):
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to(device).clone()
    if isinstance(leaf, bool) or leaf is None:
        return leaf
    if isinstance(leaf, int):
        return torch.tensor(leaf, dtype=torch.long, device=device)
    if isinstance(leaf, float):
        return torch.tensor(leaf, dtype=torch.float32, device=device)
    raise TypeError(f"a graphed function takes tensors, numbers and None, not {type(leaf).__name__}")


def _copy_in(static: list, args: list, name: str) -> None:
    if len(static) != len(args):
        raise ValueError(f"{name}: {len(args)} argument leaves, the graph was made for {len(static)}")
    for s, a in zip(static, args):
        if isinstance(s, torch.Tensor):
            if isinstance(a, torch.Tensor):
                if a.shape != s.shape:
                    raise ValueError(f"{name}: an argument of shape {tuple(a.shape)} where the graph "
                                     f"takes {tuple(s.shape)}")
                if a is not s:
                    s.copy_(a)
            else:
                s.fill_(a)
        elif a is not s:
            raise ValueError(f"{name}: {a!r} where the graph was made for the constant {s!r}")


class WeightsVersion:
    """The identity of the weights that ``modules()`` reads: the modules, and
    each parameter's and buffer's storage and in-place version. A
    ``load_state_dict`` bumps the versions; a cast to another dtype moves the
    storage. The list of tensors is taken again when a module is swapped, or
    when a module that puts new tensors in its buffers (the retrieval
    index) counts another load in its ``generation``."""

    def __init__(self, modules: Callable[[], Iterable[torch.nn.Module]]):
        self._modules = weakly(modules)
        self._ids: Optional[tuple] = None
        self._tensors: list = []

    def key(self) -> tuple:
        mods = tuple(self._modules())
        ids = tuple((id(m), getattr(m, "generation", 0)) for m in mods)
        if ids != self._ids:
            self._ids = ids
            self._tensors = [t for m in mods for t in itertools.chain(m.parameters(), m.buffers())]
        return ids + tuple((t.data_ptr(), t._version) for t in self._tensors)


class GraphedFunction:
    """``fn(*args)`` over static copies of ``example_args`` (which fix its
    shapes), replayed as one CUDA graph on a card and called eagerly on the
    CPU. ``weights`` returns the modules whose weights the graph reads; a
    change to them recaptures. ``pool`` is a graph memory pool to share with
    graphs that replay in the order they were captured, never at once."""

    def __init__(self, fn: Callable, example_args: tuple, *, device, name: str,
                 weights: Optional[Callable[[], Iterable[torch.nn.Module]]] = None, pool=None):
        self.fn = weakly(fn)
        self.name = name
        self.device = torch.device(device)
        self.static_args = tree_map(lambda leaf: _static_leaf(leaf, self.device), tuple(example_args))
        self._static_leaves = leaves(self.static_args)
        self.weights = weakly(weights) if weights is not None else None
        self._version = WeightsVersion(weights) if weights is not None else None
        self._pool = pool
        #: held from copy-in to the last read of the outputs; reentrant, so a
        #: caller may hold it around :meth:`run`
        self.lock = threading.RLock()
        #: captures of this graph; the seconds of the last one, and of its warm-up call
        self.captures = 0
        self.capture_seconds = self.warmup_seconds = 0.0
        self._graph: Optional[torch.cuda.CUDAGraph] = None
        self._out = None
        self._weights_key = None
        #: the stream of the last run: a run on another stream waits for its work first
        self._stream: Optional[torch.cuda.Stream] = None

    def capture(self) -> bool:
        """Capture now, unless a graph of the current weights is held (or
        this runs on the CPU). Returns whether it captured."""
        with self.lock:
            if self.device.type != "cuda":
                return False
            key = self._version.key() if self._version is not None else None
            if self._graph is not None and key == self._weights_key:
                return False
            self._capture(key)
            return True

    def _capture(self, key) -> None:
        global CAPTURES
        self._graph = self._out = None
        t0 = time.perf_counter()
        current = torch.cuda.current_stream(self.device)
        try:
            graph, out, warmup = _capture_thread().submit(self._record, current).result()
        except Exception as e:
            raise RuntimeError(f"CUDA graph capture of {self.name} failed: {e}") from e
        self._graph, self._out, self._weights_key = graph, out, key
        self.captures += 1
        self.capture_seconds, self.warmup_seconds = time.perf_counter() - t0, warmup
        with _COUNT_LOCK:
            CAPTURES += 1
        logger.info("captured %s in %.1f ms (the warm-up call %.1f ms)", self.name, self.capture_seconds * 1e3,
                    warmup * 1e3)

    def _record(self, caller: torch.cuda.Stream):
        """The warm-up and the capture, on the capture thread and a side
        stream ordered after ``caller``'s work; returns (graph, outputs,
        warm-up seconds). Not through ``torch.cuda.graph``, whose entry
        collects garbage and empties the allocator's cache while other
        sessions serve."""
        t0 = time.perf_counter()
        side = torch.cuda.Stream(self.device)
        side.wait_stream(caller)
        graph = torch.cuda.CUDAGraph()
        with torch.no_grad(), torch.cuda.stream(side):
            for _ in range(WARMUP_CALLS):
                self.fn(*self.static_args)
            side.synchronize()
            warmup = time.perf_counter() - t0
            # thread_local: the sessions' worker threads go on replaying other graphs meanwhile
            graph.capture_begin(pool=self._pool, capture_error_mode="thread_local")
            try:
                out = self.fn(*self.static_args)
            finally:
                graph.capture_end()
        caller.wait_stream(side)
        return graph, out, warmup

    def run(self, *args):
        """Copy ``args`` in and replay (on the CPU: call ``fn``) on the
        current stream; returns the graph's outputs, valid until its next
        replay. Hold :attr:`lock` from this call to the last read of what it
        returns (enqueued on the same stream: a run on another stream first
        waits for everything the last run's stream had enqueued)."""
        with self.lock:
            self.capture()  # before the copy-in: the warm-up calls write the static arguments
            if self.device.type == "cuda":
                stream = torch.cuda.current_stream(self.device)
                if self._stream is not None and self._stream != stream:
                    stream.wait_stream(self._stream)
                self._stream = stream
            _copy_in(self._static_leaves, leaves(args), self.name)
            if self._graph is None:
                return self.fn(*self.static_args)
            self._graph.replay()
            return self._out

    def __call__(self, *args):
        """:meth:`run`, with the outputs copied out of the graph's memory."""
        with self.lock:
            return tree_map(lambda t: t.clone() if isinstance(t, torch.Tensor) else t, self.run(*args))


def graph_pool(device):
    """A memory pool for graphs that replay in turn, on a card (None on the CPU)."""
    return torch.cuda.graph_pool_handle() if torch.device(device).type == "cuda" else None


def stage_runner(graphs: dict, device, pool, stage_times: Optional[dict] = None):
    """``run(name, fn, *args)`` for the stage-by-stage step: each stage's
    graph, captured at its first call from these args (``graphs`` keeps
    them by name), replayed; with ``stage_times``, each replay ends in a
    synchronize and its wall ms is written under the stage's name."""

    def run(name: str, fn: Callable, *args) -> Any:
        graph = graphs.get(name)
        if graph is None:
            graph = graphs[name] = GraphedFunction(fn, args, device=device, name=f"stage_{name}", pool=pool)
        t0 = time.perf_counter()
        out = graph.run(*args)
        if stage_times is not None:
            if graph.device.type == "cuda":
                torch.cuda.synchronize(graph.device)
            stage_times[name] = (time.perf_counter() - t0) * 1e3
        return out

    return run
