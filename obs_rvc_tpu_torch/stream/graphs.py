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

A CUDA graph is one card's work. A function whose work spans cards (a mesh
row's split ContentVec and exact table, ``parallel/sharding.py``) is a
:class:`SegmentedFunction`: an ordered list of :class:`GraphedFunction`
segments, each on its own device, which the function's Python body names as
it runs (``run(name, fn, *args, device=)``, the calls that
:func:`~obs_rvc_tpu_torch.device.run_inline` runs eagerly).

What the serving path measures here goes to ``serve/metrics.py``'s
collectors: each capture (``captures``, and ``serving_captures`` inside a
door's serving step), each replay and the copies each copy-in launches, the
weights check of a graph that reads weights (``<door>.weights_check``; the
checks and the changes they found, ``weights.checks`` and ``weights.changes``), and
the staged step's stage times: a :class:`StageClock` records CUDA events at
the stage boundaries of every :data:`STAGE_EVENTS_EVERY`-th step, read once
they have completed (:func:`resolve_stages`), never by a synchronize.

Inside a stage, a network may name points between its blocks
(``metrics.Marks``: CREPE's conv stack). A stage graph's capture bakes
them in as CUDA events that every replay records again, so they are read
only on a timed step's replay, after the door's own wait for that step's
output and before the graph is launched again (the next replay overwrites
them): at the graph's next :meth:`GraphedFunction.run` or
:meth:`~GraphedFunction.replay`, or at once where the step waits for its
last event itself (``stage_times``). An untimed step reads nothing.
"""

from __future__ import annotations

import collections
import concurrent.futures
import contextlib
import dataclasses
import inspect
import itertools
import logging
import threading
import time
import weakref
from typing import Any, Callable, Iterable, Optional

import torch

from obs_rvc_tpu_torch.ops import _cuda
from obs_rvc_tpu_torch.serve import metrics

logger = logging.getLogger(__name__)

#: calls of the function on a side stream before its capture
WARMUP_CALLS = 1
#: without ``stage_timing``, the staged step times its stages by CUDA events every this many steps
STAGE_EVENTS_EVERY = 4
_CAPTURER_LOCK = threading.Lock()
_capturer: Optional[concurrent.futures.ThreadPoolExecutor] = None


def _capture_thread() -> concurrent.futures.ThreadPoolExecutor:
    """The one thread that captures every graph of the process, started at
    the first capture. cuDNN and cuBLAS keep a handle per thread, made at the
    thread's first call; captured here, a new geometry's graph reuses the
    handles of the captures before it, whichever thread asked for it."""
    global _capturer
    with _CAPTURER_LOCK:
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


def _copy_in(static: list, args: list, name: str) -> int:
    """Copy ``args`` into the static leaves; returns the copies launched."""
    if len(static) != len(args):
        raise ValueError(f"{name}: {len(args)} argument leaves, the graph was made for {len(static)}")
    copies = 0
    for s, a in zip(static, args):
        if isinstance(s, torch.Tensor):
            if isinstance(a, torch.Tensor):
                if a.shape != s.shape:
                    raise ValueError(f"{name}: an argument of shape {tuple(a.shape)} where the graph "
                                     f"takes {tuple(s.shape)}")
                if a is not s:
                    s.copy_(a)
                    copies += 1
            else:
                s.fill_(a)
                copies += 1
        elif a is not s:
            raise ValueError(f"{name}: {a!r} where the graph was made for the constant {s!r}")
    return copies


class WeightsVersion:
    """The identity of the weights that ``modules()`` reads: the modules, and
    each parameter's and buffer's storage and in-place version. A
    ``load_state_dict`` bumps the versions; a cast to another dtype moves the
    storage. The list of tensors is taken again when a module is swapped, or
    when a module that puts new tensors in its buffers (the retrieval
    index) counts another load in its ``generation``.

    Two keys of one object are equal exactly when, between the calls that
    returned them, the modules stayed the same objects at the same
    ``generation`` and no tensor's storage or version was seen to change.
    The tensors are compared in one native call (``csrc/weights_snapshot.cpp``),
    which counts an epoch up whenever any differs from the last call; the
    key is the modules' ids and generations and that epoch. A change found
    takes the list of tensors again too, so the new tensors a cast puts in
    the buffers are the ones watched after it. Each call counts in
    ``weights.checks``, and a key unequal to the one before in
    ``weights.changes``."""

    def __init__(self, modules: Callable[[], Iterable[torch.nn.Module]]):
        self._modules = weakly(modules)
        self._ids: Optional[tuple] = None
        self._snapshot = None
        self._key: Optional[tuple] = None

    def key(self) -> tuple:
        mods = tuple(self._modules())
        ids = tuple((id(m), getattr(m, "generation", 0)) for m in mods)
        epoch = self._snapshot.advance() if ids == self._ids else None
        if epoch is None or epoch != self._key[-1]:
            # a change found takes the list again: a cast puts new tensors in the modules' buffers
            if self._snapshot is None:
                self._snapshot = _cuda.extension("weights_snapshot").Snapshot()
            self._ids = ids
            epoch = self._snapshot.take([t for m in mods for t in itertools.chain(m.parameters(), m.buffers())])
        key = ids + (epoch,)
        metrics.count({"weights.checks": 1, "weights.changes": int(self._key is not None and key != self._key)})
        self._key = key
        return key

    @property
    def tensors(self) -> int:
        """The parameters and buffers the last key covered."""
        return 0 if self._snapshot is None else len(self._snapshot)


class GraphedFunction:
    """``fn(*args)`` over static copies of ``example_args`` (which fix its
    shapes), replayed as one CUDA graph on a card and called eagerly on the
    CPU. ``weights`` returns the modules whose weights the graph reads; a
    change to them recaptures. ``pool`` is a graph memory pool to share with
    graphs that replay in the order they were captured, never at once."""

    def __init__(self, fn: Callable, example_args: tuple, *, device, name: str,
                 weights: Optional[Callable[[], Iterable[torch.nn.Module]]] = None, pool=None,
                 marked: bool = False):
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
        #: whether a capture records the function's marks (a stage's graph); those of the last
        #: capture, if it recorded any; the door a timed replay of them is to be read for
        self._marked = marked
        self.inner: Optional[metrics.Marks] = None
        self._unread: Any = _NOTHING

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
        self._graph = self._out = self.inner = None
        self._unread = _NOTHING
        t0 = time.perf_counter()
        current = torch.cuda.current_stream(self.device)
        try:
            graph, out, warmup, inner = _capture_thread().submit(self._record, current).result()
        except Exception as e:
            raise RuntimeError(f"CUDA graph capture of {self.name} failed: {e}") from e
        self._graph, self._out, self._weights_key = graph, out, key
        self.inner = inner if inner is not None and inner.points else None
        self.captures += 1
        self.capture_seconds, self.warmup_seconds = time.perf_counter() - t0, warmup
        metrics.count_capture()
        logger.info("captured %s in %.1f ms (the warm-up call %.1f ms)", self.name, self.capture_seconds * 1e3,
                    warmup * 1e3)

    def _record(self, caller: torch.cuda.Stream):
        """The warm-up and the capture, on the capture thread and a side
        stream ordered after ``caller``'s work; returns (graph, outputs,
        warm-up seconds, the marks the capture recorded or None). Not through
        ``torch.cuda.graph``, whose entry collects garbage and empties the
        allocator's cache while other sessions serve."""
        t0 = time.perf_counter()
        side = torch.cuda.Stream(self.device)
        side.wait_stream(caller)
        graph = torch.cuda.CUDAGraph()
        with torch.no_grad(), torch.cuda.stream(side):
            for _ in range(WARMUP_CALLS):
                self.fn(*self.static_args)
            side.synchronize()
            warmup = time.perf_counter() - t0
            # cuBLAS's workspace is PyTorch's, one per (handle, stream): every capture here has the
            # one handle of this thread, and its side streams come round again from PyTorch's pool,
            # so without this two graphs could bake in one workspace and race when they replay at
            # once (two mesh rows on one card). Dropped, the capture allocates a workspace of its
            # own from its memory pool, shared only with the graphs that replay in turn with it.
            torch._C._cuda_clearCublasWorkspaces()
            # thread_local: the sessions' worker threads go on replaying other graphs meanwhile
            graph.capture_begin(pool=self._pool, capture_error_mode="thread_local")
            inner = metrics.Marks(on_card=True) if self._marked else None
            try:
                with metrics.marking(inner) if inner is not None else contextlib.nullcontext():
                    out = self.fn(*self.static_args)
            finally:
                graph.capture_end()
                torch._C._cuda_clearCublasWorkspaces()
        caller.wait_stream(side)
        return graph, out, warmup, inner

    def run(self, *args):
        """Copy ``args`` in and replay (on the CPU: call ``fn``) on the
        current stream; returns the graph's outputs, valid until its next
        replay. Hold :attr:`lock` from this call to the last read of what it
        returns (enqueued on the same stream: a run on another stream first
        waits for everything the last run's stream had enqueued)."""
        with self.lock:
            if self._unread is not _NOTHING:
                self.read_inner()
            # before the copy-in: the warm-up calls write the static arguments
            if self._version is None:
                self.capture()
            else:
                with metrics.door_span("weights_check"):
                    self.capture()
            if self.device.type == "cuda":
                stream = torch.cuda.current_stream(self.device)
                if self._stream is not None and self._stream != stream:
                    stream.wait_stream(self._stream)
                self._stream = stream
            copies = _copy_in(self._static_leaves, leaves(args), self.name)
            if self._graph is None:
                metrics.count({"graph.copies": copies})
                return self.fn(*self.static_args)
            self._graph.replay()
            metrics.count({"graph.copies": copies, "graph.replays": 1})
            return self._out

    def replay(self) -> None:
        """Replay the captured graph on its static arguments as they stand:
        no copy-in, no weights check, no capture. For timing the graph alone
        (a function that writes its own arguments sees its last output)."""
        if self._graph is None:
            raise RuntimeError(f"{self.name} holds no captured graph")
        if self._unread is not _NOTHING:
            self.read_inner()
        self._graph.replay()

    def hold_inner(self, door: Optional[metrics.Door]) -> None:
        """The last replay was timed: read its :attr:`inner` marks for
        ``door`` before the graph is launched again."""
        self._unread = door

    def read_inner(self) -> None:
        """The held replay's marks, as spans, to its door and the process
        (a wait for its last event first; the door's own wait for the step
        has as a rule already covered it)."""
        with self.lock:
            door, self._unread = self._unread, _NOTHING
            if door is not _NOTHING and self.inner is not None:
                metrics.record_spans(door, self.inner.spans(), on_card=True)

    def __call__(self, *args):
        """:meth:`run`, with the outputs copied out of the graph's memory."""
        with self.lock:
            return tree_map(lambda t: t.clone() if isinstance(t, torch.Tensor) else t, self.run(*args))


#: no timed replay's marks wait to be read
_NOTHING = object()


def graph_pool(device):
    """A memory pool for graphs that replay in turn, on a card (None on the CPU)."""
    return torch.cuda.graph_pool_handle() if torch.device(device).type == "cuda" else None


def _card(device) -> torch.device:
    """``device`` with its index: ``cuda`` is the current card."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


class StageClock:
    """One step's stage boundaries: on a card a CUDA timing event on the
    step's stream before and after each stage (no synchronize), on the CPU
    the host clock (the eager stages run synchronously there). A features
    segment (``"features/..."``, a :attr:`RvcPipeline.segmented` row's,
    which may run on another card) is not timed, and no gap is counted
    across it: on such a row the features stage is left out. The marks a
    stage's network names inside it (``metrics.Marks``) are a replayed
    graph's events on a card, held by the graph until read
    (:meth:`GraphedFunction.read_inner`), and the host clock on the CPU,
    delivered with the stages."""

    def __init__(self, device: torch.device):
        self.device = device
        self.on_card = device.type == "cuda"
        self._stream = torch.cuda.current_stream(device) if self.on_card else None
        #: (stage, start, end, whether an untimed piece ran since the last stage)
        self.marks: list = []
        self._broken = False
        #: the door whose step this is, and the process's captures when it began
        self.door = metrics.current_door()
        self.captures = metrics.process_counter("captures")
        #: the graphs whose marks this step replayed (a card's); the marks' spans (the CPU's)
        self.held: list = []
        self.inner: dict = {}

    def _mark(self):
        if not self.on_card:
            return time.perf_counter_ns()
        try:  # an event of a delivered step: creating one took ~20 us of host time on an H100 machine
            event = _FREE_EVENTS[self.device].pop()
        except IndexError:
            event = torch.cuda.Event(enable_timing=True)
        event.record(self._stream)
        return event

    def time(self, name: str, call: Callable, graph: Optional[GraphedFunction] = None) -> Any:
        """``call()``, between two marks under ``name``'s stage; ``graph``
        the stage's graph that ``call`` replays."""
        if "/" in name:
            self._broken = True
            return call()
        start = self._mark()
        if self.on_card:
            out = call()
            if graph is not None and graph.inner is not None:
                graph.hold_inner(self.door)
                self.held.append(graph)
        else:
            with metrics.marking(metrics.Marks(on_card=False)) as inner:
                out = call()
            self.inner.update(inner.spans())
        self.marks.append((name, start, self._mark(), self._broken))
        self._broken = False
        return out

    def done(self) -> bool:
        """Whether every mark has completed (by ``query``: never waits)."""
        return not self.on_card or not self.marks or self.marks[-1][2].query()

    def wait(self) -> None:
        """Wait for the step's last mark."""
        if self.on_card and self.marks:
            self.marks[-1][2].synchronize()

    def times(self) -> tuple[dict, Optional[float]]:
        """``({stage: ms}, summed ms between consecutive stages)``, once
        :meth:`done`; on the CPU no gap (``None``)."""
        stages, gap, prev = {}, 0.0, None
        for name, start, end, broken in self.marks:
            stages[name] = self._ms(start, end)
            if prev is not None and not broken:
                gap += self._ms(prev, start)
            prev = end
        return stages, (gap if self.on_card else None)

    def _ms(self, a, b) -> float:
        return a.elapsed_time(b) if self.on_card else (b - a) * 1e-6


#: timed steps whose events are not resolved yet, oldest first
_PENDING: collections.deque = collections.deque(maxlen=64)
#: the timing events of delivered steps, by card, for later steps to record again
_FREE_EVENTS: collections.defaultdict = collections.defaultdict(list)
_PENDING_LOCK = threading.Lock()
_STEPS = itertools.count()


def stage_clock(device, every_step: bool = False) -> Optional[StageClock]:
    """The clock of a staged step on ``device``, or None for an untimed one:
    on a card every :data:`STAGE_EVENTS_EVERY`-th step (every one with
    ``every_step``), never while the stream is being captured; on the CPU
    only with ``every_step``."""
    device = _card(device)
    if device.type != "cuda":
        return StageClock(device) if every_step else None
    if torch.cuda.is_current_stream_capturing():
        return None
    if every_step or next(_STEPS) % STAGE_EVENTS_EVERY == 0:
        return StageClock(device)
    return None


def finish_stages(clock: Optional[StageClock], stage_times: Optional[dict] = None) -> None:
    """After the step's work is enqueued: with ``stage_times``, wait for the
    step's last event and write each stage's ms into it. The step's times go
    to its door and the process (:func:`metrics.record_step_stages`) once its
    events complete (now on the CPU, else at :func:`resolve_stages`), unless
    a graph was captured meanwhile (its warm-up ran between the events)."""
    if clock is None:
        return
    if stage_times is not None:
        clock.wait()
        stage_times.update(clock.times()[0])
        for graph in clock.held:
            graph.read_inner()
    if metrics.process_counter("captures") != clock.captures:
        return
    if clock.done():
        _deliver(clock)
    else:
        with _PENDING_LOCK:
            _PENDING.append(clock)


def resolve_stages() -> None:
    """Deliver the timed steps whose events have completed, oldest first
    (by ``query``: never waits). A staged step calls it once its own work
    is enqueued: the steps before it, whose output their door has waited
    for, are read while the device runs this one."""
    while True:
        with _PENDING_LOCK:
            if not _PENDING or not _PENDING[0].done():
                return
            clock = _PENDING.popleft()
        _deliver(clock)


def _deliver(clock: StageClock) -> None:
    stages, gap = clock.times()
    if stages:
        metrics.record_step_stages(clock.door, stages, gap, clock.on_card, clock.inner)
    if clock.on_card:
        _FREE_EVENTS[clock.device].extend(e for _, start, end, _ in clock.marks for e in (start, end))


def stage_runner(graphs: dict, device, pools: dict, clock: Optional[StageClock] = None):
    """``run(name, fn, *args, device=None)`` for the stage-by-stage step: each
    stage's graph, captured at its first call from these args on ``device``
    (by default the step's; ``graphs`` keeps them by name, ``pools`` one
    memory pool per card), replayed; with a ``clock``, between its marks
    (:class:`StageClock`)."""
    device = _card(device)

    def run(name: str, fn: Callable, *args, device=device) -> Any:
        graph = graphs.get(name)
        if graph is None:
            dev = _card(device)
            if dev not in pools:
                pools[dev] = graph_pool(dev)
            graph = graphs[name] = GraphedFunction(fn, args, device=dev, name=f"stage_{name}", pool=pools[dev],
                                                   marked=True)
        if clock is None:
            return graph.run(*args)
        return clock.time(name, lambda: graph.run(*args), graph)

    return run


class SegmentedFunction:
    """``fn(*args, run=...)`` as per-device graph segments: the same surface
    as :class:`GraphedFunction` (``run``, ``__call__``, ``capture``,
    ``static_args``, ``weights``, ``lock``, ``captures``) for a function
    whose work spans cards.

    ``fn``'s body passes each piece of device work to ``run(name, piece,
    *args, device=None)``. The first call of a name makes its segment: a
    :class:`GraphedFunction` of ``piece`` on ``device`` (default this
    function's), captured on that card's side stream over static copies of
    ``args``, in one memory pool per card (the segments replay in the order
    they were captured, every call). Later calls replay it: the arguments,
    another segment's outputs, are ``copy_``'d into its static inputs on its
    card, and PyTorch orders a copy between cards by events on the current
    stream of each (the caller makes a stream of its own current on each
    card, or they run on the cards' default streams). ``fn``'s body does no
    device work of its own. Its outputs are the last segments' own tensors,
    valid until the next call, as :meth:`GraphedFunction.run`'s are.

    ``weights`` covers every segment's modules: when they change, every
    segment is dropped and captured again at its next call. On the CPU each
    segment calls its piece eagerly over its static copies. A capture that
    fails raises; nothing falls back to eager."""

    def __init__(self, fn: Callable, example_args: tuple, *, device, name: str,
                 weights: Optional[Callable[[], Iterable[torch.nn.Module]]] = None):
        self.fn = weakly(fn)
        self.name = name
        self.device = _card(device)
        #: the example arguments' static copies: :meth:`capture` steps them
        self.static_args = tree_map(lambda leaf: _static_leaf(leaf, self.device), tuple(example_args))
        self.weights = weakly(weights) if weights is not None else None
        self._version = WeightsVersion(weights) if weights is not None else None
        self._weights_key = None
        self.lock = threading.RLock()
        #: the segments by name, in the order of their first call
        self.segments: dict[str, GraphedFunction] = {}
        self._pools: dict = {}
        self._dropped_captures = 0

    @property
    def captures(self) -> int:
        """Captures of every segment so far, dropped ones included."""
        return self._dropped_captures + sum(g.captures for g in self.segments.values())

    def _drop_if_weights_changed(self) -> None:
        key = self._version.key() if self._version is not None else None
        if key != self._weights_key:
            self._dropped_captures += sum(g.captures for g in self.segments.values())
            self.segments.clear()
            self._pools.clear()
            self._weights_key = key

    def _segment(self, name: str, piece: Callable, *args, device=None):
        graph = self.segments.get(name)
        if graph is None:
            dev = self.device if device is None else _card(device)
            if dev not in self._pools:
                self._pools[dev] = graph_pool(dev)
            graph = self.segments[name] = GraphedFunction(piece, args, device=dev, name=f"{self.name}/{name}",
                                                          pool=self._pools[dev])
        return graph.run(*args)

    def capture(self) -> bool:
        """Capture every segment now, by a call on the example arguments,
        unless segments of the current weights are held (or this runs on
        the CPU). Returns whether it captured."""
        with self.lock:
            if self.device.type != "cuda":
                return False
            self._drop_if_weights_changed()
            if self.segments:
                return False
            self.run(*self.static_args)
            return True

    def run(self, *args):
        """``fn(*args)`` through the segments; its outputs, valid until the
        next call (hold :attr:`lock` until they are read)."""
        with self.lock:
            with metrics.door_span("weights_check"):
                self._drop_if_weights_changed()
            return self.fn(*args, run=self._segment)

    def __call__(self, *args):
        """:meth:`run`, with the outputs copied out of the segments' memory."""
        with self.lock:
            return tree_map(lambda t: t.clone() if isinstance(t, torch.Tensor) else t, self.run(*args))
