"""Per-chunk latency and throughput metrics (counterpart of
``obs_rvc_tpu/serve/metrics.py``): a bounded window of per-chunk wall times
and counters, summarised as p50/p95 chunk latency, real-time factor,
audio-seconds per second, underruns, dropped input samples and failed steps.
One collector may be shared by several sessions; its updates take a lock.

Besides, the serving path's spans and counters (:class:`Spans`), kept two
ways: per door, in the :class:`ChunkMetrics` of the session or pool whose
work recorded them (``/metrics`` shows them), and per process, read through
:func:`process_snapshot`. A door marks its work with
:meth:`ChunkMetrics.door`; what the layers below record inside it (a span,
a graph's counters, a stage's device time) goes to that door's collector
and to the process's.

- A span (:class:`span`) is a named host interval on
  ``time.perf_counter_ns``: with no profiler running it costs two clock
  reads and an append under each collector's lock. While a
  ``torch.profiler`` runs it is also a profiler range of the same name, a
  CPU-side range that leaves no event on the device's timeline, so a trace
  shows each idle gap of the device under the program range the host was in.
- Stage times are device ms from CUDA events (``stream/graphs.py``), kept
  per stage as ``stage.<stage>`` and the summed waits between stages as
  ``stage_gap``. The CPU's host-clocked stage times stay with their door.
- Marks inside a stage (:class:`Marks`): a network's forward names points
  between its blocks (CREPE's ``crepe.conv1`` … ``crepe.conv6``,
  ``crepe.head``), each span the time from the point before, kept under
  the name of the point that ends it. On a card a stage graph's capture
  bakes them in as CUDA events that every replay records again, read on
  the timed steps; on the CPU they are the host clock of a timed step.
- Counters: ``captures`` (every CUDA graph capture of the process),
  ``serving_captures`` (those a serving step made: a first chunk at a new
  geometry, a weights reload; each stalls a stream), ``graph.replays`` and
  ``graph.copies`` (the copies a graph's copy-in launches outside it).
"""

from __future__ import annotations

import collections
import contextlib
import contextvars
import dataclasses
import statistics
import threading
import time
from typing import Deque, Optional

import torch
from torch._C._profiler import _RecordFunctionFast

#: recent samples of each span the process-wide collector keeps for its percentiles
PROCESS_RESERVOIR = 4096
#: the prefix of a stage's device ms; the summed waits between a step's stages
STAGE, STAGE_GAP = "stage.", "stage_gap"

_profiling = torch._C._autograd._profiler_enabled


def _p95(ordered: list) -> float:
    return ordered[max(0, int(len(ordered) * 0.95) - 1)]


class Spans:
    """Named millisecond samples and named counters: per sample name the
    count, the total and the last ``reservoir`` samples; per counter its total."""

    def __init__(self, reservoir: int):
        self._reservoir = reservoir
        self._lock = threading.Lock()
        self._samples: dict[str, list] = {}  # name -> [count, total ms, recent ms]
        self._counters: dict[str, int] = {}

    def add(self, samples: dict) -> None:
        """Record ``{name: ms}``."""
        with self._lock:
            for name, ms in samples.items():
                s = self._samples.get(name)
                if s is None:
                    s = self._samples[name] = [0, 0.0, collections.deque(maxlen=self._reservoir)]
                s[0] += 1
                s[1] += ms
                s[2].append(ms)

    def count(self, counts: dict) -> None:
        """Add ``{name: n}`` to the counters."""
        with self._lock:
            for name, n in counts.items():
                self._counters[name] = self._counters.get(name, 0) + n

    def samples(self, name: str) -> list:
        """The recent samples of ``name``, oldest first (empty when none)."""
        with self._lock:
            s = self._samples.get(name)
            return list(s[2]) if s is not None else []

    def counter(self, name: str) -> int:
        with self._lock:
            return self._counters.get(name, 0)

    def snapshot(self) -> dict:
        """``{"spans": {name: {count, total_ms, p50_ms, p95_ms}}, "counters": {name: n}}``."""
        with self._lock:
            held = {name: (s[0], s[1], sorted(s[2])) for name, s in self._samples.items()}
            counters = dict(self._counters)
        spans = {name: {"count": n, "total_ms": round(total, 3), "p50_ms": round(statistics.median(ts), 3),
                        "p95_ms": round(_p95(ts), 3)}
                 for name, (n, total, ts) in sorted(held.items())}
        return {"spans": spans, "counters": counters}

    def reset(self) -> None:
        with self._lock:
            self._samples.clear()
            self._counters.clear()


_PROCESS = Spans(PROCESS_RESERVOIR)


class Door:
    """The door whose work is running (``with metrics.door(name):``, one
    object per entry): its collector, its name (a span's prefix:
    ``session``, ``pool``) and whether this is a serving step (not the
    door's ``prepare``)."""

    __slots__ = ("metrics", "name", "serving", "_token")

    def __init__(self, metrics: "ChunkMetrics", name: str, serving: bool):
        self.metrics, self.name, self.serving = metrics, name, serving

    def __enter__(self) -> "Door":
        self._token = _DOOR.set(self)
        return self

    def __exit__(self, *exc) -> None:
        _DOOR.reset(self._token)


_DOOR: contextvars.ContextVar[Optional[Door]] = contextvars.ContextVar("rvc_door", default=None)


def current_door() -> Optional[Door]:
    return _DOOR.get()


def process_snapshot() -> dict:
    """Every span and counter the process recorded, all doors together (and
    what ran outside any door), as :meth:`Spans.snapshot` gives them."""
    return _PROCESS.snapshot()


def process_samples(name: str) -> list:
    """The process's recent samples (ms) of span ``name``, oldest first."""
    return _PROCESS.samples(name)


def process_counter(name: str) -> int:
    return _PROCESS.counter(name)


def reset() -> None:
    """Forget the process's spans and counters (for tests)."""
    _PROCESS.reset()


def observe(samples: dict) -> None:
    """Record ``{name: ms}`` in the process's collector and the running door's."""
    _PROCESS.add(samples)
    door = _DOOR.get()
    if door is not None:
        door.metrics.spans.add(samples)


def count(counts: dict) -> None:
    """Add ``{name: n}`` to the process's counters and the running door's."""
    _PROCESS.count(counts)
    door = _DOOR.get()
    if door is not None:
        door.metrics.spans.count(counts)


def count_capture() -> None:
    """One CUDA graph capture; a serving step's also counts in ``serving_captures``."""
    door = _DOOR.get()
    count({"captures": 1, "serving_captures": 1} if door is not None and door.serving else {"captures": 1})


def record_step_stages(door: Optional[Door], stages: dict, gap: Optional[float], on_card: bool,
                       inner: Optional[dict] = None) -> None:
    """One step's stage ms (and, on a card, the device's summed wait between
    its stages; ``inner``, the spans :class:`Marks` named inside its stages)
    for the door that ran it; the process keeps the card's only."""
    samples = {STAGE + name: ms for name, ms in stages.items()}
    if gap is not None:
        samples[STAGE_GAP] = gap
    record_spans(door, {**samples, **(inner or {})}, on_card)


def record_spans(door: Optional[Door], spans: dict, on_card: bool) -> None:
    """``{name: ms}`` of one timed step for the door that ran it; the process keeps the card's only."""
    if on_card:
        _PROCESS.add(spans)
    if door is not None:
        door.metrics.spans.add(spans)


class Marks:
    """Named points inside one call of a stage's function, from which its
    spans are read: on a card CUDA timing events recorded on the current
    stream, ``external`` so that a graph's capture bakes each in as an
    event-record node that every replay records again; on the CPU the host
    clock. The first point opens the first span; each later one ends the
    span named after it."""

    __slots__ = ("on_card", "points")

    def __init__(self, on_card: bool):
        self.on_card = on_card
        self.points: list = []

    def mark(self, name: str) -> None:
        if self.on_card:
            point = torch.cuda.Event(enable_timing=True, external=True)
            point.record()
        else:
            point = time.perf_counter_ns()
        self.points.append((name, point))

    def spans(self) -> dict:
        """``{name: ms}`` of every point after the first; on a card it first
        waits for the last point's event (the caller's own wait for the step
        has as a rule already covered it)."""
        if self.on_card and self.points:
            self.points[-1][1].synchronize()
        return {name: (a.elapsed_time(b) if self.on_card else (b - a) * 1e-6)
                for (_, a), (name, b) in zip(self.points, self.points[1:])}


_MARKS: contextvars.ContextVar[Optional[Marks]] = contextvars.ContextVar("rvc_marks", default=None)


def stage_marks() -> Optional[Marks]:
    """Where the running stage's function records its :class:`Marks`, or
    None: set while a stage graph is captured on a card and while a timed
    step runs a stage on the CPU (``stream/graphs.py``), never else."""
    return _MARKS.get()


@contextlib.contextmanager
def marking(marks: Marks):
    """``with marking(marks):`` makes ``marks`` the :func:`stage_marks` of the block."""
    token = _MARKS.set(marks)
    try:
        yield marks
    finally:
        _MARKS.reset(token)


def profiler_range(name: str):
    """A profiler range named ``name`` while a profiler runs (CPU-side: no
    device event), else nothing."""
    return _RecordFunctionFast(name) if _profiling() else contextlib.nullcontext()


class span:
    """``with span(name):`` records the block's host ms under ``name``
    (:func:`observe`; :attr:`ms` after the block), and is a profiler range
    while a profiler runs."""

    __slots__ = ("name", "ms", "_t0", "_range")

    def __init__(self, name: str):
        self.name = name
        self.ms = 0.0
        self._range = None

    def __enter__(self) -> "span":
        if _profiling():
            self._range = _RecordFunctionFast(self.name)
            self._range.__enter__()
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> None:
        self.ms = (time.perf_counter_ns() - self._t0) * 1e-6
        observe({self.name: self.ms})
        if self._range is not None:
            self._range.__exit__(None, None, None)
            self._range = None


def door_span(part: str):
    """:class:`span` ``<door>.<part>`` inside a door's work; nothing outside one."""
    door = _DOOR.get()
    return span(f"{door.name}.{part}") if door is not None else contextlib.nullcontext()


@dataclasses.dataclass
class MetricsSnapshot:
    chunks: int
    p50_ms: float
    p95_ms: float
    mean_ms: float
    rtf: float
    audio_seconds_per_second: float
    underruns: int
    dropped_input_samples: int
    errors: int = 0
    #: per-stage p50 ms: device time by CUDA events on a card (every chunk's
    #: with ``stage_timing``, else every few), wall time on the CPU (``stage_timing``)
    stage_p50_ms: dict = dataclasses.field(default_factory=dict)
    #: the door's spans and stage times: ``{name: {count, total_ms, p50_ms, p95_ms}}``
    spans: dict = dataclasses.field(default_factory=dict)
    #: the door's counters (``captures``, ``serving_captures``, ``graph.replays``, ``graph.copies``)
    counters: dict = dataclasses.field(default_factory=dict)

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


class ChunkMetrics:
    def __init__(self, chunk_seconds: float, window: int = 256):
        self.chunk_seconds = chunk_seconds
        self._times_ms: Deque[float] = collections.deque(maxlen=window)
        self._lock = threading.Lock()
        self.total_chunks = 0
        self.underruns = 0
        self.dropped_input_samples = 0
        self.errors = 0
        #: this door's spans, stage times and counters (the last ``window`` samples of each)
        self.spans = Spans(window)

    def door(self, name: str, serving: bool = True) -> Door:
        """``with metrics.door(name):`` marks the door's work: what is
        recorded inside (on this thread) goes to this collector too;
        ``serving`` False for its ``prepare``."""
        return Door(self, name, serving)

    @contextlib.contextmanager
    def time_chunk(self):
        """Time one chunk step (recorded whether or not the step raised)."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.record((time.perf_counter() - t0) * 1000.0)

    def record(self, ms: float) -> None:
        with self._lock:
            self._times_ms.append(ms)
            self.total_chunks += 1

    def record_underrun(self) -> None:
        with self._lock:
            self.underruns += 1

    def record_dropped(self, samples: int) -> None:
        with self._lock:
            self.dropped_input_samples += samples

    def record_stages(self, stage_ms: dict) -> None:
        """Record one chunk's per-stage ms (``{stage: ms}``)."""
        self.spans.add({STAGE + name: ms for name, ms in stage_ms.items()})

    def record_error(self) -> None:
        """A chunk step raised and was replaced by silence."""
        with self._lock:
            self.errors += 1

    def snapshot(self) -> MetricsSnapshot:
        with self._lock:
            ts = sorted(self._times_ms)
            counts = (self.total_chunks, self.underruns, self.dropped_input_samples, self.errors)
        held = self.spans.snapshot()
        stage_p50 = {name[len(STAGE):]: s["p50_ms"] for name, s in held["spans"].items() if name.startswith(STAGE)}
        total, underruns, dropped, errors = counts
        if not ts:
            return MetricsSnapshot(0, 0.0, 0.0, 0.0, 0.0, 0.0, underruns, dropped, errors, stage_p50,
                                   held["spans"], held["counters"])
        p50 = statistics.median(ts)
        mean = sum(ts) / len(ts)
        return MetricsSnapshot(
            chunks=total,
            p50_ms=round(p50, 3),
            p95_ms=round(_p95(ts), 3),
            mean_ms=round(mean, 3),
            rtf=round((p50 / 1000.0) / self.chunk_seconds, 4),
            audio_seconds_per_second=round(self.chunk_seconds / (mean / 1000.0), 2),
            underruns=underruns,
            dropped_input_samples=dropped,
            errors=errors,
            stage_p50_ms=stage_p50,
            spans=held["spans"],
            counters=held["counters"],
        )
