"""Per-chunk latency and throughput metrics (counterpart of
``obs_rvc_tpu/serve/metrics.py``): a bounded window of per-chunk wall times
and counters, summarised as p50/p95 chunk latency, real-time factor,
audio-seconds per second, underruns, dropped input samples and failed steps.
One collector may be shared by several sessions; its updates take a lock.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import statistics
import threading
import time
from typing import Deque


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
    #: per-stage p50 wall ms (sessions that run staged with ``stage_timing``)
    stage_p50_ms: dict = dataclasses.field(default_factory=dict)

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


class ChunkMetrics:
    def __init__(self, chunk_seconds: float, window: int = 256):
        self.chunk_seconds = chunk_seconds
        self._times_ms: Deque[float] = collections.deque(maxlen=window)
        self._stage_ms: dict[str, Deque[float]] = {}
        self._window = window
        self._lock = threading.Lock()
        self.total_chunks = 0
        self.underruns = 0
        self.dropped_input_samples = 0
        self.errors = 0

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
        """Record one chunk's per-stage wall times (``{stage: ms}``)."""
        with self._lock:
            for name, ms in stage_ms.items():
                self._stage_ms.setdefault(name, collections.deque(maxlen=self._window)).append(ms)

    def record_error(self) -> None:
        """A chunk step raised and was replaced by silence."""
        with self._lock:
            self.errors += 1

    def snapshot(self) -> MetricsSnapshot:
        with self._lock:
            ts = sorted(self._times_ms)
            stage_p50 = {name: round(statistics.median(v), 3) for name, v in self._stage_ms.items() if v}
            counts = (self.total_chunks, self.underruns, self.dropped_input_samples, self.errors)
        total, underruns, dropped, errors = counts
        if not ts:
            return MetricsSnapshot(0, 0.0, 0.0, 0.0, 0.0, 0.0, underruns, dropped, errors, stage_p50)
        p50 = statistics.median(ts)
        p95 = ts[max(0, int(len(ts) * 0.95) - 1)]
        mean = sum(ts) / len(ts)
        return MetricsSnapshot(
            chunks=total,
            p50_ms=round(p50, 3),
            p95_ms=round(p95, 3),
            mean_ms=round(mean, 3),
            rtf=round((p50 / 1000.0) / self.chunk_seconds, 4),
            audio_seconds_per_second=round(self.chunk_seconds / (mean / 1000.0), 2),
            underruns=underruns,
            dropped_input_samples=dropped,
            errors=errors,
            stage_p50_ms=stage_p50,
        )
