"""Host-side stream session: ring buffers and a worker thread around the step
(counterpart of ``obs_rvc_tpu/stream/scheduler.py``).

The audio side pushes mono device-rate frames of any size and pulls
converted ones; the worker drains whole chunks through the step, as the
JAX session's modes do: "staged" (the default) replays a CUDA graph per
stage (``RvcPipeline.staged_step``), "fused" one graph of the whole step
(``RvcPipeline.jit_step``, through ``utils/exec_cache.cached_capture`` with
``exec_cache=True``). Sessions over one pipeline share its graphs. They are
captured at :meth:`StreamSession.start` (or the first chunk), so a chunk on
the worker thread only copies in, replays and copies out. On the CPU the
same calls run the step eagerly.

- A step that raises emits one chunk of silence, resets the stream state,
  logs the error and counts it in ``metrics.errors``, so audio keeps flowing
  and a persistent fault shows in ``/metrics``.
- The state's tensors stay the same objects for the session's life: each
  step writes the new state into them (the graphed steps donate the
  state), and a reset or restore writes into them too.
- Live controls are swapped whole (one assignment of a frozen
  :class:`StepControls`), never mutated in place.
- The state's tensors live on the pipeline's device; the rings are host
  memory.
"""

from __future__ import annotations

import dataclasses
import logging
import threading
from typing import Optional

import numpy as np
import torch

from obs_rvc_tpu_torch.serve.metrics import ChunkMetrics
from obs_rvc_tpu_torch.stream.pipeline import RvcPipeline, StepControls
from obs_rvc_tpu_torch.stream.ringbuf import make_ring_buffer
from obs_rvc_tpu_torch.stream.state import StreamState
from obs_rvc_tpu_torch.utils.exec_cache import cached_capture

logger = logging.getLogger(__name__)

MODES = ("staged", "fused")


class StreamSession:
    def __init__(
        self,
        pipeline: RvcPipeline,
        controls: Optional[StepControls] = None,
        input_capacity_chunks: int = 8,
        output_capacity_chunks: int = 12,
        mode: str = "staged",
        stage_timing: bool = False,
        metrics: Optional[ChunkMetrics] = None,
        exec_cache: bool = False,
    ):
        if mode not in MODES:
            raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
        self.pipeline = pipeline
        self.controls = controls if controls is not None else StepControls.default()
        self.mode = mode
        #: fused mode: take the step's graph from cached_capture, shared by key
        self.exec_cache = exec_cache
        self._fused_step = None
        #: per-stage wall times into the metrics (staged mode; each stage then
        #: ends in a device synchronize)
        self.stage_timing = stage_timing
        cfg = pipeline.cfg
        self._chunk = cfg.sample_frame_size
        self._in = make_ring_buffer(self._chunk * input_capacity_chunks)
        self._out = make_ring_buffer(self._chunk * output_capacity_chunks)
        self.state = pipeline.new_state()
        #: pass one ChunkMetrics to several sessions to aggregate them
        self.metrics = metrics if metrics is not None else ChunkMetrics(chunk_seconds=cfg.latency_seconds)
        self._running = False
        self._thread: Optional[threading.Thread] = None
        self._wake = threading.Event()

    # --- audio side ---

    def push_audio(self, frame: np.ndarray) -> int:
        """Push mono device-rate samples; returns how many were dropped
        because the worker fell behind (the newest, counted)."""
        frame = np.asarray(frame, np.float32).ravel()
        dropped = frame.size - self._in.push(frame)
        if dropped:
            self.metrics.record_dropped(dropped)
        self._wake.set()
        return dropped

    def pull_audio(self, n: int) -> np.ndarray:
        """Up to ``n`` converted samples; fewer counts an underrun."""
        out = self._out.pop(n)
        if out.size < n:
            self.metrics.record_underrun()
        return out

    # --- worker side ---

    def prepare(self) -> None:
        """Capture this mode's graphs now, if nobody has yet (the server calls
        it once before it listens, and :meth:`start` for each session)."""
        if self.mode == "fused":
            self._fused()
        else:
            self.pipeline.staged_graphs.capture()

    def _fused(self):
        if self._fused_step is None:
            step = self.pipeline.jit_step
            if self.exec_cache:
                step, _ = cached_capture(step, step.graph.static_args,
                                         semantic_key=self.pipeline.fingerprint() + "|jit_step")
            else:
                step.capture()
            self._fused_step = step
        return self._fused_step

    def _step(self, chunk: np.ndarray) -> np.ndarray:
        chunk = torch.from_numpy(chunk)
        if self.mode == "fused":
            _, out = self._fused()(self.state, chunk, self.controls)
        else:
            stage_times = {} if self.stage_timing else None
            _, out = self.pipeline.staged_step(self.state, chunk, self.controls, stage_times=stage_times)
            if stage_times:
                self.metrics.record_stages(stage_times)
        return out.cpu().numpy()

    def _reset_state(self) -> None:
        for t in vars(self.state).values():
            t.zero_()

    def process_pending(self, max_chunks: int = 4) -> int:
        """Run up to ``max_chunks`` chunk steps; returns the chunks produced."""
        done = 0
        for _ in range(max_chunks):
            chunk = self._in.pop_exact(self._chunk)
            if chunk is None:
                break
            with self.metrics.time_chunk():
                try:
                    out = self._step(chunk)
                except Exception:
                    logger.exception("chunk step failed; emitting silence and resetting state")
                    self.metrics.record_error()
                    out = np.zeros(self._chunk, np.float32)
                    self._reset_state()
            self._out.push(out)
            done += 1
        return done

    def _loop(self) -> None:
        # grad mode is thread-local: the worker turns it off for itself
        with torch.no_grad():
            while self._running:
                if self.process_pending() == 0:
                    self._wake.wait(timeout=1.0)
                    self._wake.clear()

    # --- lifecycle ---

    def start(self) -> None:
        if self._thread is None:
            self.clear()
            self.prepare()
            self._running = True
            self._thread = threading.Thread(target=self._loop, daemon=True, name="rvc-worker")
            self._thread.start()

    def stop(self, timeout: Optional[float] = None) -> None:
        if self._thread is not None:
            self._running = False
            self._wake.set()
            self._thread.join(timeout)
            self._thread = None
            self.clear()

    def clear(self) -> None:
        """Zero the stream state and empty both rings."""
        self._reset_state()
        while self._in.pop(self._chunk).size:
            pass
        while self._out.pop(self._chunk).size:
            pass

    # --- snapshot / resume ---

    def snapshot(self) -> bytes:
        """The stream state's bytes (the model context, not the rings), in the
        JAX package's format. Take it with the worker stopped, or accept one
        in-flight chunk of staleness."""
        return self.state.to_bytes()

    def restore(self, data: bytes) -> None:
        """Resume from a snapshot of a session with the same geometry, taken
        by this package or the JAX one; a snapshot of another geometry is
        refused here, not at step time."""
        state = StreamState.from_bytes(data, device=self.pipeline.device)
        cfg = self.pipeline.cfg
        want = {
            "input_buffer": cfg.input_buffer_size,
            "input_buffer_16k": cfg.input_buffer_16k_size,
            "sola_buffer": cfg.sola_buffer_frame_size,
            "cache_pitchf": cfg.pitch_cache_len,
        }
        for name, n in want.items():
            got = tuple(getattr(state, name).shape)
            if got != (n,):
                raise ValueError(f"snapshot geometry mismatch: {name} is {got}, this session's "
                                 f"ChunkConfig needs ({n},)")
        for name in want:
            getattr(self.state, name).copy_(getattr(state, name))

    # --- live settings ---

    def update_controls(self, **kwargs) -> None:
        """Replace live controls (``pitch_shift``, ``rms_mix_rate``,
        ``index_rate``, ``sid``) from the next chunk on."""
        unknown = set(kwargs) - {f.name for f in dataclasses.fields(StepControls)}
        if unknown:
            raise ValueError(f"unknown controls {sorted(unknown)}")
        cast = {k: int(v) if k == "sid" else float(v) for k, v in kwargs.items()}
        self.controls = dataclasses.replace(self.controls, **cast)
