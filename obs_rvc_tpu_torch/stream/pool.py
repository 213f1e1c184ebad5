"""Batched multi-stream serving pool (counterpart of ``obs_rvc_tpu/stream/pool.py``).

One :class:`StreamPool` drives ``capacity`` concurrent voice streams through
one batched step per tick (``RvcPipeline.step(..., batched=True)``, replayed
as CUDA graphs): each slot has its own rings, controls and streaming state,
and the worker steps every slot together at fixed shapes (detached or
starved slots process silence), so a tick's launches serve every stream.

A slot that is active but has no full input chunk is *frozen*: it rides the
batched step with silence, but its state and output are discarded, so the
stream resumes exactly where it left off (the reference accumulates and
waits, ``obs-rvc/src/lib.rs:811-828``). In ``fused`` mode the
``where(mask, new, cur)`` merge runs inside the tick's one CUDA graph, the
fed-slot mask a graph input; in ``staged`` mode the stage graphs step a copy
of the state and the merge follows them.

Slots attach and detach while the worker runs. Attach clears the slot's
state; a per-slot epoch counter drops what a tick computed from a state
older than the slot's current epoch, and the rows of such slots are zeroed
again after the tick. A slot whose resident state is still zeros is not
written on attach (``_slot_dirty``).

On a card every device operation of the pool goes on the pool's own CUDA
stream (each row's own, on a mesh; a row that spans cards has one on each),
in order: the chunks' upload, the
replay, the copy of the output into pinned host memory, a slot's clear and
the stale-epoch fixup (both issued under the pool's lock). A clear issued while a tick is in flight is
thereby ordered after the replay that reads the same rows. With
``pipelined=True`` a tick records an event after its output copy and
returns; the next tick (or :meth:`flush_pending`) waits on that event and
pushes the audio to the rings, so the copy of tick k-1 overlaps the compute
of tick k, at one tick of added output latency.

``io_dtype="int16"`` ships 16-bit PCM both ways; the casts (``rint`` on the
host on the way in, ``round`` in the graph on the way out) are inside the
fused graph. ``exec_cache=True`` shares the fused graph within the process
through :func:`~obs_rvc_tpu_torch.utils.exec_cache.cached_capture`.

**On a mesh** (``mesh=``, a ``('data', 'model')`` mesh from
:mod:`obs_rvc_tpu_torch.parallel`; ``capacity`` a multiple of its ``data``
axis): the slots split into ``n_data`` contiguous groups, one per data row.
Each row holds its slots' resident state on its first device and steps them
with its own pipeline (``parallel.shard_params``: ContentVec split along
``model`` over the row's devices, the rest on its first device), its own
batched graphs (fused or staged, captured on that device), its own CUDA
stream and its own pinned output. A tick dispatches every row, then
collects them; the lock, the epochs, the frozen-slot merge and the
attach/detach rules are the one-device pool's, slot by slot. With no mesh
the pool is one such row over the pipeline itself. The rows follow the
pipeline's weights: when they change, the next tick steps rows sharded
afresh (and captures their graphs again).

A row with more than one ``model`` entry is ``segmented`` (``stream/
pipeline.py``): its features run as per-device graph segments, whether its
entries are distinct cards or one card named several times, and its fused
tick is three pieces (the PCM cast and ``pre``; the features' segments; the
stages after them with the merge and the cast back), its staged tick the
stage graphs with the segments in place of the features graph. The row
keeps a CUDA stream on each card it spans, all current while it
dispatches, so a copy between its cards is ordered by events on those
streams. A row whose devices another process owns is refused.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import logging
import threading
import time
from typing import Optional

import numpy as np
import torch

from obs_rvc_tpu_torch.device import run_inline
from obs_rvc_tpu_torch.serve.metrics import ChunkMetrics
from obs_rvc_tpu_torch.stream.pipeline import RvcPipeline, StepControls
from obs_rvc_tpu_torch.stream.ringbuf import make_ring_buffer
from obs_rvc_tpu_torch.stream.state import StreamState
from obs_rvc_tpu_torch.utils.exec_cache import cached_capture

logger = logging.getLogger(__name__)


class PoolFullError(RuntimeError):
    """:meth:`StreamPool.attach` on a pool whose every slot is taken."""


def _merged(mask: torch.Tensor, new: StreamState, cur: StreamState) -> StreamState:
    """``where(mask, new, cur)`` row by row."""
    return StreamState(**{f.name: torch.where(mask[:, None], getattr(new, f.name), getattr(cur, f.name))
                          for f in dataclasses.fields(StreamState)})


def _write(dst: StreamState, src: StreamState) -> None:
    for f in dataclasses.fields(StreamState):
        getattr(dst, f.name).copy_(getattr(src, f.name))


def _tick_pre(pipe: RvcPipeline, pcm16: bool, states, chunks):
    if pcm16:
        chunks = chunks.float() * (1.0 / 32768.0)
    return pipe.stage_pre(states, chunks)


def _tick_after(pipe: RvcPipeline, pcm16: bool, states, buf, buf16, phone, controls, mask):
    new, out = pipe._after_features(states, buf, buf16, phone, controls)
    if pcm16:
        out = torch.clamp(torch.round(out * 32768.0), -32768.0, 32767.0).to(torch.int16)
    return _merged(mask, new, states), out


def _step_and_merge(pipe: RvcPipeline, pcm16: bool):
    """The fused tick: the int16 cast in with ``pcm16``, the batched step,
    the frozen-slot merge and the cast out, as the step's fused pieces;
    returns ``(merged state, emitted audio [B, chunk])``."""
    before = functools.partial(_tick_pre, pipe, pcm16)
    after = functools.partial(_tick_after, pipe, pcm16)

    def step_and_merge(states, chunks, controls, mask, run=run_inline):
        buf, buf16 = run("pre", before, states, chunks)
        phone = pipe._features(buf16, controls.index_rate, run)
        return run("after_features", after, states, buf, buf16, phone, controls, mask)

    return step_and_merge


class _Row:
    """One data row of a pool: slots ``lo:hi``, the pipeline that steps them,
    its first device and CUDA stream (and one on each other card the row
    spans), the slots' resident state, the fused tick's graph and the slots'
    controls on the device."""

    def __init__(self, pipeline: RvcPipeline, lo: int, hi: int, devices: list):
        self.pipeline, self.lo, self.hi = pipeline, lo, hi
        self.device = pipeline.device
        #: the row's CUDA stream (None on the CPU), where all its device work goes in order
        self.stream = torch.cuda.Stream(self.device) if self.device.type == "cuda" else None
        #: a stream on each other card the row spans, current beside :attr:`stream` while it dispatches
        self.other_streams = [torch.cuda.Stream(d) for d in dict.fromkeys(devices)
                              if d.type == "cuda" and d != self.device]
        with self.on_stream():
            self.states = StreamState.init_batch(pipeline.cfg, hi - lo, device=self.device)
        self.fused_step = None
        self.controls_dev: Optional[StepControls] = None
        self.controls_ver = -1

    def on_stream(self):
        """Every stream of the row current on its card, the first card current last."""
        if self.stream is None:
            return contextlib.nullcontext()
        stack = contextlib.ExitStack()
        for s in (*self.other_streams, self.stream):
            stack.enter_context(torch.cuda.stream(s))
        return stack


class StreamPool:
    def __init__(
        self,
        pipeline: RvcPipeline,
        capacity: int = 8,
        input_capacity_chunks: int = 8,
        output_capacity_chunks: int = 12,
        batch_min: int = 1,
        batch_deadline_ms: float = 30.0,
        default_controls: Optional[StepControls] = None,
        mode: str = "staged",
        exec_cache: bool = False,
        mesh=None,
        io_dtype: str = "float32",
        pipelined: bool = False,
    ):
        if mode not in ("staged", "fused"):
            raise ValueError(f"unknown pool mode {mode!r}")
        if io_dtype not in ("float32", "int16"):
            raise ValueError(f"unknown io_dtype {io_dtype!r}")
        if io_dtype == "int16" and mode != "fused":
            raise ValueError("io_dtype='int16' needs mode='fused' (the PCM cast is inside the fused graph)")
        if pipelined and mode != "fused":
            raise ValueError("pipelined=True needs mode='fused'")
        if capacity < 1:
            raise ValueError("capacity must be at least 1")
        if mesh is not None:
            if "data" not in mesh.axis_names or "model" not in mesh.axis_names:
                raise ValueError(f"pool mesh needs ('data','model') axes, got {mesh.axis_names}")
            n_data = mesh.shape["data"]
            if capacity % n_data:
                raise ValueError(f"capacity {capacity} not divisible by mesh data axis {n_data}")
            for r, row in enumerate(mesh.rows()):
                if not mesh.row_is_local(r):
                    raise ValueError(f"data row {r} of the mesh is another process's: a pool steps its own rows")
        self.pipeline = pipeline
        self.capacity = capacity
        #: the ('data', 'model') mesh the slots are split over (None: one row, the pipeline itself)
        self.mesh = mesh
        #: "staged" (a graph per stage, the merge after them) or "fused" (one graph a tick, the merge inside)
        self.mode = mode
        #: fused mode: share the tick's graph by key within the process
        self.exec_cache = exec_cache
        #: the PCM width of the chunks and the output on their way to and from the card
        self.io_dtype = io_dtype
        #: deliver a tick's output after the next tick's dispatch (fused mode)
        self.pipelined = pipelined
        #: (each row's pinned output and its event, fed mask, epochs) of the tick not delivered yet
        self._pending: Optional[tuple] = None
        #: controls a slot starts with when attach() gets none (the server's flags)
        self.default_controls = default_controls or StepControls.default()
        #: tick gate: step when ``>= min(batch_min, n_active)`` slots have a full
        #: chunk, or the first ready one has waited ``batch_deadline_ms``
        self.batch_min = batch_min
        self.batch_deadline_ms = batch_deadline_ms
        self._ready_since: Optional[float] = None
        cfg = pipeline.cfg
        self._chunk = cfg.sample_frame_size
        pipes = self._row_pipelines()
        per = capacity // len(pipes)
        #: the data rows, each stepping its own contiguous group of slots
        devices = mesh.rows() if mesh is not None else [[pipeline.device]]
        self._rows = [_Row(p, r * per, (r + 1) * per, devices[r]) for r, p in enumerate(pipes)]
        #: bumped by a change of any slot's controls; each row restacks its own on the device
        self._controls_version = 0
        #: wall ms of the last tick's phases: controls, drain, dispatch, d2h, merge
        self.last_tick_phases: dict = {}

        self._in = [make_ring_buffer(self._chunk * input_capacity_chunks) for _ in range(capacity)]
        self._out = [make_ring_buffer(self._chunk * output_capacity_chunks) for _ in range(capacity)]
        self._active = [False] * capacity
        self._controls = [self.default_controls for _ in range(capacity)]
        # bumped by _clear_slot: a tick's results for a slot of an older epoch are dropped
        self._epoch = [0] * capacity
        #: False while a slot's resident state is still zeros: _clear_slot then writes nothing
        self._slot_dirty = [False] * capacity
        self.metrics = ChunkMetrics(chunk_seconds=cfg.latency_seconds)

        self._lock = threading.Lock()
        self._wake = threading.Event()
        self._running = False
        self._thread: Optional[threading.Thread] = None

    def _on_stream(self):
        """The first row's stream (the only one without a mesh)."""
        return self._rows[0].on_stream()

    def _row_pipelines(self) -> list:
        if self.mesh is None:
            return [self.pipeline]
        from obs_rvc_tpu_torch.parallel.sharding import shard_params  # parallel imports stream: not at the top

        return shard_params(self.pipeline, self.mesh)

    def _refresh_rows(self) -> None:
        """Step with :attr:`pipeline`'s rows (on a mesh, those of its current
        weights: ``shard_params`` returns the same rows until they change)."""
        for row, pipe in zip(self._rows, self._row_pipelines()):
            if pipe is not row.pipeline:
                row.pipeline, row.fused_step = pipe, None

    def _row_of(self, slot: int) -> tuple[_Row, int]:
        row = self._rows[slot * len(self._rows) // self.capacity]
        return row, slot - row.lo

    @property
    def _states(self) -> StreamState:
        """The slots' resident state: the row's own tensors with one row, a
        copy of every row's joined on the first row's device with several."""
        if len(self._rows) == 1:
            return self._rows[0].states
        first = self._rows[0].device
        return StreamState(**{f.name: torch.cat([getattr(r.states, f.name).to(first) for r in self._rows])
                              for f in dataclasses.fields(StreamState)})

    # --- slot management ---

    def attach(self, controls: Optional[StepControls] = None) -> int:
        """Claim a free slot → slot id; raises :class:`PoolFullError` when full."""
        with self._lock:
            for i in range(self.capacity):
                if not self._active[i]:
                    self._active[i] = True
                    self._controls[i] = controls or self.default_controls
                    self._controls_version += 1
                    self._clear_slot(i)
                    return i
        raise PoolFullError("pool full")

    def detach(self, slot: int) -> None:
        with self._lock:
            self._active[slot] = False
            self._clear_slot(slot)

    def _clear_slot(self, i: int) -> None:
        # caller holds self._lock; the zeroing is ordered after any tick in flight on the pool's stream
        self._epoch[i] += 1
        if self._slot_dirty[i]:
            row, j = self._row_of(i)
            with row.on_stream():
                for f in dataclasses.fields(StreamState):
                    getattr(row.states, f.name)[j].zero_()
            self._slot_dirty[i] = False
        while self._in[i].pop(self._chunk).size:
            pass
        while self._out[i].pop(self._chunk).size:
            pass

    def _zero_rows(self, rows: np.ndarray) -> None:
        """Zero the state of the slots where ``rows`` (``[capacity]`` bool) is set, each on its row's stream."""
        for row in self._rows:
            if not rows[row.lo : row.hi].any():
                continue
            with row.on_stream():
                mask = torch.from_numpy(np.ascontiguousarray(rows[row.lo : row.hi])).to(row.device)
                for f in dataclasses.fields(StreamState):
                    getattr(row.states, f.name).masked_fill_(mask[:, None], 0.0)

    def update_controls(self, slot: int, **kwargs) -> None:
        """Replace a slot's live controls (``pitch_shift``, ``rms_mix_rate``,
        ``index_rate``, ``sid``) from its next tick on."""
        unknown = set(kwargs) - {f.name for f in dataclasses.fields(StepControls)}
        if unknown:
            raise ValueError(f"unknown controls {sorted(unknown)}")
        cast = {k: int(v) if k == "sid" else float(v) for k, v in kwargs.items()}
        with self._lock:
            self._controls[slot] = dataclasses.replace(self._controls[slot], **cast)
            self._controls_version += 1

    # --- audio sides ---

    def push_audio(self, slot: int, frame: np.ndarray) -> int:
        frame = np.asarray(frame, np.float32).ravel()
        written = self._in[slot].push(frame)
        dropped = frame.size - written
        if dropped:
            self.metrics.record_dropped(dropped)
        self._wake.set()
        return dropped

    def pull_audio(self, slot: int, n: int) -> np.ndarray:
        return self._out[slot].pop(n)

    # --- batched worker ---

    def ready_slots(self) -> tuple[int, int]:
        """``(n_ready, n_active)``: active slots with a full input chunk, and active slots."""
        with self._lock:
            flags = [(self._active[i], self._in[i].available() >= self._chunk) for i in range(self.capacity)]
        n_active = sum(a for a, _ in flags)
        n_ready = sum(a and r for a, r in flags)
        return n_ready, n_active

    def should_step(self, now: Optional[float] = None) -> bool:
        """Tick gate: enough ready slots to batch, or the first ready chunk
        has waited ``batch_deadline_ms``."""
        n_ready, n_active = self.ready_slots()
        if n_ready == 0:
            self._ready_since = None
            return False
        if now is None:
            now = time.monotonic()
        if self._ready_since is None:
            self._ready_since = now
        if n_ready >= min(self.batch_min, max(n_active, 1)):
            return True
        return (now - self._ready_since) * 1000.0 >= self.batch_deadline_ms

    def _controls_device(self, controls_snap, version: int, row: Optional[_Row] = None) -> StepControls:
        """A row's slots' controls (the first row's by default: every slot's
        without a mesh) stacked into tensors on its device, kept until a
        control changes."""
        row = row or self._rows[0]
        if row.controls_dev is None or row.controls_ver != version:
            row.controls_dev = StepControls.stack(controls_snap[row.lo : row.hi], row.device)
            row.controls_ver = version
        return row.controls_dev

    def _fused(self, row: Optional[_Row] = None):
        """A row's fused tick graph (the first row's by default; per-device
        segments on a segmented row), captured on its streams at first use."""
        row = row or self._rows[0]
        if row.fused_step is None:
            n, pipe = row.hi - row.lo, row.pipeline
            pcm16 = self.io_dtype == "int16"
            example = (StreamState.init_batch(pipe.cfg, n, device=row.device),
                       torch.zeros(n, self._chunk, dtype=torch.int16 if pcm16 else torch.float32),
                       StepControls.stack([StepControls.default()] * n, row.device),
                       torch.zeros(n, dtype=torch.bool))
            graph = pipe._graphed(_step_and_merge(pipe, pcm16), example, f"pool_fused_merge[{n}]")
            with row.on_stream():
                if self.exec_cache:
                    graph, _ = cached_capture(graph, example, semantic_key=pipe.fingerprint()
                                              + f"|pool_fused_merge|capacity={n}|io={self.io_dtype}")
                else:
                    graph.capture()
            row.fused_step = graph
        return row.fused_step

    def prepare(self) -> None:
        """Capture every row's tick graphs now (the server calls it before it listens)."""
        self._refresh_rows()
        for row in self._rows:
            if self.mode == "fused":
                self._fused(row)
            else:
                with row.on_stream():
                    row.pipeline.staged_batch_graphs(row.hi - row.lo).capture()

    def _to_device(self, a: np.ndarray, row: Optional[_Row] = None) -> torch.Tensor:
        row = row or self._rows[0]
        t = torch.from_numpy(np.ascontiguousarray(a))
        if row.device.type != "cuda":
            return t.to(row.device)
        return t.pin_memory().to(row.device, non_blocking=True)

    def _dispatch(self, row: _Row, chunks: np.ndarray, have: np.ndarray, controls: StepControls):
        """Enqueue one row's tick on its stream: upload, step, merge, and the
        output's copy into pinned host memory. Returns ``(host output, event)``
        (the event None on the CPU, where the output is ready)."""
        chunks_dev, mask_dev = self._to_device(chunks, row), self._to_device(have, row)
        if self.mode == "staged":
            work = row.states.map(torch.clone)  # the merge reads the pre-step state
            _, out = row.pipeline.staged_step(work, chunks_dev, controls, batched=True)
            _write(row.states, _merged(mask_dev, work, row.states))
        else:
            graph = self._fused(row)
            with graph.lock:  # the graph's outputs are read before anyone replays it again
                merged, out = graph.run(row.states, chunks_dev, controls, mask_dev)
                _write(row.states, merged)
                return self._to_host(out, row)
        return self._to_host(out, row)

    @staticmethod
    def _to_host(out: torch.Tensor, row: _Row):
        if row.device.type != "cuda":
            return out.cpu().clone(), None
        host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
        host.copy_(out, non_blocking=True)
        event = torch.cuda.Event()
        event.record(row.stream)
        return host, event

    @staticmethod
    def _audio(host: torch.Tensor) -> np.ndarray:
        out = host.numpy()
        return out.astype(np.float32) * (1.0 / 32768.0) if out.dtype == np.int16 else out

    def _collect(self, sent: list) -> np.ndarray:
        """The rows' ``(host output, event)``: wait for each, join them ``[capacity, chunk]``."""
        outs = []
        for host, event in sent:
            if event is not None:
                event.synchronize()
            outs.append(self._audio(host))
        return outs[0] if len(outs) == 1 else np.concatenate(outs)

    def process_pending(self) -> int:
        """One batched step when at least one active slot has a full chunk;
        returns the slots fed.

        Slots without a full chunk ride the step with silence but are frozen:
        their post-step state and output are discarded by the merge, so a
        starved stream resumes with its context intact. Slots cleared while
        the tick ran (epoch moved) get their rows zeroed again after it."""
        t0 = time.perf_counter()
        with self._lock:
            active = list(self._active)
            controls_snap = list(self._controls)
            cver = self._controls_version
            epochs = list(self._epoch)

        controls = []
        for row in self._rows:
            with row.on_stream():
                controls.append(self._controls_device(controls_snap, cver, row))
        t_controls = time.perf_counter()

        chunks = np.zeros((self.capacity, self._chunk), np.float32)
        have = np.zeros(self.capacity, bool)
        for i in range(self.capacity):
            if not active[i]:
                continue
            c = self._in[i].pop_exact(self._chunk)
            if c is not None:
                chunks[i] = c
                have[i] = True
        if not have.any():
            return 0
        self._ready_since = None
        if self.io_dtype == "int16":
            # rint on the way in, as the output's round on the way out: half an LSB, unbiased
            chunks = np.clip(np.rint(chunks * 32768.0), -32768, 32767).astype(np.int16)
        t_drain = time.perf_counter()
        failed = False
        out = None
        with self.metrics.time_chunk(), torch.no_grad():
            try:
                self._refresh_rows()
                sent = []  # every row dispatched, then collected
                for row, ctl in zip(self._rows, controls):
                    with row.on_stream():
                        sent.append(self._dispatch(row, chunks[row.lo : row.hi], have[row.lo : row.hi], ctl))
                t_step = time.perf_counter()
                if self.pipelined:
                    t_d2h = t_step  # delivered after the next tick's dispatch, or on flush
                else:
                    out = self._collect(sent)
                    t_d2h = time.perf_counter()
            except Exception:
                logger.exception("batched step failed; emitting silence for fed slots and resetting them")
                self.metrics.record_error()
                failed = True
                # a stashed tick's audio precedes this tick's silence
                self.flush_pending()
                t_step = t_d2h = time.perf_counter()
                out = np.zeros((self.capacity, self._chunk), np.float32)

        with self._lock:
            # output goes only to slots that consumed input this tick and were not cleared meanwhile
            fresh_ok = [have[i] and self._epoch[i] == epochs[i] for i in range(self.capacity)]
            stale = np.array([self._epoch[i] != epochs[i] for i in range(self.capacity)])
            if failed:
                self._zero_rows(have | stale)  # fed slots restart from zeros; frozen ones keep their context
            elif stale.any():
                self._zero_rows(stale)
            for i in range(self.capacity):
                if stale[i]:
                    self._slot_dirty[i] = False  # the fixup restored zeros
                elif have[i]:
                    self._slot_dirty[i] = not failed
                if out is not None and fresh_ok[i]:
                    self._out[i].push(out[i])
        t_pub = time.perf_counter()
        if self.pipelined and not failed:
            # deliver the previous tick's audio while the device runs this one, then stash this one
            self.flush_pending()
            self._pending = (sent, have, epochs)
        t_end = time.perf_counter()
        self.last_tick_phases = {
            "controls_ms": (t_controls - t0) * 1e3,
            "drain_ms": (t_drain - t_controls) * 1e3,
            "dispatch_ms": (t_step - t_drain) * 1e3,
            "d2h_ms": (t_d2h - t_step) * 1e3 + (t_end - t_pub) * 1e3,
            "merge_ms": (t_pub - t_d2h) * 1e3,
        }
        return int(have.sum())

    def flush_pending(self) -> None:
        """Pipelined mode: wait for the stashed tick's output and deliver it
        (epoch-checked, as a synchronous tick does). A wait that surfaces a
        device failure emits silence for that tick's fed slots and resets
        their state."""
        prev, self._pending = self._pending, None
        if prev is None:
            return
        sent, have, epochs = prev
        try:
            out = self._collect(sent)
            ok = True
        except Exception:
            logger.exception("pipelined output copy failed; silence for fed slots and reset")
            self.metrics.record_error()
            out = np.zeros((self.capacity, self._chunk), np.float32)
            ok = False
        with self._lock:
            for i in range(self.capacity):
                if have[i] and (not ok or self._epoch[i] == epochs[i]):
                    self._out[i].push(out[i])
            if not ok:
                self._zero_rows(np.asarray(have, bool))
                for i in np.nonzero(have)[0]:
                    self._epoch[int(i)] += 1  # drop in-flight results for these slots
                    self._slot_dirty[int(i)] = False

    def _loop(self) -> None:
        with torch.no_grad():  # grad mode is thread-local
            while self._running:
                if self.should_step() and self.process_pending():
                    continue
                if self._pending is not None:
                    # quiescent with a stashed tick: deliver it now
                    self.flush_pending()
                    continue
                # sleep until more audio arrives or, with a chunk waiting, the batching deadline
                timeout = 1.0
                if self._ready_since is not None:
                    timeout = max(self.batch_deadline_ms / 1000.0 / 4, 0.001)
                self._wake.wait(timeout=timeout)
                self._wake.clear()

    def start(self) -> None:
        if self._thread is None:
            self._running = True
            self._thread = threading.Thread(target=self._loop, daemon=True, name="rvc-pool")
            self._thread.start()

    def stop(self) -> None:
        if self._thread is not None:
            self._running = False
            self._wake.set()
            self._thread.join()
            self._thread = None
        self.flush_pending()
