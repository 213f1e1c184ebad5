"""The per-chunk conversion step and offline conversion (counterpart of
``obs_rvc_tpu/stream/pipeline.py``)::

    device-rate ring slide
    → 48k→16k resample into the 16 kHz ring
    → ContentVec features, 2x upsampled, skip_head/return_length slice
    → log-mel → RMVPE salience → f0 → pitch shift → 1024-frame cache slide
    → synthesizer (TextEncoder → flow⁻¹ → NSF generator)
    → model rate → device rate resample
    → RMS envelope mix
    → SOLA alignment + crossfade

The networks live in :class:`RvcPipeline`'s modules; the step takes the
stream's state and one chunk and returns the new state and the emitted
audio. Each stage is a method of its own (``stage_*``), so callers can run
and compare the stages one by one. ``with_config`` gives the same pipeline
at another geometry over the same networks (the engine's per-request
geometries).

Three ways to run the step, the JAX package's names:

- ``step``: eagerly, each operator sent from Python; the CPU path, the
  stage-by-stage diagnostic and what the graphs are held against.
- ``jit_step``: one CUDA graph of the whole step (``stream/graphs.py``),
  the state donated: the new state is written into the caller's tensors.
- ``staged_step``: a CUDA graph per stage, replayed in turn.

The live controls reach every path as 0-d float32 tensors (the speaker id
int64), so they are graph inputs: a new pitch shift or mix rate is written
before a replay and never recaptures. ``fingerprint()`` names what shapes a
graph, for ``utils/exec_cache.cached_capture``.

``compute_dtype`` is the networks' dtype (float32, or bfloat16 as the JAX
server serves): they are built in it and compute in it, and return float32.
The rings, the 16 kHz buffer, the log-mel, the pitch track and cache,
resampling, envelope mixing and SOLA stay float32, as in the JAX step.
"""

from __future__ import annotations

import copy
import dataclasses
import threading
import time
import weakref
from typing import Optional

import numpy as np
import torch
import torch.nn as nn

from obs_rvc_tpu_torch.config import ChunkConfig, RMVPE_HOP, ZC_16K, RvcModelVersion
from obs_rvc_tpu_torch.device import resolve_device
from obs_rvc_tpu_torch.dsp import (
    MelSpectrogram,
    apply_pitch_shift,
    decode_f0,
    envelope_mixing,
    fade_windows,
    get_f0_post,
    median_filter_f0,
    resample_poly,
    sola_crossfade,
    sola_offset,
)
from obs_rvc_tpu_torch.models import (
    ContentVec,
    ContentVecConfig,
    RMVPE,
    RMVPEConfig,
    Synthesizer,
    SynthesizerConfig,
)
from obs_rvc_tpu_torch.models.contentvec import extract_feature, feature_frames
from obs_rvc_tpu_torch.models.layers import VitsLayerNorm
from obs_rvc_tpu_torch.models.weights import load_state_dict
from obs_rvc_tpu_torch.stream.graphs import GraphedFunction, WeightsVersion, graph_pool, stage_runner
from obs_rvc_tpu_torch.stream.state import StreamState


def slide_pitch_cache(cache: torch.Tensor, f0: torch.Tensor, shift: int) -> torch.Tensor:
    """Slide the f0 cache left by ``shift`` frames and write the chunk's pitch
    track ``f0[3 : len-1]`` at offset ``len(cache) + 4 - len(f0)``. The slide
    keeps ``copy_within`` semantics: the vacated tail holds stale values
    until overwritten."""
    pitch_len = f0.shape[0]
    cache = torch.cat([cache[shift:], cache[-shift:]])
    cache[cache.shape[0] + 4 - pitch_len :] = f0[3 : pitch_len - 1]
    return cache


@dataclasses.dataclass(frozen=True)
class StepControls:
    """Live per-chunk controls."""

    pitch_shift: float = 0.0  # semitones
    rms_mix_rate: float = 1.0  # 0..1, 1 = no envelope mixing
    index_rate: float = 0.0  # retrieval blend (no retrieval in this port yet)
    sid: int = 0  # speaker id

    @staticmethod
    def default(pitch_shift: float = 0.0, rms_mix_rate: float = 1.0, index_rate: float = 0.0,
                sid: int = 0) -> "StepControls":
        return StepControls(float(pitch_shift), float(rms_mix_rate), float(index_rate), int(sid))

    def on(self, device) -> "StepControls":
        """The controls as 0-d tensors on ``device``, float32 and the speaker
        id int64, as the graphs hold them: every path then does the same
        float32 arithmetic on them. Filled on the device, no host copy."""
        def full(v, dtype):
            return v if isinstance(v, torch.Tensor) else torch.full((), v, dtype=dtype, device=device)

        return StepControls(full(self.pitch_shift, torch.float32), full(self.rms_mix_rate, torch.float32),
                            full(self.index_rate, torch.float32), full(self.sid, torch.long))


def _untimed(name: str, fn, *args):
    return fn(*args)


_NORMS = (nn.LayerNorm, nn.GroupNorm, nn.BatchNorm2d, VitsLayerNorm)


def _fan_in(owner: nn.Module, shape: tuple) -> int:
    """Inputs that reach one output of the layer holding a weight of ``shape``."""
    if isinstance(owner, (nn.ConvTranspose1d, nn.ConvTranspose2d)):
        return owner.in_channels * int(np.prod(owner.kernel_size)) // int(np.prod(owner.stride))
    return int(np.prod(shape[1:])) if len(shape) > 1 else 1


def _random_state_dict(module: nn.Module, host: np.random.Generator,
                       std: Optional[float]) -> dict[str, np.ndarray]:
    """Norm scales and variances 1, biases and means 0, every other weight
    ``std * N(0, 1)`` from ``host``; ``std=None`` scales each weight by
    ``1/sqrt(fan_in)`` instead, which keeps activations near unit size."""
    sd = {}
    for name, t in module.state_dict().items():
        owner_name, _, leaf = name.rpartition(".")
        owner = module.get_submodule(owner_name) if owner_name else module
        shape = tuple(t.shape)
        if leaf == "num_batches_tracked":
            sd[name] = np.zeros(shape, np.int64)
        elif (isinstance(owner, _NORMS) and leaf in ("weight", "running_var")) or leaf == "gamma":
            sd[name] = np.ones(shape, np.float32)
        elif "bias" in leaf or leaf in ("running_mean", "beta"):
            sd[name] = np.zeros(shape, np.float32)
        else:
            scale = std if std is not None else _fan_in(owner, shape) ** -0.5
            sd[name] = (host.standard_normal(shape) * scale).astype(np.float32)
    return sd


class RvcPipeline:
    """Chunk geometry + the three networks + the per-chunk step, all on one device."""

    def __init__(
        self,
        cfg: ChunkConfig,
        version: RvcModelVersion = RvcModelVersion.V2,
        f0_median_radius: int = 0,
        keyshift: int = 0,
        phase_vocoder: bool = False,
        contentvec_cfg: Optional[ContentVecConfig] = None,
        rmvpe_cfg: Optional[RMVPEConfig] = None,
        synth_cfg: Optional[SynthesizerConfig] = None,
        device=None,
        compute_dtype: torch.dtype = torch.float32,
    ):
        if compute_dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"compute_dtype must be float32 or bfloat16, not {compute_dtype}")
        self.device = resolve_device(device)
        self.compute_dtype = compute_dtype
        self.version = version
        self.f0_median_radius = f0_median_radius
        self.keyshift = keyshift
        self.phase_vocoder = phase_vocoder
        if contentvec_cfg is None:
            contentvec_cfg = (
                ContentVecConfig.v1() if version is RvcModelVersion.V1 else ContentVecConfig.v2()
            )
        self.contentvec_cfg = contentvec_cfg
        self.rmvpe_cfg = rmvpe_cfg if rmvpe_cfg is not None else RMVPEConfig()
        if synth_cfg is None:
            synth_cfg = SynthesizerConfig.for_sample_rate(
                cfg.model_sample_rate if not cfg.skip_inference else 40000,
                feature_dim=contentvec_cfg.out_dim,
            )
        self.synth_cfg = synth_cfg

        # the passthrough geometry (skip_inference) runs no network, so it builds none
        self.contentvec = self.rmvpe = self.synthesizer = None
        if not cfg.skip_inference:
            self.contentvec = ContentVec(self.contentvec_cfg).to(self.device, compute_dtype).eval()
            self.rmvpe = RMVPE(self.rmvpe_cfg).to(self.device, compute_dtype).eval()
            self.synthesizer = Synthesizer(self.synth_cfg).to(self.device, compute_dtype).eval()
        self.mel = MelSpectrogram(device=self.device)
        self._set_geometry(cfg)

    def _set_geometry(self, cfg: ChunkConfig) -> None:
        """Everything that follows from the chunk geometry; raises
        ``ValueError`` on one the step cannot run."""
        cfg.validate()
        t50 = feature_frames(cfg.input_buffer_16k_size)
        feature_frames_100hz = 2 * t50 + 1
        if cfg.skip_head + cfg.return_length > feature_frames_100hz:
            raise ValueError(f"skip_head + return_length ({cfg.skip_head}+{cfg.return_length}) exceeds "
                             f"the {feature_frames_100hz} feature frames of the input")
        self.cfg = cfg
        self.feature_frames_100hz = feature_frames_100hz
        self.hubert_length = min(cfg.input_buffer_16k_size // ZC_16K, feature_frames_100hz)
        self._fade_in, self._fade_out = fade_windows(cfg.sola_buffer_frame_size, device=self.device)
        #: this geometry's graphs by name, made at first use
        self._graphs: dict[str, object] = {}
        self._graphs_lock = threading.Lock()

    def with_config(self, cfg: ChunkConfig) -> "RvcPipeline":
        """This pipeline at another geometry: the same options, compute dtype
        and ``nn.Module`` objects (no networks are built or re-initialised),
        a geometry and graphs of its own."""
        other = copy.copy(self)
        other._set_geometry(cfg)
        return other

    def fingerprint(self) -> str:
        """Every constructor input that shapes the step's graphs: the
        ``semantic_key`` base for :func:`obs_rvc_tpu_torch.utils.exec_cache.cached_capture`
        (a copy of the JAX ``RvcPipeline.fingerprint`` with the port's options,
        plus the compute dtype and the device). Callers append a call-site
        label (``"|jit_step"``, ``"|engine_infer"``)."""
        return "|".join([
            repr(self.cfg),
            str(self.version),
            f"median={self.f0_median_radius}",
            "retrieval=none",
            f"keyshift={self.keyshift}",
            f"pvoc={self.phase_vocoder}",
            "pitch=rmvpe",
            repr(self.contentvec_cfg),
            repr(self.rmvpe_cfg),
            repr(self.synth_cfg),
            f"dtype={self.compute_dtype}",
            f"device={self.device}",
        ])

    def modules(self) -> dict[str, nn.Module]:
        """The networks by name (none for the passthrough geometry)."""
        if self.contentvec is None:
            return {}
        return {"contentvec": self.contentvec, "rmvpe": self.rmvpe, "synthesizer": self.synthesizer}

    def init_params(self, seed: int = 0, std: Optional[float] = 0.02) -> None:
        """Random weights from a numpy seed, drawn by the rule of the JAX
        package's ``init_params_fast`` (weights ``0.02 * N(0, 1)``); with
        ``std=None`` the weights are fan-in scaled. A bfloat16 pipeline gets the
        float32 draws rounded, so both dtypes share a seed's weights. For tests
        and benchmarks."""
        host = np.random.default_rng(seed)
        for module in self.modules().values():
            load_state_dict(module, _random_state_dict(module, host, std))

    def new_state(self) -> StreamState:
        return StreamState.init(self.cfg, device=self.device)

    # ------------------------------------------------------------------
    # stages
    # ------------------------------------------------------------------

    def stage_pre(self, state: StreamState, chunk: torch.Tensor):
        """Ring slides and the 48k→16k resample: returns ``(buf, buf16)``."""
        cfg = self.cfg
        buf = torch.cat([state.input_buffer[cfg.sample_frame_size :], chunk])
        res16 = resample_poly(buf[-cfg.downsample_window :], cfg.sample_rate, 16000)
        keep = cfg.downsample_keep_16k
        kept = state.input_buffer_16k[
            cfg.sample_frame_16k_size : cfg.input_buffer_16k_size - (keep - cfg.sample_frame_16k_size)
        ]
        return buf, torch.cat([kept, res16[-keep:]])

    def stage_features(self, buf16: torch.Tensor) -> torch.Tensor:
        """ContentVec features at 100 Hz, sliced to the returned frames ``[1, T, C]``."""
        cfg = self.cfg
        feats = extract_feature(self.contentvec(buf16[None, :]))
        return feats[:, cfg.skip_head : cfg.skip_head + cfg.return_length]

    def stage_mel(self, buf16: torch.Tensor) -> torch.Tensor:
        """Log-mel of the pitch window, ``[128, T]``."""
        return self.mel(buf16[-self.cfg.rmvpe_frame_16k :], keyshift=self.keyshift)

    def stage_salience(self, mel: torch.Tensor) -> torch.Tensor:
        """RMVPE salience ``[T, 360]``."""
        return self.rmvpe(mel[None])[0]

    def stage_pitch_post(self, cache: torch.Tensor, salience: torch.Tensor, controls: StepControls):
        """Decode, shift, filter, slide the cache and slice the chunk's track:
        returns ``(cache, pitch codes [T], pitchf [T])``."""
        cfg = self.cfg
        f0 = apply_pitch_shift(decode_f0(salience, threshold=0.03), controls.pitch_shift)
        if self.f0_median_radius >= 3:
            f0 = median_filter_f0(f0, self.f0_median_radius)
        cache = slide_pitch_cache(cache, f0, cfg.sample_frame_16k_size // RMVPE_HOP)
        start = cfg.pitch_cache_len - self.hubert_length + cfg.skip_head
        pitch, pitchf = get_f0_post(cache[start : start + cfg.return_length])
        return cache, pitch, pitchf

    def stage_synth(self, phone, pitch, pitchf, sid, rnd=None) -> torch.Tensor:
        """Synthesizer audio at the model rate, ``[model_return_size]``; ``sid``
        an int or a 0-d int64 tensor."""
        sid = torch.as_tensor(sid, dtype=torch.long, device=self.device).reshape(1)
        audio = self.synthesizer(phone, pitch[None, :], pitchf[None, :], sid,
                                 rnd[None] if rnd is not None else None)
        return audio[0]

    def stage_post(self, buf, model_out, sola_buffer, rms_mix_rate):
        """Resample to the device rate, mix the envelope, align and crossfade:
        returns ``(emitted, next sola_buffer)``."""
        cfg = self.cfg
        out = resample_poly(model_out, cfg.model_sample_rate, cfg.sample_rate)
        out = envelope_mixing(buf[cfg.extra_frame_size :], out, cfg.sample_rate, rms_mix_rate)
        offset = sola_offset(out, sola_buffer, cfg.sola_buffer_frame_size, cfg.sola_search_frame_size)
        return sola_crossfade(out, sola_buffer, offset, self._fade_in, self._fade_out,
                              cfg.sample_frame_size, phase_vocoder=self.phase_vocoder)

    # ------------------------------------------------------------------
    # the step
    # ------------------------------------------------------------------

    @torch.no_grad()
    def step(
        self,
        state: StreamState,
        chunk: torch.Tensor,
        controls: StepControls,
        rnd: Optional[torch.Tensor] = None,
        stage_times: Optional[dict] = None,
    ) -> tuple[StreamState, torch.Tensor]:
        """One chunk ``[sample_frame_size]`` → ``(new state, emitted audio)``,
        eagerly. ``rnd`` is the ``[T, 192]`` prior noise (zeros when None).
        With ``stage_times`` (a dict), each stage ends in a device synchronize
        and its wall ms is written under its name: diagnostics, not
        throughput."""
        return self._run_step(state, chunk.to(self.device, torch.float32), controls.on(self.device), rnd,
                              self._stage_runner(stage_times))

    def _run_step(self, state, chunk, controls, rnd, run):
        cfg = self.cfg
        buf, buf16 = run("pre", self.stage_pre, state, chunk)
        if cfg.skip_inference:
            model_out, new_cache = buf16[-cfg.model_return_size :], state.cache_pitchf
        else:
            model_out, new_cache = self._infer(state.cache_pitchf, buf16, controls, rnd, run)
        emitted, new_sola = run("post", self.stage_post, buf, model_out, state.sola_buffer,
                                controls.rms_mix_rate)
        return StreamState(buf, buf16, new_sola, new_cache), emitted

    def _stage_runner(self, stage_times: Optional[dict]):
        """``run(name, fn, *args)``: calls ``fn``; with ``stage_times``, also
        synchronizes the device and records the stage's wall ms."""
        if stage_times is None:
            return _untimed

        def run(name, fn, *args):
            t0 = time.perf_counter()
            out = fn(*args)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            stage_times[name] = (time.perf_counter() - t0) * 1e3
            return out

        return run

    def _graph(self, name: str, make):
        with self._graphs_lock:
            graph = self._graphs.get(name)
            if graph is None:
                graph = self._graphs[name] = make()
            return graph

    @property
    def jit_step(self) -> "GraphedStep":
        """``(state, chunk, controls) → (state, emitted)`` by one CUDA graph of
        the whole step, captured at its first call (or :meth:`GraphedStep.capture`)."""
        return self._graph("jit_step", lambda: GraphedStep(self))

    @property
    def staged_graphs(self) -> "StagedGraphs":
        """The graphs of :meth:`staged_step`, one per stage."""
        return self._graph("staged", lambda: StagedGraphs(self))

    @torch.no_grad()
    def staged_step(self, state: StreamState, chunk: torch.Tensor, controls: StepControls,
                    stage_times: Optional[dict] = None) -> tuple[StreamState, torch.Tensor]:
        """The step as one CUDA graph per stage (``pre`` … ``post``), each
        captured at its first call and replayed in turn, the counterpart of
        the JAX ``staged_step``. The state is donated, as in ``jit_step``.
        With ``stage_times``, each replay ends in a synchronize and its wall
        ms is written under the stage's name."""
        return self.staged_graphs(state, chunk, controls, stage_times)

    @property
    def jit_infer(self) -> GraphedFunction:
        """``(cache, buf16, controls) → (model-rate audio, new f0 cache)`` by one
        CUDA graph of :meth:`_infer` at this geometry: the engine's step."""
        def make():
            cfg = self.cfg
            example = (torch.zeros(cfg.pitch_cache_len), torch.zeros(cfg.input_buffer_16k_size),
                       StepControls.default())
            return GraphedFunction(self._infer, example, device=self.device, name="engine_infer",
                                   weights=self._weight_modules)
        return self._graph("jit_infer", make)

    def _weight_modules(self):
        return self.modules().values()

    def _infer(self, cache, buf16, controls, rnd=None, run=None):
        """The networks' part of the step: ``(model-rate audio, new f0 cache)``."""
        run = run or _untimed
        phone = run("features", self.stage_features, buf16)
        mel = run("mel", self.stage_mel, buf16)
        salience = run("salience", self.stage_salience, mel)
        new_cache, pitch, pitchf = run("pitch_post", self.stage_pitch_post, cache, salience, controls)
        return run("synth", self.stage_synth, phone, pitch, pitchf, controls.sid, rnd), new_cache

    def _pitch_cache_update(self, cache, buf16, controls):
        return self.stage_pitch_post(cache, self.stage_salience(self.stage_mel(buf16)), controls)

    @torch.no_grad()
    def convert_offline(self, wav: torch.Tensor, controls: Optional[StepControls] = None) -> torch.Tensor:
        """Convert a whole utterance chunk by chunk through :attr:`jit_step`;
        returns device-rate audio of the same length, rounded down to whole
        chunks."""
        cfg = self.cfg
        controls = controls if controls is not None else StepControls.default()
        wav = wav.to(self.device, torch.float32)
        state = self.new_state()
        outs = []
        for i in range(wav.shape[0] // cfg.sample_frame_size):
            state, out = self.jit_step(state, wav[i * cfg.sample_frame_size : (i + 1) * cfg.sample_frame_size],
                                       controls)
            outs.append(out)
        return torch.cat(outs) if outs else torch.zeros(0, device=self.device)


def _write_state(dst: StreamState, src: StreamState) -> None:
    for f in dataclasses.fields(StreamState):
        getattr(dst, f.name).copy_(getattr(src, f.name))


class GraphedStep:
    """:attr:`RvcPipeline.jit_step`: the whole step as one CUDA graph. Its
    static state is written in place inside the graph, and after the replay
    copied into the caller's state tensors, which the call returns (the
    counterpart of ``donate_argnums=(1,)``: the caller's old state is
    consumed). Host work per call: copy in, replay, copy out, under a lock,
    so sessions on several threads may share it."""

    def __init__(self, pipe: RvcPipeline):
        self._pipe = weakref.ref(pipe)  # the pipeline owns this graph: no cycle back to it
        cfg = pipe.cfg
        example = (StreamState.init(cfg, device=pipe.device), torch.zeros(cfg.sample_frame_size),
                   StepControls.default())
        self.graph = GraphedFunction(self._step, example, device=pipe.device, name="jit_step",
                                     weights=pipe._weight_modules)
        self.weights = self.graph.weights

    def _step(self, state, chunk, controls):
        new, emitted = self._pipe()._run_step(state, chunk, controls, None, _untimed)
        _write_state(state, new)
        return emitted

    def capture(self) -> bool:
        return self.graph.capture()

    @property
    def captures(self) -> int:
        return self.graph.captures

    def __call__(self, state: StreamState, chunk: torch.Tensor,
                 controls: StepControls) -> tuple[StreamState, torch.Tensor]:
        with self.graph.lock:
            emitted = self.graph.run(state, chunk, controls)
            _write_state(state, self.graph.static_args[0])
            return state, emitted.clone()


class StagedGraphs:
    """:meth:`RvcPipeline.staged_step`'s graphs, one per stage, in one memory
    pool (they replay in the order they were captured, under one lock).
    When the weights changed, every stage is captured again."""

    def __init__(self, pipe: RvcPipeline):
        self._pipe = weakref.ref(pipe)  # the pipeline owns these graphs: no cycle back to it
        self.graphs: dict[str, GraphedFunction] = {}
        self.lock = threading.RLock()
        self._pool = None  # made with the first graphs
        self._version = WeightsVersion(pipe._weight_modules)
        self._weights_key = None
        self._dropped_captures = 0

    @property
    def captures(self) -> int:
        """Captures of every stage so far, dropped graphs included."""
        return self._dropped_captures + sum(g.captures for g in self.graphs.values())

    def capture(self) -> bool:
        """Capture every stage now, by a step of silence on a scratch state,
        unless graphs of the current weights are held (or this runs on the
        CPU). Returns whether it captured."""
        pipe = self._pipe()
        with self.lock:
            if pipe.device.type != "cuda":
                return False
            self._drop_if_weights_changed()
            if self.graphs:
                return False
            self(StreamState.init(pipe.cfg, device=pipe.device), torch.zeros(pipe.cfg.sample_frame_size),
                 StepControls.default())
            return True

    def _drop_if_weights_changed(self) -> None:
        key = self._version.key()
        if key != self._weights_key:
            self._dropped_captures += sum(g.captures for g in self.graphs.values())
            self.graphs.clear()
            # a pool whose graphs are all gone is released by the allocator: new graphs take a new one
            self._pool = graph_pool(self._pipe().device)
            self._weights_key = key

    def __call__(self, state, chunk, controls, stage_times=None):
        pipe = self._pipe()
        with self.lock:
            if pipe.device.type == "cuda":
                self._drop_if_weights_changed()
            run = stage_runner(self.graphs, pipe.device, self._pool, stage_times)
            new, emitted = pipe._run_step(state, chunk, controls, None, run)
            _write_state(state, new)
            return state, emitted.clone()
