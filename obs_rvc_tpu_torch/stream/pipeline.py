"""The per-chunk conversion step and offline conversion (counterpart of
``obs_rvc_tpu/stream/pipeline.py``)::

    device-rate ring slide
    → 48k→16k resample into the 16 kHz ring
    → ContentVec features, 2x upsampled, skip_head/return_length slice
    → retrieval blend (with a ``retrieval_index``)
    → pitch frontend → salience → f0 → pitch shift → 1024-frame cache slide
      (RMVPE: HTK log-mel; CREPE: normalised 1024-sample frames; FCPE:
      Slaney log-mel; each on the same hop-160 frame grid)
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

Every stage is written once, over a leading stream axis ``[B, ...]`` (the
counterpart of what ``jax.vmap`` gives the JAX step): the state's tensors,
the chunk and the controls carry it, and the networks batch over it. One
stream's step is the B=1 case of the same code, its tensors viewed with a
stream axis of 1 at the step's entry and without it at its exit.

Three ways to run the step, the JAX package's names:

- ``step``: eagerly, each operator sent from Python; the CPU path, the
  stage-by-stage diagnostic and what the graphs are held against.
  ``step(..., batched=True)`` steps ``B`` streams at once.
- ``jit_step``: one CUDA graph of the whole step (``stream/graphs.py``),
  the state donated: the new state is written into the caller's tensors.
  ``jit_step_batch`` is the same for ``B`` streams, a graph per batch size.
- ``staged_step``: a CUDA graph per stage, replayed in turn
  (``batched=True``: the stage graphs at that batch size).

``jit_convert_scan`` converts a whole clip, chunked on the host, as one
CUDA graph of every chunk's step (a graph per chunk count).

**A mesh row split along ``model``** (``parallel.shard_params`` with more
than one model entry: ContentVec split over the row's devices, an exact
retrieval table split by rows) is :attr:`RvcPipeline.segmented`. Its
features stage runs as per-device segments (``features/embed``, each
layer's shard attentions, their sum, its shard FFNs and their sum, the
head, each table shard's search and the merge with the blend), named
through the ``run(name, fn, *args, device=)`` calls that every form of the
step makes (``device.run_inline`` eagerly, a graph per name otherwise). On
such a row every graphed form is a ``stream/graphs.py:SegmentedFunction``,
and **fused** means the stages before the features as one graph (``pre``),
the features' segments, and the stages after them as one graph
(``after_features``: pitch, synthesizer, post; ``pitch_synth`` for
``jit_infer``); ``jit_convert_scan`` replays those for each chunk, and
``staged_step`` runs the features' segments in place of the features
graph. It is the same path whether the row's entries are distinct cards or
one card named several times, and the same arithmetic as the eager step.

The live controls reach every path as float32 tensors (the speaker id
int64), 0-d for one stream and ``[B]`` for a batch (:meth:`StepControls.stack`),
so they are graph inputs: a new pitch shift or mix rate is written before
a replay and never recaptures. ``fingerprint()`` names what shapes a
graph, for ``utils/exec_cache.cached_capture``.

``compute_dtype`` is the networks' dtype (float32, or bfloat16 as the JAX
server serves): they are built in it and compute in it, and return float32.
The rings, the 16 kHz buffer, the log-mel, the pitch track and cache,
resampling, envelope mixing and SOLA stay float32, as in the JAX step.

``pitch_algorithm`` picks the pitch network, as the JAX pipeline's does:
``"rmvpe"``, or upstream RVC's ``"crepe"`` (torchcrepe) or ``"fcpe"``
(torchfcpe). Only that network is built; ``modules()`` names it, so the
graphs' weights check, ``init_params`` and ``cast_params_for_serving``
follow it.

``retrieval_index`` (a :class:`~obs_rvc_tpu_torch.retrieval.RetrievalIndex`)
blends each stream's features with its nearest table rows at the stream's
``index_rate``, right after the feature slice, in every form of the step.
``modules()`` leaves it out (nothing randomises or casts the table); the
graphs watch it beside the networks, so loading another table recaptures
them.
"""

from __future__ import annotations

import collections
import copy
import dataclasses
import threading
import time
import weakref
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn as nn

from obs_rvc_tpu_torch.config import ChunkConfig, RMVPE_HOP, ZC_16K, RvcModelVersion
from obs_rvc_tpu_torch.device import deterministic_cudnn, resolve_device, run_inline
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
    Crepe,
    CrepeConfig,
    Fcpe,
    FcpeConfig,
    RMVPE,
    RMVPEConfig,
    Synthesizer,
    SynthesizerConfig,
    decode_f0_fcpe,
    extract_crepe_frames,
)
from obs_rvc_tpu_torch.models.contentvec import extract_feature, feature_frames
from obs_rvc_tpu_torch.models.layers import VitsLayerNorm
from obs_rvc_tpu_torch.models.weights import load_state_dict
from obs_rvc_tpu_torch.retrieval.index import RetrievalIndex
from obs_rvc_tpu_torch.stream.graphs import (
    GraphedFunction,
    SegmentedFunction,
    WeightsVersion,
    stage_runner,
)
from obs_rvc_tpu_torch.stream.state import StreamState


def slide_pitch_cache(cache: torch.Tensor, f0: torch.Tensor, shift: int) -> torch.Tensor:
    """Slide the f0 cache left by ``shift`` frames and write the chunk's pitch
    track ``f0[3 : len-1]`` at offset ``len(cache) + 4 - len(f0)``, over the
    last axis (leading axes are streams). The slide keeps ``copy_within``
    semantics: the vacated tail holds stale values until overwritten."""
    pitch_len = f0.shape[-1]
    cache = torch.cat([cache[..., shift:], cache[..., -shift:]], dim=-1)
    cache[..., cache.shape[-1] + 4 - pitch_len :] = f0[..., 3 : pitch_len - 1]
    return cache


@dataclasses.dataclass(frozen=True)
class StepControls:
    """Live per-chunk controls."""

    pitch_shift: float = 0.0  # semitones
    rms_mix_rate: float = 1.0  # 0..1, 1 = no envelope mixing
    index_rate: float = 0.0  # retrieval blend, 0..1 (read only with a retrieval index)
    sid: int = 0  # speaker id

    @staticmethod
    def default(pitch_shift: float = 0.0, rms_mix_rate: float = 1.0, index_rate: float = 0.0,
                sid: int = 0) -> "StepControls":
        return StepControls(float(pitch_shift), float(rms_mix_rate), float(index_rate), int(sid))

    def on(self, device) -> "StepControls":
        """The controls as 0-d tensors on ``device``, float32 and the speaker
        id int64, as the graphs hold them: every path then does the same
        float32 arithmetic on them. Filled on the device, no host copy.
        Leaves that are tensors already are kept as they are."""
        def full(v, dtype):
            return v.to(device) if isinstance(v, torch.Tensor) else torch.full((), v, dtype=dtype, device=device)

        return StepControls(full(self.pitch_shift, torch.float32), full(self.rms_mix_rate, torch.float32),
                            full(self.index_rate, torch.float32), full(self.sid, torch.long))

    @staticmethod
    def stack(controls: Sequence["StepControls"], device) -> "StepControls":
        """The controls of ``B`` streams as one ``StepControls`` whose leaves
        are ``[B]`` tensors on ``device`` (float32, the speaker id int64): the
        batched step's form."""
        def col(name, dtype):
            cast = int if dtype == torch.long else float
            return torch.tensor([cast(getattr(c, name)) for c in controls], dtype=dtype, device=device)

        return StepControls(col("pitch_shift", torch.float32), col("rms_mix_rate", torch.float32),
                            col("index_rate", torch.float32), col("sid", torch.long))

    def map(self, fn) -> "StepControls":
        """``fn`` applied to each control."""
        return StepControls(*(fn(getattr(self, f.name)) for f in dataclasses.fields(self)))


_NORMS = (nn.LayerNorm, nn.GroupNorm, nn.BatchNorm1d, nn.BatchNorm2d, VitsLayerNorm)


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
    """Chunk geometry + the three networks (ContentVec, the pitch network,
    the synthesizer) + the per-chunk step, all on one device."""

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
        pitch_algorithm: str = "rmvpe",
        crepe_cfg: Optional[CrepeConfig] = None,
        fcpe_cfg: Optional[FcpeConfig] = None,
        retrieval_index: Optional[RetrievalIndex] = None,
    ):
        if compute_dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"compute_dtype must be float32 or bfloat16, not {compute_dtype}")
        if pitch_algorithm not in ("rmvpe", "crepe", "fcpe"):
            raise ValueError(f"unknown pitch_algorithm {pitch_algorithm!r}")
        if pitch_algorithm != "rmvpe" and keyshift:
            raise ValueError("resonance shift (mel keyshift) requires pitch_algorithm='rmvpe'")
        self.pitch_algorithm = pitch_algorithm
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            deterministic_cudnn()
        self.compute_dtype = compute_dtype
        self.version = version
        self.f0_median_radius = f0_median_radius
        self.keyshift = keyshift
        self.phase_vocoder = phase_vocoder
        self.retrieval_index = retrieval_index
        if contentvec_cfg is None:
            contentvec_cfg = (
                ContentVecConfig.v1() if version is RvcModelVersion.V1 else ContentVecConfig.v2()
            )
        self.contentvec_cfg = contentvec_cfg
        self.rmvpe_cfg = rmvpe_cfg if rmvpe_cfg is not None else RMVPEConfig()
        self.crepe_cfg = crepe_cfg if crepe_cfg is not None else CrepeConfig()
        self.fcpe_cfg = fcpe_cfg if fcpe_cfg is not None else FcpeConfig()
        if synth_cfg is None:
            synth_cfg = SynthesizerConfig.for_sample_rate(
                cfg.model_sample_rate if not cfg.skip_inference else 40000,
                feature_dim=contentvec_cfg.out_dim,
            )
        self.synth_cfg = synth_cfg

        # the passthrough geometry (skip_inference) runs no network, so it builds none;
        # of the pitch networks, only the chosen one is built
        self.contentvec = self.rmvpe = self.crepe = self.fcpe = self.synthesizer = None
        if not cfg.skip_inference:
            self.contentvec = ContentVec(self.contentvec_cfg).to(self.device, compute_dtype).eval()
            pitch = {"rmvpe": RMVPE, "crepe": Crepe, "fcpe": Fcpe}[pitch_algorithm]
            setattr(self, pitch_algorithm,
                    pitch(getattr(self, f"{pitch_algorithm}_cfg")).to(self.device, compute_dtype).eval())
            self.synthesizer = Synthesizer(self.synth_cfg).to(self.device, compute_dtype).eval()
        self.mel = MelSpectrogram(device=self.device)
        if pitch_algorithm == "fcpe":
            # torchfcpe's mel: the Slaney scale (librosa's default), fmin 0
            self.fcpe_mel = MelSpectrogram(f_min=0.0, htk=False, device=self.device)
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
        #: its pipelines by data row on each mesh ``parallel.shard_params`` gave it, and the weights they hold
        self._mesh_rows: dict = {}

    def with_config(self, cfg: ChunkConfig) -> "RvcPipeline":
        """This pipeline at another geometry: the same options, compute dtype
        and ``nn.Module`` objects (no networks are built or re-initialised),
        a geometry and graphs of its own. The retrieval index is shared too."""
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
            f"retrieval={'none' if self.retrieval_index is None else self.retrieval_index.describe()}",
            f"keyshift={self.keyshift}",
            f"pvoc={self.phase_vocoder}",
            f"pitch={self.pitch_algorithm}",
            repr(self.contentvec_cfg),
            repr(self.rmvpe_cfg),
            repr(self.synth_cfg),
            repr(self.crepe_cfg),
            repr(self.fcpe_cfg),
            f"dtype={self.compute_dtype}",
            f"device={self.device}",
        ])

    @property
    def segmented(self) -> bool:
        """Whether the features stage runs as per-device segments: ContentVec
        split along a mesh row's ``model`` entries (``parallel.shard_params``)."""
        return hasattr(self.contentvec, "model_devices")

    def modules(self) -> dict[str, nn.Module]:
        """The networks by name: ``"contentvec"``, the pitch network under its
        algorithm's name, ``"synthesizer"`` (none for the passthrough geometry)."""
        if self.contentvec is None:
            return {}
        return {"contentvec": self.contentvec, self.pitch_algorithm: getattr(self, self.pitch_algorithm),
                "synthesizer": self.synthesizer}

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
    # stages, each over B streams
    # ------------------------------------------------------------------

    def stage_pre(self, state: StreamState, chunk: torch.Tensor):
        """Ring slides and the 48k→16k resample of ``[B, ...]`` state and an
        ``[B, sample_frame_size]`` chunk: returns ``(buf, buf16)``."""
        cfg = self.cfg
        buf = torch.cat([state.input_buffer[:, cfg.sample_frame_size :], chunk], dim=1)
        res16 = resample_poly(buf[:, -cfg.downsample_window :], cfg.sample_rate, 16000)
        keep = cfg.downsample_keep_16k
        kept = state.input_buffer_16k[
            :, cfg.sample_frame_16k_size : cfg.input_buffer_16k_size - (keep - cfg.sample_frame_16k_size)
        ]
        return buf, torch.cat([kept, res16[:, -keep:]], dim=1)

    def stage_features(self, buf16: torch.Tensor, index_rate=None) -> torch.Tensor:
        """ContentVec features at 100 Hz, sliced to the returned frames ``[B, T, C]``
        and, with a retrieval index, blended at each stream's ``index_rate`` (``[B]``)."""
        phone = self._slice_features(self.contentvec(buf16))
        if self.retrieval_index is not None:
            phone = self.retrieval_index.blend(phone, index_rate)
        return phone

    def _slice_features(self, feats: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        return extract_feature(feats)[:, cfg.skip_head : cfg.skip_head + cfg.return_length]

    def _features_head(self, x: torch.Tensor, index_rate) -> torch.Tensor:
        """A segmented row's last features segment on its first device: the
        tapped layer's output to the sliced features, blended by an index
        that is not split (a split one searches in segments of its own)."""
        phone = self._slice_features(self.contentvec.head(x))
        index = self.retrieval_index
        if index is not None and index.shards is None:
            phone = index.blend(phone, index_rate)
        return phone

    def _features(self, buf16: torch.Tensor, index_rate, run):
        """The features stage through ``run``: one piece, or on a
        :attr:`segmented` row its segments (see the module docstring); None
        for the passthrough geometry."""
        if self.contentvec is None:
            return None
        if not self.segmented:
            return run("features", self.stage_features, buf16, index_rate)

        def seg(name, fn, *args, device=self.device):
            return run(f"features/{name}", fn, *args, device=device)

        x = seg("embed", self.contentvec.embed, buf16)
        for i, layer in enumerate(self.contentvec.tapped_layers()):
            x = layer(x, seg, f"layer{i}")
        phone = seg("head", self._features_head, x, index_rate)
        index = self.retrieval_index
        if index is not None and index.shards is not None:
            phone = index.blend(phone, index_rate, seg)
        return phone

    def stage_mel(self, buf16: torch.Tensor) -> torch.Tensor:
        """The pitch frontend of the pitch window (the stage keeps the JAX
        staged step's name, "mel"): RMVPE's log-mel ``[B, 128, T]`` (one
        log-mel kernel launch for every stream), CREPE's normalised frames
        ``[B, T, 1024]`` or FCPE's Slaney log-mel ``[B, T, 128]``."""
        window = buf16[:, -self.cfg.rmvpe_frame_16k :]
        if self.pitch_algorithm == "crepe":
            return extract_crepe_frames(window, self.cfg.rmvpe_n_frames)
        if self.pitch_algorithm == "fcpe":
            return self.fcpe_mel(window).transpose(1, 2)
        return self.mel(window, keyshift=self.keyshift)

    def stage_salience(self, feat: torch.Tensor) -> torch.Tensor:
        """The pitch network's salience ``[B, T, 360]``; CREPE runs every
        stream's frames as one batch of ``B·T``."""
        if self.pitch_algorithm == "crepe":
            return self.crepe(feat.flatten(0, 1)).unflatten(0, feat.shape[:2])
        return getattr(self, self.pitch_algorithm)(feat)

    def stage_pitch_post(self, cache: torch.Tensor, salience: torch.Tensor, controls: StepControls):
        """Decode (FCPE by its own grid, RMVPE and CREPE by theirs), shift by
        each stream's pitch shift, filter, slide the cache and slice the
        chunk's track: returns ``(cache, pitch codes [B, T], pitchf [B, T])``."""
        cfg = self.cfg
        if self.pitch_algorithm == "fcpe":
            f0 = decode_f0_fcpe(salience, threshold=0.05)
        else:
            f0 = decode_f0(salience, threshold=0.03)
        f0 = apply_pitch_shift(f0, controls.pitch_shift)
        if self.f0_median_radius >= 3:
            f0 = median_filter_f0(f0, self.f0_median_radius)
        cache = slide_pitch_cache(cache, f0, cfg.sample_frame_16k_size // RMVPE_HOP)
        start = cfg.pitch_cache_len - self.hubert_length + cfg.skip_head
        pitch, pitchf = get_f0_post(cache[:, start : start + cfg.return_length])
        return cache, pitch, pitchf

    def stage_synth(self, phone, pitch, pitchf, sid, rnd=None) -> torch.Tensor:
        """Synthesizer audio at the model rate, ``[B, model_return_size]``;
        ``sid`` the ``[B]`` int64 speaker ids, ``rnd`` ``[B, T, 192]`` or None."""
        return self.synthesizer(phone, pitch, pitchf, sid, rnd)

    def stage_post(self, buf, model_out, sola_buffer, rms_mix_rate):
        """Resample to the device rate, mix the envelope (``rms_mix_rate``
        ``[B]``), align and crossfade each stream: returns ``(emitted, next
        sola_buffer)``."""
        cfg = self.cfg
        out = resample_poly(model_out, cfg.model_sample_rate, cfg.sample_rate)
        out = envelope_mixing(buf[:, cfg.extra_frame_size :], out, cfg.sample_rate, rms_mix_rate)
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
        batched: bool = False,
    ) -> tuple[StreamState, torch.Tensor]:
        """One chunk ``[sample_frame_size]`` → ``(new state, emitted audio)``,
        eagerly. ``rnd`` is the ``[T, 192]`` prior noise (zeros when None).
        With ``batched``, ``B`` streams at once (the JAX ``jit_step_batch``'s
        function, eagerly): the state's tensors, the chunk ``[B,
        sample_frame_size]`` and ``rnd`` carry a leading stream axis, and each
        control is ``[B]`` (:meth:`StepControls.stack`) or one value for every
        stream. With ``stage_times`` (a dict), each stage ends in a device
        synchronize and its wall ms is written under its name: diagnostics,
        not throughput."""
        _check_rank(chunk, batched)
        return self._run_steps(state, chunk.to(self.device, torch.float32), controls, rnd,
                               self._stage_runner(stage_times))

    def _run_steps(self, state, chunk, controls, rnd, run, grouped=False):
        """The step of ``B`` streams (a chunk ``[B, N]``), or of one (``[N]``)
        as the B=1 case of the same code."""
        controls = controls.on(self.device)
        if chunk.dim() == 1:
            return _one_stream(lambda *a: self._run_step(*a, None if rnd is None else rnd[None], run, grouped),
                               state, chunk, controls)
        return self._run_step(state, chunk, _for_streams(controls, chunk.shape[0]), rnd, run, grouped)

    def _run_step(self, state, chunk, controls, rnd, run, grouped):
        """The step through ``run``: stage by stage, or ``grouped`` as a
        fused form's pieces (``pre``, the features, ``after_features``)."""
        buf, buf16 = run("pre", self.stage_pre, state, chunk)
        phone = self._features(buf16, controls.index_rate, run)
        if grouped:
            return run("after_features", self._after_features, state, buf, buf16, phone, controls, rnd)
        return self._after_features(state, buf, buf16, phone, controls, rnd, run)

    def _after_features(self, state, buf, buf16, phone, controls, rnd=None, run=run_inline):
        """The stages after the features: ``(new state, emitted audio)``."""
        cfg = self.cfg
        if cfg.skip_inference:
            model_out, new_cache = buf16[:, -cfg.model_return_size :], state.cache_pitchf
        else:
            model_out, new_cache = self._pitch_synth(state.cache_pitchf, buf16, phone, controls, rnd, run)
        emitted, new_sola = run("post", self.stage_post, buf, model_out, state.sola_buffer,
                                controls.rms_mix_rate)
        return StreamState(buf, buf16, new_sola, new_cache), emitted

    def _stage_runner(self, stage_times: Optional[dict]):
        """``run(name, fn, *args, device=None)``: :func:`run_inline`; with
        ``stage_times``, also synchronizes the device and records the
        stage's wall ms (a features segment's added to the stage's)."""
        if stage_times is None:
            return run_inline

        def run(name, fn, *args, device=None):
            t0 = time.perf_counter()
            out = run_inline(name, fn, *args, device=device)
            dev = self.device if device is None else torch.device(device)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            stage, _, segment = name.partition("/")
            stage_times[stage] = (stage_times.get(stage, 0.0) if segment else 0.0) + (time.perf_counter() - t0) * 1e3
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
        the whole step, captured at its first call (or :meth:`GraphedStep.capture`):
        the graph of :meth:`jit_step_batch` at one stream."""
        return self.batch_graph(1)

    def batch_graph(self, batch: int) -> "GraphedStep":
        """The graph :meth:`jit_step_batch` replays for ``batch`` streams."""
        return self._graph(f"jit_step_batch/{batch}", lambda: GraphedStep(self, batch))

    def jit_step_batch(self, state: StreamState, chunk: torch.Tensor,
                       controls: StepControls) -> tuple[StreamState, torch.Tensor]:
        """The batched step of ``B = len(chunk)`` streams by one CUDA graph (one
        per batch size, captured at its first call), the state donated as in
        :attr:`jit_step`; each control ``[B]``, or a number for every stream.
        The counterpart of the JAX ``jit_step_batch``."""
        _check_rank(chunk, True)
        return self.batch_graph(chunk.shape[0])(state, chunk, controls)

    @property
    def staged_graphs(self) -> "StagedGraphs":
        """The graphs of :meth:`staged_step`, one per stage: those of one stream."""
        return self.staged_batch_graphs(1)

    def staged_batch_graphs(self, batch: int) -> "StagedGraphs":
        """The graphs of ``staged_step(..., batched=True)`` at ``batch`` streams."""
        return self._graph(f"staged/{batch}", lambda: StagedGraphs(self, batch))

    @torch.no_grad()
    def staged_step(self, state: StreamState, chunk: torch.Tensor, controls: StepControls,
                    stage_times: Optional[dict] = None, batched: bool = False) -> tuple[StreamState, torch.Tensor]:
        """The step as one CUDA graph per stage (``pre`` … ``post``), each
        captured at its first call and replayed in turn, the counterpart of
        the JAX ``staged_step``; ``batched`` as in :meth:`step`, with the
        stage graphs of that batch size. The state is donated, as in
        ``jit_step``. With ``stage_times``, each replay ends in a synchronize
        and its wall ms is written under the stage's name."""
        _check_rank(chunk, batched)
        return self.staged_batch_graphs(chunk.shape[0] if batched else 1)(state, chunk, controls, stage_times)

    @property
    def jit_infer(self):
        """``(cache, buf16, controls) → (model-rate audio, new f0 cache)`` by one
        CUDA graph of one stream's :meth:`_infer` at this geometry: the engine's step."""
        def make():
            cfg = self.cfg
            example = (torch.zeros(cfg.pitch_cache_len), torch.zeros(cfg.input_buffer_16k_size),
                       StepControls.default())
            return self._graphed(self._infer_single, example, "engine_infer")
        return self._graph("jit_infer", make)

    def _graphed(self, fn, example: tuple, name: str):
        """The graphed form of ``fn(*args, run=...)`` on this pipeline's
        weights: one graph, or per-device segments on a :attr:`segmented` row."""
        cls = SegmentedFunction if self.segmented else GraphedFunction
        return cls(fn, example, device=self.device, name=name, weights=self._weight_modules)

    def _weight_modules(self):
        """What the graphs read besides their arguments: the networks and the retrieval index."""
        mods = list(self.modules().values())
        return mods if self.retrieval_index is None else mods + [self.retrieval_index]

    def _infer(self, cache, buf16, controls, rnd=None, run=run_inline, grouped=False):
        """The networks' part of the step of ``B`` streams: ``(model-rate
        audio, new f0 cache)``; ``grouped``, the stages after the features
        as one piece (``pitch_synth``)."""
        phone = self._features(buf16, controls.index_rate, run)
        if grouped:
            return run("pitch_synth", self._pitch_synth, cache, buf16, phone, controls, rnd)
        return self._pitch_synth(cache, buf16, phone, controls, rnd, run)

    def _pitch_synth(self, cache, buf16, phone, controls, rnd=None, run=run_inline):
        mel = run("mel", self.stage_mel, buf16)
        salience = run("salience", self.stage_salience, mel)
        new_cache, pitch, pitchf = run("pitch_post", self.stage_pitch_post, cache, salience, controls)
        return run("synth", self.stage_synth, phone, pitch, pitchf, controls.sid, rnd), new_cache

    def _infer_single(self, cache, buf16, controls, run=run_inline):
        audio, new_cache = self._infer(cache[None], buf16[None], _for_streams(controls.on(self.device), 1), run=run,
                                       grouped=True)
        return audio[0], new_cache[0]

    def _pitch_cache_update(self, cache, buf16, controls):
        """The pitch half of one stream's step: ``(cache, codes [T], pitchf [T])``."""
        sal = self.stage_salience(self.stage_mel(buf16[None]))
        out = self.stage_pitch_post(cache[None], sal, _for_streams(controls.on(self.device), 1))
        return tuple(t[0] for t in out)

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

    @torch.no_grad()
    def jit_convert_scan(self, wav_chunks: torch.Tensor, controls: Optional[StepControls] = None) -> torch.Tensor:
        """Whole-clip conversion, ``[n_chunks, sample_frame_size]`` (chunked on
        the host) → ``[n_chunks * sample_frame_size]`` from a zeroed state, as
        one CUDA graph of every chunk's step: one replay a clip, the
        counterpart of the JAX ``jit_convert_scan``'s ``lax.scan``. A graph is
        captured per chunk count at its first call; the last
        :data:`SCAN_GRAPHS` counts are kept."""
        n = wav_chunks.shape[0]
        with self._graphs_lock:
            held = self._graphs.setdefault("jit_convert_scan", collections.OrderedDict())
            graph = held.get(n)
            if graph is None:
                example = (torch.zeros(n, self.cfg.sample_frame_size), StepControls.default())
                graph = held[n] = self._graphed(self._convert_scan, example, f"jit_convert_scan[{n}]")
                while len(held) > SCAN_GRAPHS:
                    held.popitem(last=False)
            held.move_to_end(n)
        return graph(wav_chunks.to(self.device, torch.float32),
                     controls if controls is not None else StepControls.default())

    def _convert_scan(self, wav_chunks, controls, run=run_inline):
        """Every chunk's step from a zeroed state (on a :attr:`segmented` row
        the fused pieces once a chunk; each chunk's audio copied out of them)."""
        state = StreamState.init(self.cfg, device=self.device)
        outs = []
        for chunk in wav_chunks:
            state, out = self._run_steps(state, chunk, controls, None, run, grouped=True)
            outs.append(out.clone())
        return torch.cat(outs)


#: chunk counts whose :meth:`RvcPipeline.jit_convert_scan` graph a pipeline keeps
SCAN_GRAPHS = 4


def _for_streams(controls: StepControls, batch: int) -> StepControls:
    """Tensor controls as ``[batch]`` leaves: one value each, or one for all."""
    return controls.map(lambda t: t.reshape(-1).expand(batch))


def _one_stream(step, state: StreamState, chunk: torch.Tensor, controls: StepControls):
    """``step`` of ``B`` streams run on one stream's state and ``[N]`` chunk
    as the B=1 case: views of their tensors with a stream axis of 1 (a graph,
    which writes its state in place, writes the caller's), and views of the
    results without it. ``controls`` are on the step's device."""
    new, emitted = step(state.map(lambda t: t[None]), chunk[None], _for_streams(controls, 1))
    return new.map(lambda t: t[0]), emitted[0]


def _check_rank(chunk: torch.Tensor, batched: bool) -> None:
    if chunk.dim() != 1 + batched:
        raise ValueError(f"a {'batched ' if batched else ''}step takes a chunk of "
                         f"{'[B, N]' if batched else '[N]'}, not {tuple(chunk.shape)}")


def _write_state(dst: StreamState, src: StreamState) -> None:
    for f in dataclasses.fields(StreamState):
        getattr(dst, f.name).copy_(getattr(src, f.name))


class GraphedStep:
    """The graph of :meth:`RvcPipeline.jit_step_batch` at ``batch`` streams:
    the whole step as one CUDA graph, or on a :attr:`~RvcPipeline.segmented`
    row its fused pieces (:attr:`RvcPipeline.jit_step` is the one at one
    stream, called with one stream's state and an ``[N]`` chunk). The new
    state the graph returns is copied into the caller's state tensors, which
    the call returns (the counterpart of ``donate_argnums=(1,)``: the
    caller's old state is consumed). Host work per call: copy in, replay,
    copy out, under a lock, so sessions on several threads may share it."""

    def __init__(self, pipe: RvcPipeline, batch: int):
        self._pipe = weakref.ref(pipe)  # the pipeline owns this graph: no cycle back to it
        self.batch = batch
        self.graph = pipe._graphed(self._step, _example(pipe, batch), f"jit_step_batch[{batch}]")
        self.weights = self.graph.weights

    def _step(self, state, chunk, controls, run=run_inline):
        return self._pipe()._run_steps(state, chunk, controls, None, run, grouped=True)

    def capture(self) -> bool:
        return self.graph.capture()

    @property
    def captures(self) -> int:
        return self.graph.captures

    def __call__(self, state: StreamState, chunk: torch.Tensor,
                 controls: StepControls) -> tuple[StreamState, torch.Tensor]:
        if chunk.dim() == 1:  # written into the views of the caller's tensors: its state is the new one
            return state, _one_stream(self, state, chunk, controls.on(self.graph.device))[1]
        with self.graph.lock:
            new, emitted = self.graph.run(state, chunk, controls)
            _write_state(state, new)
            return state, emitted.clone()


def _example(pipe: RvcPipeline, batch: int) -> tuple:
    """Arguments of the shapes a step of ``batch`` streams takes: a zeroed
    state, chunks of silence, default controls."""
    return (StreamState.init_batch(pipe.cfg, batch, device=pipe.device),
            torch.zeros(batch, pipe.cfg.sample_frame_size),
            StepControls.stack([StepControls.default()] * batch, pipe.device))


class StagedGraphs:
    """:meth:`RvcPipeline.staged_step`'s graphs, one per stage, at ``batch``
    streams (at one, called with one stream's state and an ``[N]`` chunk),
    in one memory pool (they replay in the order they were captured, under
    one lock; on a :attr:`~RvcPipeline.segmented` row the features' segments
    among them, in a pool per card). When the weights changed, every stage
    is captured again."""

    def __init__(self, pipe: RvcPipeline, batch: int):
        self._pipe = weakref.ref(pipe)  # the pipeline owns these graphs: no cycle back to it
        self.batch = batch
        self.graphs: dict[str, GraphedFunction] = {}
        self.lock = threading.RLock()
        self._pools: dict = {}  # a memory pool per card, made with the first graphs
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
            self(*_example(pipe, self.batch))
            return True

    def _drop_if_weights_changed(self) -> None:
        key = self._version.key()
        if key != self._weights_key:
            self._dropped_captures += sum(g.captures for g in self.graphs.values())
            self.graphs.clear()
            # a pool whose graphs are all gone is released by the allocator: new graphs take a new one
            self._pools = {}
            self._weights_key = key

    def __call__(self, state, chunk, controls, stage_times=None):
        pipe = self._pipe()
        if chunk.dim() == 1:  # as in GraphedStep
            return state, _one_stream(lambda *a: self(*a, stage_times), state, chunk, controls.on(pipe.device))[1]
        with self.lock:
            if pipe.device.type == "cuda":
                self._drop_if_weights_changed()
            run = stage_runner(self.graphs, pipe.device, self._pools, stage_times)
            new, emitted = pipe._run_steps(state, chunk, controls, None, run)
            _write_state(state, new)
            return state, emitted.clone()
