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
and compare the stages one by one.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.nn as nn

from obs_rvc_tpu_torch.config import ChunkConfig, RMVPE_HOP, ZC_16K, RvcModelVersion
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


def resolve_device(device) -> torch.device:
    """``None`` means the card; with no card that is an error, never a silent
    move to the CPU (pass ``device="cpu"`` for that)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass device='cpu' to run on the CPU")
        return torch.device("cuda")
    return torch.device(device)


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
    ):
        self.device = resolve_device(device)
        self.cfg = cfg
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

        self.contentvec = ContentVec(self.contentvec_cfg).to(self.device).eval()
        self.rmvpe = RMVPE(self.rmvpe_cfg).to(self.device).eval()
        self.synthesizer = Synthesizer(self.synth_cfg).to(self.device).eval()
        self.mel = MelSpectrogram(device=self.device)
        self._fade_in, self._fade_out = fade_windows(cfg.sola_buffer_frame_size, device=self.device)
        self._sid: dict[int, torch.Tensor] = {}

        t50 = feature_frames(cfg.input_buffer_16k_size)
        self.feature_frames_100hz = 2 * t50 + 1
        self.hubert_length = min(cfg.input_buffer_16k_size // ZC_16K, self.feature_frames_100hz)
        cfg.validate()
        assert cfg.skip_head + cfg.return_length <= self.feature_frames_100hz

    def modules(self) -> dict[str, nn.Module]:
        return {"contentvec": self.contentvec, "rmvpe": self.rmvpe, "synthesizer": self.synthesizer}

    def init_params(self, seed: int = 0, std: Optional[float] = 0.02) -> None:
        """Random weights from a numpy seed, drawn by the rule of the JAX
        package's ``init_params_fast`` (weights ``0.02 * N(0, 1)``); with
        ``std=None`` the weights are fan-in scaled. For tests and benchmarks."""
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

    def stage_synth(self, phone, pitch, pitchf, sid: int, rnd=None) -> torch.Tensor:
        """Synthesizer audio at the model rate, ``[model_return_size]``."""
        if sid not in self._sid:
            self._sid[sid] = torch.tensor([sid], dtype=torch.long, device=self.device)
        audio = self.synthesizer(phone, pitch[None, :], pitchf[None, :], self._sid[sid],
                                 rnd[None] if rnd is not None else None)
        return audio[0]

    def stage_post(self, buf, model_out, sola_buffer, rms_mix_rate: float):
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
    ) -> tuple[StreamState, torch.Tensor]:
        """One chunk ``[sample_frame_size]`` → ``(new state, emitted audio)``.
        ``rnd`` is the ``[T, 192]`` prior noise (zeros when None)."""
        cfg = self.cfg
        buf, buf16 = self.stage_pre(state, chunk.to(self.device, torch.float32))
        if cfg.skip_inference:
            model_out, new_cache = buf16[-cfg.model_return_size :], state.cache_pitchf
        else:
            model_out, new_cache = self._infer(state, buf16, controls, rnd)
        emitted, new_sola = self.stage_post(buf, model_out, state.sola_buffer, controls.rms_mix_rate)
        return StreamState(buf, buf16, new_sola, new_cache), emitted

    def _infer(self, state, buf16, controls, rnd):
        phone = self.stage_features(buf16)
        new_cache, pitch, pitchf = self._pitch_cache_update(state.cache_pitchf, buf16, controls)
        return self.stage_synth(phone, pitch, pitchf, controls.sid, rnd), new_cache

    def _pitch_cache_update(self, cache, buf16, controls):
        return self.stage_pitch_post(cache, self.stage_salience(self.stage_mel(buf16)), controls)

    @torch.no_grad()
    def convert_offline(self, wav: torch.Tensor, controls: Optional[StepControls] = None) -> torch.Tensor:
        """Convert a whole utterance chunk by chunk; returns device-rate audio
        of the same length, rounded down to whole chunks."""
        cfg = self.cfg
        controls = controls if controls is not None else StepControls.default()
        wav = wav.to(self.device, torch.float32)
        state = self.new_state()
        outs = []
        for i in range(wav.shape[0] // cfg.sample_frame_size):
            state, out = self.step(state, wav[i * cfg.sample_frame_size : (i + 1) * cfg.sample_frame_size],
                                   controls)
            outs.append(out)
        return torch.cat(outs) if outs else torch.zeros(0, device=self.device)
