"""Static stream geometry and user-facing settings: the port's own copy of the
chunk-size algebra.

Same derivation as ``obs_rvc_tpu/config.py:ChunkConfig`` (the obs-rvc
plugin's frame-size math): every buffer size of the streaming step follows
from the device sample rate, the chunk, fade and context lengths and the
model's output rate. Kept as a frozen dataclass so a pipeline's geometry is
fixed at construction. :class:`StreamSettings` holds the plugin's settings
and derives a geometry from them; :meth:`ChunkConfig.for_request` derives
one from the numbers an RPC request carries.
"""

from __future__ import annotations

import dataclasses
import enum
import math
from typing import Optional


class RvcModelVersion(enum.Enum):
    """RVC model generation: v1 uses 256-dim features from layer 9, v2
    768-dim features from layer 12."""

    V1 = 1
    V2 = 2

    @property
    def text_encoder_in_channels(self) -> int:
        """Feature width fed to the synthesizer."""
        return 256 if self is RvcModelVersion.V1 else 768

    @property
    def output_layers(self) -> int:
        """ContentVec transformer layer tapped for the features: 9 for v1, 12 for v2."""
        return 9 if self is RvcModelVersion.V1 else 12

    @classmethod
    def from_str(cls, s: str) -> "RvcModelVersion":
        return {"v1": cls.V1, "v2": cls.V2}.get(s.lower(), cls.V2)

    def __str__(self) -> str:
        return "v1" if self is RvcModelVersion.V1 else "v2"


class PitchAlgorithm(enum.Enum):
    """Pitch extraction algorithm; unknown names and numbers map to RMVPE, as
    the plugin's own conversions do. The port runs RMVPE only so far."""

    RMVPE = 1
    CREPE = 2
    FCPE = 3

    @classmethod
    def from_str(cls, s: str) -> "PitchAlgorithm":
        return {"crepe": cls.CREPE, "fcpe": cls.FCPE}.get(s.lower(), cls.RMVPE)

    @classmethod
    def from_int(cls, i: int) -> "PitchAlgorithm":
        try:
            return cls(i)
        except ValueError:
            return cls.RMVPE

    def __str__(self) -> str:
        return self.name.lower()


#: 16 kHz samples per 10 ms block.
ZC_16K = 160

#: RMVPE analysis hop at 16 kHz.
RMVPE_HOP = 160


@dataclasses.dataclass(frozen=True)
class StreamSettings:
    """The plugin's user-facing settings, with its defaults."""

    model_path: Optional[str] = None
    index_path: Optional[str] = None
    model_version: RvcModelVersion = RvcModelVersion.V2
    pitch_algorithm: PitchAlgorithm = PitchAlgorithm.RMVPE
    #: synthesizer output sample rate, 16000..=48000
    dest_sample_rate: int = 40000
    #: semitones, -24..=24
    pitch_shift: int = 12
    #: formant/resonance shift in semitones, -5..=5 (the mel keyshift)
    resonance_shift: float = 0.0
    #: retrieval blend 0..=1
    index_rate: float = 0.0
    #: loudness factor / RMS mix rate 0..=1
    rms_mix_rate: float = 0.5
    #: chunk length in seconds, 0.01..=1.5
    sample_length: float = 0.30
    #: crossfade length in seconds, 0.01..=0.15
    fade_length: float = 0.07
    #: left context given to the models, seconds, 0..=5
    extra_inference_time: float = 2.00
    #: bypass the neural stages
    skip_inference: bool = False

    def chunk_config(self, sample_rate: int = 48000) -> "ChunkConfig":
        return ChunkConfig.build(
            sample_rate=sample_rate,
            model_sample_rate=self.dest_sample_rate,
            sample_length=self.sample_length,
            fade_length=self.fade_length,
            extra_inference_time=self.extra_inference_time,
            skip_inference=self.skip_inference,
            feature_dim=self.model_version.text_encoder_in_channels,
        )


@dataclasses.dataclass(frozen=True)
class ChunkConfig:
    """All static sizes of the streaming pipeline, in device-rate samples
    unless suffixed otherwise::

        zc                 = sample_rate / 100                  (10 ms)
        sample_frame_size  = round(sample_length*sr/zc) * zc
        crossfade_frame    = round(fade_length*sr/zc)   * zc
        sola_buffer_frame  = min(crossfade_frame, 4*zc)
        sola_search_frame  = zc
        extra_frame        = round(extra_time*sr/zc)    * zc
        input_buffer       = extra + crossfade + search + sample
        model_return_length= (sample + sola_buffer + search) / zc
        model_return_size  = model_return_length * model_sr/100
    """

    sample_rate: int
    model_sample_rate: int
    feature_dim: int
    skip_inference: bool

    zc: int
    sample_frame_size: int
    crossfade_frame_size: int
    sola_buffer_frame_size: int
    sola_search_frame_size: int
    extra_frame_size: int
    input_buffer_size: int
    model_return_length: int
    model_return_size: int

    sample_frame_16k_size: int
    input_buffer_16k_size: int

    @staticmethod
    def build(
        sample_rate: int = 48000,
        model_sample_rate: int = 40000,
        sample_length: float = 0.30,
        fade_length: float = 0.07,
        extra_inference_time: float = 2.00,
        skip_inference: bool = False,
        feature_dim: int = 768,
    ) -> "ChunkConfig":
        if sample_rate % 100 != 0:
            raise ValueError(f"sample_rate must be a multiple of 100, got {sample_rate}")
        zc = sample_rate // 100

        sample_frame_time = round(sample_length * sample_rate / zc)
        if sample_frame_time < 1:
            raise ValueError("sample_length too small for one 10 ms block")
        sample_frame_size = sample_frame_time * zc
        sample_frame_16k = sample_frame_time * ZC_16K

        crossfade_frame_size = round(fade_length * sample_rate / zc) * zc
        sola_buffer_frame_size = min(crossfade_frame_size, 4 * zc)
        sola_search_frame_size = zc
        extra_frame_size = round(extra_inference_time * sample_rate / zc) * zc

        input_buffer_size = (
            extra_frame_size + crossfade_frame_size + sola_search_frame_size + sample_frame_size
        )
        input_buffer_16k_size = ZC_16K * input_buffer_size // zc

        model_return_length = (
            sample_frame_size + sola_buffer_frame_size + sola_search_frame_size
        ) // zc
        model_sr = 16000 if skip_inference else model_sample_rate
        model_return_size = model_return_length * (model_sr // 100)

        return ChunkConfig(
            sample_rate=sample_rate,
            model_sample_rate=model_sr,
            feature_dim=feature_dim,
            skip_inference=skip_inference,
            zc=zc,
            sample_frame_size=sample_frame_size,
            crossfade_frame_size=crossfade_frame_size,
            sola_buffer_frame_size=sola_buffer_frame_size,
            sola_search_frame_size=sola_search_frame_size,
            extra_frame_size=extra_frame_size,
            input_buffer_size=input_buffer_size,
            model_return_length=model_return_length,
            model_return_size=model_return_size,
            sample_frame_16k_size=sample_frame_16k,
            input_buffer_16k_size=input_buffer_16k_size,
        )

    @staticmethod
    def for_request(
        input_16k_len: int,
        sample_frame_16k_size: int,
        skip_head: int,
        return_length: int,
        model_sample_rate: int = 40000,
        feature_dim: int = 768,
        sample_rate: int = 48000,
    ) -> "ChunkConfig":
        """Geometry for one engine/RPC request, from the numbers the wire
        protocol carries (input length, ``sample_frame_16k_size``,
        ``skip_head``, ``return_length``). Only the 16 kHz-side fields mean
        anything; the device-rate fields are consistent placeholders (the
        48 kHz resample and SOLA half lives with the client in this mode)."""
        if sample_frame_16k_size % ZC_16K != 0:
            raise ValueError(
                f"sample_frame_16k_size must be a multiple of {ZC_16K}, got {sample_frame_16k_size}"
            )
        zc = sample_rate // 100
        frames_in = -(-input_16k_len // ZC_16K)  # ceil; 48k-side placeholder
        return ChunkConfig(
            sample_rate=sample_rate,
            model_sample_rate=model_sample_rate,
            feature_dim=feature_dim,
            skip_inference=False,
            zc=zc,
            sample_frame_size=(sample_frame_16k_size // ZC_16K) * zc,
            crossfade_frame_size=4 * zc,
            sola_buffer_frame_size=4 * zc,
            sola_search_frame_size=zc,
            extra_frame_size=skip_head * zc,
            input_buffer_size=frames_in * zc,
            model_return_length=return_length,
            model_return_size=return_length * (model_sample_rate // 100),
            sample_frame_16k_size=sample_frame_16k_size,
            input_buffer_16k_size=input_16k_len,
        )

    @property
    def skip_head(self) -> int:
        """Leading 10 ms feature frames dropped from the model output."""
        return self.extra_frame_size // self.zc

    @property
    def return_length(self) -> int:
        return self.model_return_length

    @property
    def rmvpe_frame_16k(self) -> int:
        """16 kHz samples RMVPE sees per chunk: ``5120*ceil((n16k+800)/5120) - 160``."""
        n = self.sample_frame_16k_size
        return 5120 * ((n + 800 - 1) // 5120 + 1) - RMVPE_HOP

    @property
    def rmvpe_n_frames(self) -> int:
        """RMVPE frames per chunk, ``1 + L // hop`` (a multiple of 32)."""
        return 1 + self.rmvpe_frame_16k // RMVPE_HOP

    @property
    def pitch_cache_len(self) -> int:
        return 1024

    @property
    def downsample_window(self) -> int:
        """Device-rate samples resampled to 16 kHz per chunk."""
        return self.sample_frame_size + 2 * self.zc

    @property
    def downsample_keep_16k(self) -> int:
        """16 kHz samples written to the tail of the 16 kHz ring per chunk."""
        return (self.sample_frame_size // self.zc + 1) * ZC_16K

    @property
    def latency_seconds(self) -> float:
        """Algorithmic latency contributed by chunking (one chunk)."""
        return self.sample_frame_size / self.sample_rate

    def validate(self) -> None:
        """Raise ``ValueError`` on a geometry the step cannot run."""
        if self.input_buffer_size % self.zc != 0:
            raise ValueError("input buffer is not a whole number of 10 ms blocks")
        if self.model_return_size % (self.model_sample_rate // 100) != 0:
            raise ValueError("model return size is not a whole number of 10 ms blocks")
        if self.sola_buffer_frame_size > 4 * self.zc:
            raise ValueError("SOLA buffer longer than 40 ms")
        hubert_len = self.input_buffer_16k_size // ZC_16K
        if self.skip_head + self.return_length > hubert_len:
            raise ValueError("model slice exceeds available feature frames; increase extra_inference_time")


def gcd_ratio(sr_in: int, sr_out: int) -> tuple[int, int]:
    """Reduced (up, down) resampling ratio."""
    g = math.gcd(sr_in, sr_out)
    return sr_out // g, sr_in // g


class ReloadTier(enum.IntEnum):
    """What a settings change requires: the plugin's three classes of change
    (counterpart of ``obs_rvc_tpu.config.ReloadTier``)."""

    NONE = 0      #: identical settings
    LIVE = 1      #: live controls, taken at the next chunk
    GEOMETRY = 2  #: a new chunk geometry (a new ChunkConfig, new graphs)
    MODEL = 3     #: new weights or a new pipeline


#: settings fields by reload tier
_LIVE_FIELDS = frozenset({"pitch_shift", "index_rate", "rms_mix_rate"})
_GEOMETRY_FIELDS = frozenset({"sample_length", "fade_length", "extra_inference_time", "dest_sample_rate",
                              "skip_inference", "resonance_shift"})
_MODEL_FIELDS = frozenset({"model_path", "index_path", "model_version", "pitch_algorithm"})


def diff_settings(old: StreamSettings, new: StreamSettings) -> ReloadTier:
    """The most invasive tier a settings change touches."""
    tier = ReloadTier.NONE
    for f in dataclasses.fields(StreamSettings):
        if getattr(old, f.name) == getattr(new, f.name):
            continue
        if f.name in _MODEL_FIELDS:
            return ReloadTier.MODEL
        if f.name in _GEOMETRY_FIELDS:
            tier = max(tier, ReloadTier.GEOMETRY)
        elif f.name in _LIVE_FIELDS:
            tier = max(tier, ReloadTier.LIVE)
        else:
            raise ValueError(f"unclassified setting {f.name!r}")
    return tier
