"""Static stream geometry: the port's own copy of the chunk-size algebra.

Same derivation as ``obs_rvc_tpu/config.py:ChunkConfig`` (the obs-rvc
plugin's frame-size math): every buffer size of the streaming step follows
from the device sample rate, the chunk, fade and context lengths and the
model's output rate. Kept as a frozen dataclass so a pipeline's geometry is
fixed at construction.
"""

from __future__ import annotations

import dataclasses
import enum
import math


class RvcModelVersion(enum.Enum):
    """RVC model generation: v1 uses 256-dim features from layer 9, v2
    768-dim features from layer 12."""

    V1 = 1
    V2 = 2

    def __str__(self) -> str:
        return "v1" if self is RvcModelVersion.V1 else "v2"


#: 16 kHz samples per 10 ms block.
ZC_16K = 160

#: RMVPE analysis hop at 16 kHz.
RMVPE_HOP = 160


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

    def validate(self) -> None:
        assert self.input_buffer_size % self.zc == 0
        assert self.model_return_size % (self.model_sample_rate // 100) == 0
        assert self.sola_buffer_frame_size <= 4 * self.zc
        hubert_len = self.input_buffer_16k_size // ZC_16K
        assert self.skip_head + self.return_length <= hubert_len, (
            "model slice exceeds available feature frames; increase extra_inference_time"
        )


def gcd_ratio(sr_in: int, sr_out: int) -> tuple[int, int]:
    """Reduced (up, down) resampling ratio."""
    g = math.gcd(sr_in, sr_out)
    return sr_out // g, sr_in // g
