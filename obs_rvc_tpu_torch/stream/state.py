"""Streaming state of one stream (counterpart of ``obs_rvc_tpu/stream/state.py``):

- ``input_buffer``      device-rate input ring
- ``input_buffer_16k``  16 kHz ring fed to the networks
- ``sola_buffer``       saved crossfade tail
- ``cache_pitchf``      1024-frame sliding f0 cache (100 Hz)
"""

from __future__ import annotations

import dataclasses

import torch

from obs_rvc_tpu_torch.config import ChunkConfig


@dataclasses.dataclass
class StreamState:
    input_buffer: torch.Tensor
    input_buffer_16k: torch.Tensor
    sola_buffer: torch.Tensor
    cache_pitchf: torch.Tensor

    @staticmethod
    def init(cfg: ChunkConfig, device="cpu") -> "StreamState":
        def zeros(n):
            return torch.zeros(n, dtype=torch.float32, device=device)

        return StreamState(
            input_buffer=zeros(cfg.input_buffer_size),
            input_buffer_16k=zeros(cfg.input_buffer_16k_size),
            sola_buffer=zeros(cfg.sola_buffer_frame_size),
            cache_pitchf=zeros(cfg.pitch_cache_len),
        )

    def clear(self) -> "StreamState":
        return StreamState(**{f.name: torch.zeros_like(getattr(self, f.name))
                              for f in dataclasses.fields(self)})

    def to(self, device) -> "StreamState":
        return StreamState(**{f.name: getattr(self, f.name).to(device)
                              for f in dataclasses.fields(self)})
