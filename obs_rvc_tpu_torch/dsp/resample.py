"""Polyphase sample-rate conversion (counterpart of ``obs_rvc_tpu/dsp/resample.py``).

A zero-phase Kaiser-windowed sinc lowpass, decomposed into ``up`` phase
kernels over the original signal: one stride-``down`` VALID convolution with
``up`` output channels, then the phases are interleaved. ``y[k]`` estimates
``x(k * down / up)`` with no group delay; edges are zero-padded, and the
streaming step supplies left context by resampling overlapping windows.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from obs_rvc_tpu_torch.config import gcd_ratio


@functools.lru_cache(maxsize=16)
def _design_filter(up: int, down: int, taps_per_phase: int, beta: float) -> np.ndarray:
    """Kaiser-windowed sinc lowpass for up/down conversion, odd length, gain ``up``."""
    m = max(up, down)
    half = taps_per_phase * m
    n = np.arange(-half, half + 1, dtype=np.float64)
    cutoff = 1.0 / m
    h = cutoff * np.sinc(cutoff * n)
    h *= np.kaiser(2 * half + 1, beta)
    h /= h.sum()
    return (h * up).astype(np.float32)


@functools.lru_cache(maxsize=16)
def _phase_bank(up: int, down: int, taps_per_phase: int, beta: float):
    """Per-phase kernels ``G[r, 0, s - s_min] = h[up*s + pad - r*down]`` so that
    ``y[m*up + r] = sum_s x[m*down + s] * G[r, s]``. Returns ``(G, left, right)``."""
    h = _design_filter(up, down, taps_per_phase, beta)
    L = h.shape[0]
    pad = (L - 1) // 2
    s_min = min(-(-(0 - pad + r * down) // up) for r in range(up))
    s_max = max((L - 1 - pad + r * down) // up for r in range(up))
    G = np.zeros((up, 1, s_max - s_min + 1), np.float32)
    for r in range(up):
        for s in range(s_min, s_max + 1):
            t = up * s + pad - r * down
            if 0 <= t < L:
                G[r, 0, s - s_min] = h[t]
    return G, -s_min, s_max


@functools.lru_cache(maxsize=16)
def _phase_bank_on(up: int, down: int, taps_per_phase: int, beta: float,
                   device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_phase_bank(up, down, taps_per_phase, beta)[0]).to(device)


def resample_poly(
    x: torch.Tensor,
    sr_in: int,
    sr_out: int,
    taps_per_phase: int = 16,
    beta: float = 8.555,
) -> torch.Tensor:
    """Resample a 1-D or ``[batch, n]`` signal from ``sr_in`` to ``sr_out``;
    output length ``ceil(n * up / down)``."""
    up, down = gcd_ratio(sr_in, sr_out)
    if up == 1 and down == 1:
        return x
    squeeze = x.dim() == 1
    if squeeze:
        x = x[None, :]
    n = x.shape[-1]
    m_out = -(-n // down)
    _, left, right = _phase_bank(up, down, taps_per_phase, beta)
    G = _phase_bank_on(up, down, taps_per_phase, beta, x.device)
    need = (m_out - 1) * down + right + 1
    xp = F.pad(x.float(), (left, max(0, need - n)))
    out = F.conv1d(xp[:, None, :], G, stride=down)  # [B, up, m_out]
    y = out.transpose(1, 2).reshape(x.shape[0], m_out * up)[:, : -(-n * up // down)]
    return y[0] if squeeze else y


class PolyphaseResampler:
    """Fixed-geometry resampler for one ``(sr_in, sr_out, chunk)``
    configuration (counterpart of ``obs_rvc_tpu/dsp/resample.py:PolyphaseResampler``):
    the construction sites of the reference's two resamplers, a down path
    ``device_rate → 16k`` over ``sample_frame + 2*zc`` windows and an up path
    ``model_rate → device_rate`` over ``model_return_size`` chunks."""

    def __init__(self, sr_in: int, sr_out: int, chunk_size_in: int, taps_per_phase: int = 16,
                 beta: float = 8.555):
        self.sr_in = sr_in
        self.sr_out = sr_out
        self.up, self.down = gcd_ratio(sr_in, sr_out)
        self.chunk_size_in = chunk_size_in
        if (chunk_size_in * self.up) % self.down != 0:
            raise ValueError(f"chunk {chunk_size_in} not commensurate with {sr_in}->{sr_out}")
        self.chunk_size_out = chunk_size_in * self.up // self.down
        self.taps_per_phase = taps_per_phase
        self.beta = beta

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        """``[chunk_size_in]`` or ``[B, chunk_size_in]`` → ``[..., chunk_size_out]``."""
        if x.shape[-1] != self.chunk_size_in:
            raise ValueError(f"a chunk of {x.shape[-1]} samples, the resampler takes {self.chunk_size_in}")
        return resample_poly(x, self.sr_in, self.sr_out, self.taps_per_phase, self.beta)


def resample_poly_dilated(x: torch.Tensor, sr_in: int, sr_out: int, taps_per_phase: int = 16,
                          beta: float = 8.555) -> torch.Tensor:
    """The textbook form of :func:`resample_poly`: the signal zero-stuffed by
    ``up``, the whole lowpass run over it at stride ``down``. Kept as the
    oracle of the phase-bank path (counterpart of the JAX
    ``resample_poly_dilated``); ``[L]`` or ``[B, L]``."""
    up, down = gcd_ratio(sr_in, sr_out)
    if up == 1 and down == 1:
        return x
    h = torch.from_numpy(_design_filter(up, down, taps_per_phase, beta)).to(x.device)
    pad = (h.shape[0] - 1) // 2
    squeeze = x.dim() == 1
    x = (x[None] if squeeze else x).to(torch.float32)
    stuffed = x.new_zeros(x.shape[0], (x.shape[1] - 1) * up + 1)
    stuffed[:, ::up] = x
    stuffed = F.pad(stuffed, (pad, pad + up - 1))
    out = F.conv1d(stuffed[:, None, :], h.flip(0)[None, None, :], stride=down)[:, 0, :]
    return out[0] if squeeze else out
