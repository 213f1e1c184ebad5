"""Framed STFT magnitude (counterpart of ``obs_rvc_tpu/dsp/stft.py``).

Centred frames (reflect padding of ``fft_size/2``), ``T = 1 + L // hop``
frames, periodic-Hann windowing, one-sided magnitude ``[n_bins, T]`` (over
the last axis: ``[..., n_bins, T]`` for signals with leading stream axes). The
DFT is two matmuls against cos/-sin bases, as the JAX package's default
``method="matmul"`` computes it.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from obs_rvc_tpu_torch.dsp.window import pad_reflect


def frame_signal(x: torch.Tensor, frame_length: int, hop_length: int, num_frames: int) -> torch.Tensor:
    """``[..., num_frames, frame_length]`` frames of a signal's last axis,
    frame ``i`` starting at ``i*hop_length``; zero-padded at the end where short."""
    need = (num_frames - 1) * hop_length + frame_length
    if x.shape[-1] < need:
        x = F.pad(x, (0, need - x.shape[-1]))
    return x[..., :need].unfold(-1, frame_length, hop_length)


@functools.lru_cache(maxsize=8)
def dft_matrices(fft_size: int) -> tuple[np.ndarray, np.ndarray]:
    """``(cos, -sin)`` real-DFT bases, each ``[fft_size, fft_size//2 + 1]``."""
    n_bins = fft_size // 2 + 1
    n = np.arange(fft_size, dtype=np.float64)[:, None]
    k = np.arange(n_bins, dtype=np.float64)[None, :]
    ang = 2.0 * np.pi * n * k / fft_size
    return np.cos(ang).astype(np.float32), (-np.sin(ang)).astype(np.float32)


@functools.lru_cache(maxsize=8)
def _dft_bases(fft_size: int, device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """The DFT bases resident on ``device`` (copied there once)."""
    return tuple(torch.from_numpy(m).to(device) for m in dft_matrices(fft_size))


def stft_magnitude(
    signal: torch.Tensor,
    fft_size: int,
    hop_length: int,
    window: torch.Tensor,
) -> torch.Tensor:
    """One-sided STFT magnitude of centred frames, ``[fft_size//2 + 1, T]``.
    A window shorter than ``fft_size`` is centered in a zero frame."""
    num_frames = 1 + signal.shape[-1] // hop_length
    signal = pad_reflect(signal, fft_size // 2)

    win_length = window.shape[0]
    if win_length < fft_size:
        pad_left = (fft_size - win_length) // 2
        window = F.pad(window, (pad_left, fft_size - win_length - pad_left))

    frames = frame_signal(signal, fft_size, hop_length, num_frames) * window
    cos_b, msin_b = _dft_bases(fft_size, frames.device)
    re = frames @ cos_b
    im = frames @ msin_b
    return torch.sqrt(re * re + im * im).transpose(-1, -2)
