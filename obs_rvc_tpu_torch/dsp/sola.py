"""SOLA alignment and crossfade (counterpart of ``obs_rvc_tpu/dsp/sola.py``).

The normalised cross-correlation's numerator is an FFT correlation and its
denominator a prefix-sum window energy. The winning offset stays on the
device: the aligned window is gathered with it, so a step never waits on
the host for it. Leading axes are streams: each row finds its own offset
and is gathered at it.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def sola_offset(
    output_wav: torch.Tensor,
    sola_buffer: torch.Tensor,
    buffer_frame_size: int,
    search_frame_size: int,
) -> torch.Tensor:
    """Offset in ``[0, search_frame_size]`` maximising
    ``<out[k:k+B], sola> / sqrt(sum(out[k:k+B]^2) + 1e-8)``, as a 0-d tensor
    (``[B]`` for ``[B, n]`` signals)."""
    n_offsets = search_frame_size + 1
    conv_input = output_wav[..., : buffer_frame_size + search_frame_size]
    n_fft = 1
    while n_fft < buffer_frame_size + search_frame_size + n_offsets:
        n_fft <<= 1
    fx = torch.fft.rfft(conv_input, n_fft)
    fs = torch.fft.rfft(sola_buffer, n_fft)
    cor_nom = torch.fft.irfft(fx * torch.conj(fs), n_fft)[..., :n_offsets].float()
    csum = torch.cumsum(F.pad(conv_input * conv_input, (1, 0)), dim=-1)
    energy = csum[..., buffer_frame_size:] - csum[..., :n_offsets]
    return torch.argmax(cor_nom / torch.sqrt(energy + 1e-8), dim=-1)


def phase_vocoder_blend(
    a: torch.Tensor,
    b: torch.Tensor,
    fade_out: torch.Tensor,
    fade_in: torch.Tensor,
) -> torch.Tensor:
    """Phase-vocoder crossfade of the overlap ``a``→``b`` (both length n): the
    windowed spectra are blended with phase-difference-corrected sinusoids.
    Over the last axis, each stream's overlap on its own."""
    n = a.shape[-1]
    window = torch.sqrt(fade_out * fade_in)
    fa = torch.fft.rfft(a * window)
    fb = torch.fft.rfft(b * window)
    absab = (torch.abs(fa) + torch.abs(fb)).float()
    scale = torch.full_like(absab, 2.0)
    scale[..., 0] = 1.0
    if n % 2 == 0:
        scale[..., -1] = 1.0
    absab = absab * scale
    phia = torch.angle(fa)
    deltaphase = torch.angle(fb) - phia
    deltaphase = deltaphase - 2 * math.pi * torch.floor(deltaphase / (2 * math.pi) + 0.5)
    w = 2 * math.pi * torch.arange(n // 2 + 1, dtype=torch.float32, device=a.device) + deltaphase
    t = (torch.arange(n, dtype=torch.float32, device=a.device) / n)[:, None]
    interp = torch.sum(absab[..., None, :] * torch.cos(w[..., None, :] * t + phia[..., None, :]), dim=-1)
    return a * fade_out**2 + b * fade_in**2 + interp * window / n


def sola_crossfade(
    output_wav: torch.Tensor,
    sola_buffer: torch.Tensor,
    offset: torch.Tensor,
    fade_in: torch.Tensor,
    fade_out: torch.Tensor,
    sample_frame_size: int,
    phase_vocoder: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Align ``output_wav`` at ``offset``, crossfade its head with the saved
    tail; returns ``(emitted [sample_frame_size], next sola_buffer)``. With
    ``[B, n]`` signals ``offset`` is ``[B]`` and each row is gathered at its own."""
    buffer_size = sola_buffer.shape[-1]
    aligned_len = sample_frame_size + buffer_size
    idx = offset[..., None] + torch.arange(aligned_len, device=output_wav.device)
    aligned = torch.gather(output_wav, -1, idx)
    if phase_vocoder:
        head = phase_vocoder_blend(sola_buffer, aligned[..., :buffer_size], fade_out, fade_in)
    else:
        head = aligned[..., :buffer_size] * fade_in + sola_buffer * fade_out
    aligned = torch.cat([head, aligned[..., buffer_size:]], dim=-1)
    return aligned[..., :sample_frame_size], aligned[..., sample_frame_size:aligned_len]
