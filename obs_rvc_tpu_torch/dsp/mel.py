"""Mel filterbank and log-mel frontend for RMVPE (counterpart of
``obs_rvc_tpu/dsp/mel.py``).

Filterbank: librosa-compatible triangular filters, HTK mel scale by default,
Slaney area normalisation. Extractor: STFT magnitude → optional keyshift
resize → mel matmul → ``ln(max(x, clamp))``.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from obs_rvc_tpu_torch.device import resolve_device
from obs_rvc_tpu_torch.dsp.stft import stft_magnitude
from obs_rvc_tpu_torch.dsp.window import hann_window_periodic
from obs_rvc_tpu_torch.ops import stft_mel


def _hz_to_mel(f, htk: bool) -> np.ndarray:
    f = np.asarray(f, dtype=np.float64)
    if htk:
        return 2595.0 * np.log10(1.0 + f / 700.0)
    f_min, f_sp = 0.0, 200.0 / 3
    mels = (f - f_min) / f_sp
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(
        f >= min_log_hz, min_log_mel + np.log(np.maximum(f, 1e-10) / min_log_hz) / logstep, mels
    )


def _mel_to_hz(m, htk: bool) -> np.ndarray:
    m = np.asarray(m, dtype=np.float64)
    if htk:
        return 700.0 * (10.0 ** (m / 2595.0) - 1.0)
    f_min, f_sp = 0.0, 200.0 / 3
    freqs = f_min + f_sp * m
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(m >= min_log_mel, min_log_hz * np.exp(logstep * (m - min_log_mel)), freqs)


@functools.lru_cache(maxsize=8)
def mel_filterbank(
    sample_rate: int,
    n_fft: int,
    n_mels: int,
    fmin: float,
    fmax: float,
    htk: bool = True,
    norm: Optional[str] = "slaney",
) -> np.ndarray:
    """Triangular mel filterbank, ``[n_mels, n_fft//2+1]``."""
    n_bins = n_fft // 2 + 1
    fft_freqs = np.linspace(0.0, sample_rate / 2.0, n_bins)
    mel_pts = _mel_to_hz(
        np.linspace(_hz_to_mel(fmin, htk), _hz_to_mel(fmax, htk), n_mels + 2), htk
    )
    fdiff = np.diff(mel_pts)
    ramps = mel_pts[:, None] - fft_freqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    if norm == "slaney":
        weights *= (2.0 / (mel_pts[2 : n_mels + 2] - mel_pts[:n_mels]))[:, None]
    elif norm is not None:
        raise ValueError(f"unknown mel norm {norm!r}")
    return weights.astype(np.float32)


class MelSpectrogram:
    """Log-mel frontend with the keyshift mechanism: ``keyshift`` scales the
    analysis FFT and window by ``2^(k/12)`` and truncates or zero-pads the
    magnitude back onto the base bins, rescaled by the window ratio."""

    def __init__(
        self,
        fft_size: int = 1024,
        sample_rate: int = 16000,
        n_mels: int = 128,
        win_length: int = 1024,
        hop_length: int = 160,
        f_min: float = 30.0,
        f_max: float = 8000.0,
        clamp: float = 1e-5,
        norm: Optional[str] = "slaney",
        htk: bool = True,
        device=None,
    ):
        self.fft_size = fft_size
        self.win_length = win_length
        self.hop_length = hop_length
        self.clamp = clamp
        self.device = resolve_device(device)
        self.mel_basis = torch.from_numpy(
            mel_filterbank(sample_rate, fft_size, n_mels, f_min, f_max, htk=htk, norm=norm)
        ).to(self.device)
        #: the basis the fused frontend takes on this device: the dense one on
        #: the CPU, packed once for the kernel on a card
        self.log_mel_basis = (stft_mel.pack_mel_basis(self.mel_basis) if self.device.type == "cuda"
                              else self.mel_basis)
        #: the analysis window at keyshift 0
        self.window = hann_window_periodic(win_length, device=self.device)
        self._windows: dict[int, torch.Tensor] = {win_length: self.window}

    def _window(self, n: int) -> torch.Tensor:
        if n not in self._windows:
            self._windows[n] = hann_window_periodic(n, device=self.device)
        return self._windows[n]

    def __call__(self, signal: torch.Tensor, keyshift: int = 0) -> torch.Tensor:
        """Log-mel spectrogram ``[n_mels, T]`` with ``T = 1 + L // hop``.

        At keyshift 0 with the 1024-sample FFT and window this is the fused
        frontend :func:`~obs_rvc_tpu_torch.ops.stft_mel.log_mel` (its CUDA
        kernel on a card, its plain version on the CPU). Any other keyshift
        or size takes the code below on every device: the fused frontend,
        like the JAX package's Pallas kernel, never computes the keyshift
        resize."""
        if keyshift == 0 and self.fft_size == self.win_length == stft_mel.CUDA_FFT_SIZE:
            return stft_mel.log_mel(signal, self.log_mel_basis, self.window,
                                    hop_length=self.hop_length, clamp=self.clamp)
        factor = 2.0 ** (keyshift / 12.0)
        fft_size_new = int(round(self.fft_size * factor))
        win_length_new = int(round(self.win_length * factor))
        magnitude = stft_magnitude(
            signal, fft_size_new, self.hop_length, self._window(win_length_new)
        ).T  # [T, n_bins_new]
        if keyshift != 0:
            size = self.fft_size // 2 + 1
            resize = magnitude.shape[-1]
            if resize < size:
                magnitude = F.pad(magnitude, (0, size - resize))
            magnitude = magnitude[:, :size] * (self.win_length / win_length_new)
        mel = (magnitude @ self.mel_basis.T).T  # [n_mels, T]
        return torch.log(torch.clamp(mel, min=self.clamp))
