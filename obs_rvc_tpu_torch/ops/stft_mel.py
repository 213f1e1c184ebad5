"""The RMVPE log-mel frontend, fused (counterpart of
``obs_rvc_tpu/ops/stft_mel.py:log_mel_pallas``).

For a 1-D signal of ``L`` samples and ``T = 1 + L // hop`` frames::

    frames = reflect-padded (fft/2 each side) signal, hop-strided, x periodic Hann
    re, im = frames @ cos, frames @ (-sin)           (513 one-sided bins)
    mel    = sqrt(re^2 + im^2) @ mel_basis^T         (128 bands)
    out    = ln(max(mel, clamp))                     [n_mels, T]

Reflect padding follows ``np.pad(mode="reflect")``, reflecting again where the
signal is shorter than the pad, as the JAX package's ``jnp.pad`` does.

Keyshift 0 only, ``fft_size == win_length == 1024``: the Pallas kernel never
computed the keyshift resize, and ``MelSpectrogram`` keeps its own code for
keyshift != 0 on every device.

:func:`log_mel` takes the plain PyTorch version for a tensor on the CPU and
launches the CUDA kernel (``csrc/stft_mel.cu``) for a tensor on a card; it
never falls back from one to the other.
"""

from __future__ import annotations

import ctypes
import functools
import numpy as np
import torch

from obs_rvc_tpu_torch.dsp.stft import _dft_bases
from obs_rvc_tpu_torch.ops import _cuda

#: the only FFT and window size the kernel is built for
CUDA_FFT_SIZE = 1024

#: wrapper calls that launched the CUDA kernel
LAUNCHES = 0


def reflect_indices(L: int, fft_size: int, hop_length: int, num_frames: int, device=None) -> torch.Tensor:
    """``[num_frames, fft_size]`` indices into a signal of ``L`` samples that
    frame its centred, reflect-padded form (``np.pad`` reflect semantics)."""
    if L < 1:
        raise ValueError("log_mel: the signal is empty")
    p = (torch.arange(num_frames, device=device)[:, None] * hop_length
         + torch.arange(fft_size, device=device)[None, :] - fft_size // 2)
    if L == 1:
        return torch.zeros_like(p)
    period = 2 * (L - 1)
    q = torch.remainder(p, period)
    return torch.where(q < L, q, period - q)


@functools.lru_cache(maxsize=8)
def _cos_table(fft_size: int, device: torch.device) -> torch.Tensor:
    """``cos(2 pi j / fft_size)`` for ``j < fft_size``, computed in float64 as
    ``dft_matrices`` computes its bases, then cast; ``-sin`` at ``j`` is the
    entry at ``j + fft_size/4``."""
    j = np.arange(fft_size, dtype=np.float64)
    return torch.from_numpy(np.cos(2.0 * np.pi * j / fft_size).astype(np.float32)).to(device)


def log_mel_plain(signal: torch.Tensor, mel_basis: torch.Tensor, window: torch.Tensor,
                  hop_length: int = 160, clamp: float = 1e-5) -> torch.Tensor:
    """The frontend as framing, two DFT matmuls and a mel matmul, in float32."""
    fft_size = window.shape[0]
    L = signal.shape[-1]
    T = 1 + L // hop_length
    x = signal.to(torch.float32)
    frames = x[reflect_indices(L, fft_size, hop_length, T, device=x.device)] * window[None, :]
    cos_b, msin_b = _dft_bases(fft_size, x.device)
    re = frames @ cos_b
    im = frames @ msin_b
    mag = torch.sqrt(re * re + im * im)  # [T, bins]
    mel = (mag @ mel_basis.T).T  # [n_mels, T]
    return torch.log(torch.clamp(mel, min=clamp))


def log_mel(signal: torch.Tensor, mel_basis: torch.Tensor, window: torch.Tensor,
            hop_length: int = 160, clamp: float = 1e-5) -> torch.Tensor:
    """Log-mel ``[n_mels, 1 + L // hop]`` of a 1-D signal with center/reflect
    padding, for a ``[n_mels, fft/2 + 1]`` ``mel_basis`` and an
    ``[fft_size]`` ``window`` (``MelSpectrogram`` passes its own)."""
    if signal.device.type == "cpu":
        return log_mel_plain(signal, mel_basis, window, hop_length, clamp)
    if signal.device.type != "cuda":
        raise ValueError(f"log_mel: unsupported device {signal.device}")
    return _log_mel_cuda(signal, mel_basis, window, hop_length, clamp)


def _log_mel_cuda(signal, mel_basis, window, hop_length, clamp) -> torch.Tensor:
    global LAUNCHES
    if signal.dim() != 1 or not signal.is_contiguous():
        raise ValueError("log_mel: the signal must be a contiguous 1-D tensor")
    if signal.dtype != torch.float32:
        raise ValueError(f"log_mel: unsupported dtype {signal.dtype} (the kernel takes float32)")
    if window.shape != (CUDA_FFT_SIZE,):
        raise NotImplementedError(f"log_mel: the CUDA kernel takes fft_size == win_length == {CUDA_FFT_SIZE}, "
                                  f"got a window of {tuple(window.shape)}")
    n_bins = CUDA_FFT_SIZE // 2 + 1
    if mel_basis.dim() != 2 or mel_basis.shape[1] != n_bins:
        raise ValueError(f"log_mel: mel_basis must be [n_mels, {n_bins}], got {tuple(mel_basis.shape)}")
    if hop_length < 1:
        raise ValueError("log_mel: hop_length must be positive")
    for name, t in (("mel_basis", mel_basis), ("window", window)):
        if t.device != signal.device or t.dtype != torch.float32:
            raise ValueError(f"log_mel: {name} must be float32 on the signal's device")
    L = signal.shape[0]
    if L < 1:
        raise ValueError("log_mel: the signal is empty")
    T = 1 + L // hop_length
    n_mels = mel_basis.shape[0]
    fn = _cuda.function("stft_mel", "rvc_log_mel",
                        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_void_p])
    basis = mel_basis.contiguous()
    win = window.contiguous()
    table = _cos_table(CUDA_FFT_SIZE, signal.device)
    out = torch.empty((n_mels, T), dtype=torch.float32, device=signal.device)
    rc = fn(_cuda.ptr(signal), _cuda.ptr(win), _cuda.ptr(table), _cuda.ptr(basis), _cuda.ptr(out),
            L, T, hop_length, n_mels, ctypes.c_float(clamp), _cuda.stream_of(signal))
    _cuda.check(rc, f"log_mel (L={L}, T={T})")
    with _cuda.COUNT_LOCK:
        LAUNCHES += 1
    return out
