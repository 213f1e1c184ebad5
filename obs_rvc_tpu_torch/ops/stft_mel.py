"""The RMVPE log-mel frontend, fused (counterpart of
``obs_rvc_tpu/ops/stft_mel.py:log_mel_pallas``).

For a signal of ``L`` samples and ``T = 1 + L // hop`` frames (``B`` streams
``[B, L]`` give ``[B, n_mels, T]``; a 1-D signal is the B=1 view)::

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
launches the CUDA kernel (``csrc/stft_mel.cu``, a real FFT per frame in
shared memory and a sparse mel product) for a tensor on a card; it never
falls back from one to the other. The plain version takes the dense basis;
the kernel takes only the basis packed by :func:`pack_mel_basis` (each
row's run of weights from its first to its last nonzero bin), which
``MelSpectrogram`` makes once.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Union

import numpy as np
import torch

from obs_rvc_tpu_torch.dsp.stft import _dft_bases
from obs_rvc_tpu_torch.ops import _cuda

#: the only FFT and window size the kernel is built for
CUDA_FFT_SIZE = 1024
#: basis weights the kernel stages into shared memory at a time
PIECE = 2048

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


class PackedMelBasis(NamedTuple):
    """A ``[n_mels, n_bins]`` mel basis as the kernel reads it: row ``m``'s
    weights ``weights[row_off[m]:row_off[m+1]]`` start at bin
    ``row_start[m]`` and run to its last nonzero bin (an empty row has none);
    ``pieces`` are the rows that start each run of at most ``PIECE``
    weights, then ``n_mels``."""

    row_start: torch.Tensor  # [n_mels] int32
    row_off: torch.Tensor  # [n_mels + 1] int32
    weights: torch.Tensor  # [max(1, nnz)] float32
    pieces: torch.Tensor  # [n_pieces + 1] int32
    n_bins: int


def pack_mel_basis(mel_basis: torch.Tensor, device=None) -> PackedMelBasis:
    """Pack ``mel_basis`` (copied to the host to do so) for the kernel, onto
    ``device`` (default: the basis's own)."""
    b = mel_basis.detach().to("cpu", torch.float32).numpy()
    n_mels, n_bins = b.shape
    starts, offs, chunks, pieces = [], [0], [], [0]
    for m in range(n_mels):
        nz = np.flatnonzero(b[m])
        lo, hi = (int(nz[0]), int(nz[-1]) + 1) if nz.size else (0, 0)
        starts.append(lo)
        chunks.append(b[m, lo:hi])
        offs.append(offs[-1] + hi - lo)
        if offs[-1] - offs[pieces[-1]] > PIECE:
            pieces.append(m)
    pieces.append(n_mels)
    weights = np.concatenate(chunks) if offs[-1] else np.zeros(0, np.float32)
    dev = mel_basis.device if device is None else device

    def t(a, dt):
        return torch.from_numpy(np.asarray(a, dt)).to(dev)

    return PackedMelBasis(t(starts, np.int32), t(offs, np.int32),
                          t(np.concatenate([weights, np.zeros(max(0, 1 - weights.size), np.float32)]), np.float32),
                          t(pieces, np.int32), n_bins)


def log_mel_plain(signal: torch.Tensor, mel_basis: torch.Tensor, window: torch.Tensor,
                  hop_length: int = 160, clamp: float = 1e-5) -> torch.Tensor:
    """The frontend as framing, two DFT matmuls and a mel matmul, in float32,
    over the last axis: ``[L]`` → ``[n_mels, T]``, ``[B, L]`` → ``[B, n_mels, T]``."""
    fft_size = window.shape[0]
    L = signal.shape[-1]
    T = 1 + L // hop_length
    x = signal.to(torch.float32)
    frames = x[..., reflect_indices(L, fft_size, hop_length, T, device=x.device)] * window
    cos_b, msin_b = _dft_bases(fft_size, x.device)
    re = frames @ cos_b
    im = frames @ msin_b
    mag = torch.sqrt(re * re + im * im)  # [..., T, bins]
    mel = (mag @ mel_basis.T).transpose(-1, -2)  # [..., n_mels, T]
    return torch.log(torch.clamp(mel, min=clamp))


def log_mel(signal: torch.Tensor, mel_basis: Union[torch.Tensor, PackedMelBasis], window: torch.Tensor,
            hop_length: int = 160, clamp: float = 1e-5) -> torch.Tensor:
    """Log-mel ``[B, n_mels, 1 + L // hop]`` of ``B`` streams ``[B, L]`` with
    center/reflect padding, for an ``[fft_size]`` ``window``; a 1-D signal
    ``[L]`` is the B=1 view and gives ``[n_mels, 1 + L // hop]``. ``mel_basis``
    is the dense ``[n_mels, fft/2 + 1]`` basis for a signal on the CPU, and
    that basis packed by :func:`pack_mel_basis` for a signal on a card, where
    one launch covers every stream."""
    if signal.device.type == "cpu":
        if isinstance(mel_basis, PackedMelBasis):
            raise ValueError("log_mel: on the CPU mel_basis is the dense basis, not its packed form")
        return log_mel_plain(signal, mel_basis, window, hop_length, clamp)
    if signal.device.type != "cuda":
        raise ValueError(f"log_mel: unsupported device {signal.device}")
    return _log_mel_cuda(signal, mel_basis, window, hop_length, clamp)


def _log_mel_cuda(signal, packed: PackedMelBasis, window, hop_length, clamp) -> torch.Tensor:
    global LAUNCHES
    if signal.dim() == 1:
        return _log_mel_cuda(signal[None], packed, window, hop_length, clamp)[0]
    if signal.dim() != 2 or signal.stride(1) != 1 or signal.stride(0) < signal.shape[1]:
        raise ValueError("log_mel: the signal must be [L] or [B, L] with each row contiguous")
    if signal.dtype != torch.float32:
        raise ValueError(f"log_mel: unsupported dtype {signal.dtype} (the kernel takes float32)")
    if window.shape != (CUDA_FFT_SIZE,):
        raise NotImplementedError(f"log_mel: the CUDA kernel takes fft_size == win_length == {CUDA_FFT_SIZE}, "
                                  f"got a window of {tuple(window.shape)}")
    if hop_length < 1:
        raise ValueError("log_mel: hop_length must be positive")
    if window.device != signal.device or window.dtype != torch.float32:
        raise ValueError("log_mel: window must be float32 on the signal's device")
    B, L = signal.shape
    if L < 1 or B < 1:
        raise ValueError("log_mel: the signal is empty")
    if not isinstance(packed, PackedMelBasis):
        raise ValueError("log_mel: on a card mel_basis must be packed by pack_mel_basis")
    n_bins = CUDA_FFT_SIZE // 2 + 1
    if packed.n_bins != n_bins:
        raise ValueError(f"log_mel: mel_basis must have {n_bins} bins, got {packed.n_bins}")
    if any(t.device != signal.device for t in packed[:4]):
        raise ValueError("log_mel: mel_basis must be on the signal's device")
    T = 1 + L // hop_length
    n_mels = packed.row_start.shape[0]
    fn = _cuda.function("stft_mel", "rvc_log_mel",
                        [ctypes.c_void_p] * 7 + [ctypes.c_int] + [ctypes.c_void_p] + [ctypes.c_int] * 6
                        + [ctypes.c_float, ctypes.c_void_p])
    win = window.contiguous()
    table = _cos_table(CUDA_FFT_SIZE, signal.device)
    out = torch.empty((B, n_mels, T), dtype=torch.float32, device=signal.device)
    rc = fn(_cuda.ptr(signal), _cuda.ptr(win), _cuda.ptr(table), _cuda.ptr(packed.row_start),
            _cuda.ptr(packed.row_off), _cuda.ptr(packed.weights), _cuda.ptr(packed.pieces),
            packed.pieces.shape[0] - 1, _cuda.ptr(out), B, L, signal.stride(0), T, hop_length, n_mels,
            ctypes.c_float(clamp), _cuda.stream_of(signal))
    _cuda.check(rc, f"log_mel (B={B}, L={L}, T={T})")
    with _cuda.COUNT_LOCK:
        LAUNCHES += 1
    return out
