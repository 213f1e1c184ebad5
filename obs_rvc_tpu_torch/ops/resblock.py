"""The NSF generator's resblock bank: one upsample level's multi-receptive-field
bank, ``sum_j ResBlock1_j(x) / len(kernel_sizes)`` (counterpart of
``obs_rvc_tpu/ops/resblock.py:resblock_bank_tapdot``).

Each ResBlock1 runs, for every dilation ``d``: leaky-ReLU(0.1) → conv(k, d)
→ leaky-ReLU → conv(k, 1) → + residual. Activations are ``[B, L, C]`` (the
JAX package's layout); weights are per bank ``(W1 [S, k, C, C], b1 [S, C],
W2 [S, k, C, C], b2 [S, C])`` in ``[tap, in, out]`` order, ``S`` the number
of dilations.

:func:`resblock_bank` takes the plain PyTorch version for a tensor on the
CPU and launches the CUDA kernel (``csrc/resblock.cu``) for a tensor on a
card; it never falls back from one to the other.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from obs_rvc_tpu_torch.ops import _cuda

LRELU_SLOPE = 0.1
#: channel counts the CUDA kernel is built for
CUDA_CHANNELS = (16, 32, 64)
CUDA_KERNEL_SIZES = (3, 7, 11)

#: wrapper calls that launched the CUDA kernel
LAUNCHES = 0

_MODE_STORE, _MODE_ACC_SET, _MODE_ACC_ADD, _MODE_ACC_FINAL = 0, 1, 2, 3


def resblock_bank_plain(x, bank_params, kernel_sizes, dilations) -> torch.Tensor:
    """The bank as ``F.conv1d`` loops, in the order the JAX flax path computes it."""
    dt = x.dtype
    xt = x.transpose(1, 2)  # [B, C, L]
    total = None
    for (w1, b1, w2, b2), k in zip(bank_params, kernel_sizes):
        a = xt
        for s, d in enumerate(dilations):
            t = F.leaky_relu(a, LRELU_SLOPE)
            t = F.conv1d(t, w1[s].permute(2, 1, 0).to(dt), b1[s].to(dt),
                         padding=d * (k - 1) // 2, dilation=d)
            t = F.leaky_relu(t, LRELU_SLOPE)
            t = F.conv1d(t, w2[s].permute(2, 1, 0).to(dt), b2[s].to(dt), padding=(k - 1) // 2)
            a = a + t
        total = a if total is None else total + a
    return (total / len(kernel_sizes)).transpose(1, 2)


def resblock_bank(x, bank_params, kernel_sizes, dilations) -> torch.Tensor:
    """Fused resblock bank, ``[B, L, C] → [B, L, C]``."""
    if x.device.type == "cpu":
        return resblock_bank_plain(x, bank_params, kernel_sizes, dilations)
    if x.device.type != "cuda":
        raise ValueError(f"resblock_bank: unsupported device {x.device}")
    return _resblock_bank_cuda(x, bank_params, tuple(kernel_sizes), tuple(dilations))


def _kernel_weight(w: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """f32 copy of a weight rounded to the activation type, as the plain
    version multiplies by it."""
    return w.to(dt).float().contiguous()


def _resblock_bank_cuda(x, bank_params, kernel_sizes, dilations) -> torch.Tensor:
    global LAUNCHES
    if x.dim() != 3 or not x.is_contiguous():
        raise ValueError("resblock_bank: x must be a contiguous [B, L, C] tensor")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"resblock_bank: unsupported dtype {x.dtype}")
    B, L, C = x.shape
    if C not in CUDA_CHANNELS:
        raise NotImplementedError(f"resblock_bank: the CUDA kernel takes C in {CUDA_CHANNELS}, got {C}")
    if len(bank_params) != len(kernel_sizes):
        raise ValueError("resblock_bank: one parameter tuple per kernel size")
    S = len(dilations)
    for k in kernel_sizes:
        if k not in CUDA_KERNEL_SIZES:
            raise NotImplementedError(f"resblock_bank: kernel size {k} not built")
    for d in dilations:
        if d < 1 or d > 5:
            raise NotImplementedError(f"resblock_bank: dilation {d} outside 1..5")
    fn = _cuda.function("resblock", "rvc_resblock_step",
                        [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_void_p])
    dt_code = 0 if x.dtype == torch.float32 else 1
    out = torch.empty_like(x)
    acc = torch.empty((B, L, C), dtype=torch.float32, device=x.device)
    tmp = [torch.empty_like(x), torch.empty_like(x)]
    stream = _cuda.stream_of(x)
    nbanks = len(kernel_sizes)
    for j, ((w1, b1, w2, b2), k) in enumerate(zip(bank_params, kernel_sizes)):
        if w1.shape != (S, k, C, C) or w2.shape != (S, k, C, C):
            raise ValueError(f"resblock_bank: bank {j} weights must be [{S}, {k}, {C}, {C}]")
        if b1.shape != (S, C) or b2.shape != (S, C):
            raise ValueError(f"resblock_bank: bank {j} biases must be [{S}, {C}]")
        for t in (w1, b1, w2, b2):
            if t.device != x.device:
                raise ValueError("resblock_bank: weights must be on the activation's device")
        w1f, b1f, w2f, b2f = (_kernel_weight(t, x.dtype) for t in (w1, b1, w2, b2))
        src = x
        for s, d in enumerate(dilations):
            if s + 1 < S:
                dst, mode = tmp[s % 2], _MODE_STORE
            elif j == 0:
                dst, mode = None, _MODE_ACC_SET
            elif j + 1 < nbanks:
                dst, mode = None, _MODE_ACC_ADD
            else:
                dst, mode = out, _MODE_ACC_FINAL
            rc = fn(_cuda.ptr(src), _cuda.ptr(dst), _cuda.ptr(acc),
                    _cuda.ptr(w1f[s]), _cuda.ptr(b1f[s]), _cuda.ptr(w2f[s]), _cuda.ptr(b2f[s]),
                    B, L, C, k, d, mode, dt_code, ctypes.c_float(1.0 / nbanks), stream)
            _cuda.check(rc, f"resblock_bank (k={k}, d={d})")
            src = dst
    LAUNCHES += 1
    return out
