"""The NSF generator's resblock bank: one upsample level's multi-receptive-field
bank, ``sum_j ResBlock1_j(x) / len(kernel_sizes)`` (counterpart of
``obs_rvc_tpu/ops/resblock.py:resblock_bank_tapdot``).

Each ResBlock1 runs, for every dilation ``d``: leaky-ReLU(0.1) → conv(k, d)
→ leaky-ReLU → conv(k, 1) → + residual. Activations are ``[B, L, C]`` (the
JAX package's layout); weights are per bank ``(W1 [S, k, C, C], b1 [S, C],
W2 [S, k, C, C], b2 [S, C])`` in ``[tap, in, out]`` order, ``S`` the number
of dilations.

:func:`resblock_bank` takes the plain PyTorch version for a tensor on the
CPU and runs the CUDA kernel (``csrc/resblock.cu``: implicit GEMMs on the
tensor cores, 3xTF32 in float32 and bf16 in bfloat16; one C call per bank,
one launch per step) for a tensor on a card; it never falls back from one to
the other. The plain version takes the dense bank params; the kernel takes
only their :func:`pack_bank` (the weights in its mma fragments' order),
which ``models/synthesizer.py:GeneratorNSF`` makes once per weight version.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Union

import torch
import torch.nn.functional as F

from obs_rvc_tpu_torch.ops import _cuda
from obs_rvc_tpu_torch.ops._mma import conv_rounded, pack_weight

LRELU_SLOPE = 0.1
#: channel counts the CUDA kernel is built for
CUDA_CHANNELS = (16, 32, 64)
CUDA_KERNEL_SIZES = (3, 7, 11)
CUDA_MAX_DILATION = 5

#: wrapper calls that launched the CUDA kernel
LAUNCHES = 0


def resblock_bank_plain(x, bank_params, kernel_sizes, dilations) -> torch.Tensor:
    """The bank as ``F.conv1d`` loops, in the order the JAX flax path computes
    it, in ``x``'s dtype, each conv rounded where the Pallas kernel rounds it
    (:func:`~obs_rvc_tpu_torch.ops._mma.conv_rounded`)."""
    xt = x.transpose(1, 2)  # [B, C, L]
    total = None
    for (w1, b1, w2, b2), k in zip(bank_params, kernel_sizes):
        a = xt
        for s, d in enumerate(dilations):
            t = F.leaky_relu(a, LRELU_SLOPE)
            t = conv_rounded(F.conv1d, t, w1[s].permute(2, 1, 0), b1[s], padding=d * (k - 1) // 2, dilation=d)
            t = F.leaky_relu(t, LRELU_SLOPE)
            t = conv_rounded(F.conv1d, t, w2[s].permute(2, 1, 0), b2[s], padding=(k - 1) // 2)
            a = a + t
        total = a if total is None else total + a
    return (total / len(kernel_sizes)).transpose(1, 2)


class PackedBank(NamedTuple):
    """A level's bank params as the CUDA kernel reads them (see
    :func:`pack_bank`), for one activation dtype."""

    dtype: torch.dtype
    device: torch.device
    C: int
    kernel_sizes: tuple
    dilations: tuple
    #: per bank and step ``(W1, b1, W2, b2)``, weights as mma fragments, biases float32
    steps: list
    #: the steps' pointers, four per step, bank-major, as the C entry point takes them
    params: ctypes.Array
    ks: ctypes.Array
    dils: ctypes.Array


def pack_bank(bank_params, kernel_sizes, dilations, dtype: torch.dtype) -> PackedBank:
    """Check a level's bank params and pack them for the kernel in the
    activation ``dtype``: each step's ``[k, C, C]`` conv weights as ``k``
    slabs of one tap's ``C`` in the order of the mma B fragments (float32
    split into TF32 hi and lo); the biases rounded to ``dtype`` as the plain
    version rounds them, and kept in float32."""
    kernel_sizes, dilations = tuple(kernel_sizes), tuple(dilations)
    if len(bank_params) != len(kernel_sizes) or not kernel_sizes or not dilations:
        raise ValueError("resblock_bank: one parameter tuple per kernel size, and at least one dilation")
    S, C = len(dilations), bank_params[0][0].shape[-1]
    if C not in CUDA_CHANNELS:
        raise NotImplementedError(f"resblock_bank: the CUDA kernel takes C in {CUDA_CHANNELS}, got {C}")
    for k in kernel_sizes:
        if k not in CUDA_KERNEL_SIZES:
            raise NotImplementedError(f"resblock_bank: kernel size {k} not built")
    for d in dilations:
        if not 1 <= d <= CUDA_MAX_DILATION:
            raise NotImplementedError(f"resblock_bank: dilation {d} outside 1..{CUDA_MAX_DILATION}")
    device = bank_params[0][0].device
    steps, ptrs = [], []
    for j, ((w1, b1, w2, b2), k) in enumerate(zip(bank_params, kernel_sizes)):
        if w1.shape != (S, k, C, C) or w2.shape != (S, k, C, C):
            raise ValueError(f"resblock_bank: bank {j} weights must be [{S}, {k}, {C}, {C}]")
        if b1.shape != (S, C) or b2.shape != (S, C):
            raise ValueError(f"resblock_bank: bank {j} biases must be [{S}, {C}]")
        if any(t.device != device for t in (w1, b1, w2, b2)):
            raise ValueError(f"resblock_bank: bank {j} weights on more than one device")
        for s in range(S):
            step = (pack_weight(w1[s], dtype), b1[s].to(dtype).float().contiguous(),
                    pack_weight(w2[s], dtype), b2[s].to(dtype).float().contiguous())
            steps.append(step)
            ptrs += [t.data_ptr() for t in step]
    return PackedBank(dtype, device, C, kernel_sizes, dilations, steps, (ctypes.c_void_p * len(ptrs))(*ptrs),
                      (ctypes.c_int * len(kernel_sizes))(*kernel_sizes), (ctypes.c_int * S)(*dilations))


def resblock_bank(x, bank_params: Union[list, PackedBank], kernel_sizes, dilations) -> torch.Tensor:
    """Fused resblock bank, ``[B, L, C] → [B, L, C]``. ``bank_params`` is the
    dense params for ``x`` on the CPU, and their :func:`pack_bank` in
    ``x.dtype`` for ``x`` on a card."""
    if x.device.type == "cpu":
        if isinstance(bank_params, PackedBank):
            raise ValueError("resblock_bank: on the CPU bank_params are the dense params, not their pack")
        return resblock_bank_plain(x, bank_params, kernel_sizes, dilations)
    if x.device.type != "cuda":
        raise ValueError(f"resblock_bank: unsupported device {x.device}")
    return _resblock_bank_cuda(x, bank_params, tuple(kernel_sizes), tuple(dilations))


def launch_info(C: int, k: int, d: int, dtype: torch.dtype) -> dict:
    """One launch's shape on the card: the positions a block owns, its
    threads, shared memory and registers, the blocks an SM holds at once,
    and the rows its first conv computes."""
    fn = _cuda.function("resblock", "rvc_resblock_launch_info", [ctypes.c_int] * 4 + [ctypes.c_void_p])
    out = (ctypes.c_int * 6)()
    _cuda.check(fn(C, k, d, 0 if dtype == torch.float32 else 1, ctypes.cast(out, ctypes.c_void_p)),
                f"resblock launch info (C={C}, k={k}, d={d})")
    return dict(zip(("tile", "threads", "smem_bytes", "blocks_per_sm", "registers", "conv1_rows"), out))


def _resblock_bank_cuda(x, packed: PackedBank, kernel_sizes, dilations) -> torch.Tensor:
    global LAUNCHES
    if x.dim() != 3 or not x.is_contiguous():
        raise ValueError("resblock_bank: x must be a contiguous [B, L, C] tensor")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"resblock_bank: unsupported dtype {x.dtype}")
    B, L, C = x.shape
    if C not in CUDA_CHANNELS:
        raise NotImplementedError(f"resblock_bank: the CUDA kernel takes C in {CUDA_CHANNELS}, got {C}")
    if not isinstance(packed, PackedBank):
        raise ValueError("resblock_bank: on a card the bank params must be packed by pack_bank")
    if packed.dtype != x.dtype or packed.C != C:
        raise ValueError("resblock_bank: the packed params do not match x's dtype or channels")
    if packed.kernel_sizes != kernel_sizes or packed.dilations != dilations:
        raise ValueError("resblock_bank: the packed params are for other kernel sizes or dilations")
    if packed.device != x.device:
        raise ValueError("resblock_bank: the packed params must be on the activation's device")
    if L < 1 or B < 1:
        raise ValueError(f"resblock_bank: empty input {tuple(x.shape)}")
    fn = _cuda.function("resblock", "rvc_resblock_bank",
                        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4
                        + [ctypes.c_void_p])
    out = torch.empty_like(x)
    acc = torch.empty((B, L, C), dtype=torch.float32, device=x.device)
    tmp = torch.empty((2, B, L, C), dtype=x.dtype, device=x.device)
    rc = fn(_cuda.ptr(x), _cuda.ptr(out), _cuda.ptr(acc), _cuda.ptr(tmp),
            ctypes.cast(packed.params, ctypes.c_void_p), len(kernel_sizes), len(dilations),
            ctypes.cast(packed.ks, ctypes.c_void_p), ctypes.cast(packed.dils, ctypes.c_void_p),
            B, L, C, 0 if x.dtype == torch.float32 else 1, _cuda.stream_of(x))
    _cuda.check(rc, f"resblock_bank (C={C}, k={kernel_sizes}, d={dilations})")
    with _cuda.COUNT_LOCK:
        LAUNCHES += 1
    return out
