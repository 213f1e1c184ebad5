"""One RMVPE U-Net level's ConvBlockRes chain (counterpart of
``obs_rvc_tpu/ops/unet_block.py:conv_block_res_chain``).

Each block: 3x3 conv + folded BatchNorm → ReLU → 3x3 conv + folded BN →
ReLU → + shortcut, the shortcut a 1x1 conv with bias on a channel-changing
first block and the identity otherwise; zero SAME padding. Activations are
NHWC ``[B, H, W, Cin] → [B, H, W, C]`` (the JAX package's layout); weights
per block ``(W1 [3, 3, Cin_b, C], b1 [C], W2 [3, 3, C, C], b2 [C], Wsc
[Cin_b, C] or None, bsc [C] or None)`` with BN already folded by
:func:`fold_bn`.

:func:`conv_block_res_chain` takes the plain PyTorch version for a tensor on
the CPU and runs the CUDA kernel (``csrc/unet_block.cu``: implicit GEMMs on
the tensor cores, 3xTF32 in float32 and bf16 in bfloat16; one C call per
level, two launches per block) for a tensor on a card; it never falls back
from one to the other. The plain version takes the folded blocks; the kernel
takes only their :func:`pack_chain` (the weights in its mma fragments'
order, float32 ones split into TF32 hi and lo on the host), which
``models/rmvpe.py:_Chain`` makes once per weight version.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Union

import torch
import torch.nn.functional as F

from obs_rvc_tpu_torch.ops import _cuda
from obs_rvc_tpu_torch.ops._mma import pack_weight

#: output channel counts the CUDA kernel is built for
CUDA_CHANNELS = (16, 32)
CUDA_MAX_CIN = 64

#: wrapper calls that launched the CUDA kernel
LAUNCHES = 0


def fold_bn(kernel, scale, bias, mean, var, eps: float = 1e-5):
    """Fold an inference-mode BatchNorm into the preceding bias-free conv with
    the output channel last: ``W' = W * s``, ``b' = bias - mean * s``,
    ``s = scale / sqrt(var + eps)``."""
    s = scale / torch.sqrt(var + eps)
    return kernel * s, bias - mean * s


def conv_block_res_chain_plain(x, blocks) -> torch.Tensor:
    """The chain as ``F.conv2d`` calls on the folded weights."""
    dt = x.dtype
    h = x.permute(0, 3, 1, 2)  # NCHW
    for w1, b1, w2, b2, wsc, bsc in blocks:
        y = F.relu(F.conv2d(h, w1.permute(3, 2, 0, 1).to(dt), b1.to(dt), padding=1))
        y = F.relu(F.conv2d(y, w2.permute(3, 2, 0, 1).to(dt), b2.to(dt), padding=1))
        if wsc is not None:
            cin, c = wsc.shape[-2:]
            h = F.conv2d(h, wsc.reshape(cin, c).T[:, :, None, None].to(dt), bsc.to(dt))
        h = h + y
    return h.permute(0, 2, 3, 1)


class PackedChain(NamedTuple):
    """A level's folded weights as the CUDA kernel reads them (see
    :func:`pack_chain`), for one activation dtype."""

    dtype: torch.dtype
    device: torch.device
    C: int
    cin: int
    #: per block ``(W1, b1, W2, b2, Wsc | None, bsc | None)``, weights as mma fragments
    blocks: list
    #: the blocks' pointers, six per block, as the C entry point takes them
    params: ctypes.Array


def pack_chain(blocks, dtype: torch.dtype) -> PackedChain:
    """Check a level's folded blocks and pack them for the kernel in the
    activation ``dtype``; the biases are rounded to ``dtype`` as the plain
    version rounds them, and kept in float32."""
    C = blocks[0][0].shape[-1]
    cin = cin0 = blocks[0][0].shape[2]
    out, ptrs = [], []
    for i, (w1, b1, w2, b2, wsc, bsc) in enumerate(blocks):
        if w1.shape != (3, 3, cin, C) or w2.shape != (3, 3, C, C):
            raise ValueError(f"conv_block_res_chain: block {i} weight shapes {tuple(w1.shape)}, {tuple(w2.shape)}")
        if b1.shape != (C,) or b2.shape != (C,):
            raise ValueError(f"conv_block_res_chain: block {i} bias shapes")
        if wsc is None and cin != C:
            raise ValueError(f"conv_block_res_chain: block {i} changes channels without a shortcut")
        if wsc is not None and (bsc is None or bsc.shape != (C,)):
            raise ValueError(f"conv_block_res_chain: block {i} shortcut bias shape")
        if any(t is not None and t.device != blocks[0][0].device for t in (w1, b1, w2, b2, wsc, bsc)):
            raise ValueError(f"conv_block_res_chain: block {i} weights on more than one device")
        packed = (pack_weight(w1.reshape(3, 3 * cin, C), dtype), _kernel_weight(b1, dtype),
                  pack_weight(w2.reshape(3, 3 * C, C), dtype), _kernel_weight(b2, dtype),
                  None if wsc is None else pack_weight(wsc.reshape(cin, C), dtype),
                  None if wsc is None else _kernel_weight(bsc, dtype))
        out.append(packed)
        ptrs += [0 if t is None else t.data_ptr() for t in packed]
        cin = C
    return PackedChain(dtype, blocks[0][0].device, C, cin0, out, (ctypes.c_void_p * len(ptrs))(*ptrs))


def conv_block_res_chain(x, blocks: Union[list, PackedChain]) -> torch.Tensor:
    """Fused ConvBlockRes chain, ``[B, H, W, Cin] → [B, H, W, C]``.
    ``blocks`` is the folded blocks for ``x`` on the CPU, and their
    :func:`pack_chain` in ``x.dtype`` for ``x`` on a card."""
    if x.device.type == "cpu":
        if isinstance(blocks, PackedChain):
            raise ValueError("conv_block_res_chain: on the CPU blocks are the folded blocks, not their pack")
        return conv_block_res_chain_plain(x, blocks)
    if x.device.type != "cuda":
        raise ValueError(f"conv_block_res_chain: unsupported device {x.device}")
    return _chain_cuda(x, blocks)


def _kernel_weight(w, dt):
    return None if w is None else w.to(dt).float().contiguous()


def _chain_cuda(x, packed: PackedChain) -> torch.Tensor:
    global LAUNCHES
    if x.dim() != 4 or not x.is_contiguous():
        raise ValueError("conv_block_res_chain: x must be a contiguous NHWC tensor")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"conv_block_res_chain: unsupported dtype {x.dtype}")
    if not isinstance(packed, PackedChain):
        raise ValueError("conv_block_res_chain: on a card the blocks must be packed by pack_chain")
    B, H, W, cin = x.shape
    C = packed.C
    if C not in CUDA_CHANNELS:
        raise NotImplementedError(f"conv_block_res_chain: the CUDA kernel takes C in {CUDA_CHANNELS}, got {C}")
    if cin > CUDA_MAX_CIN:
        raise NotImplementedError(f"conv_block_res_chain: Cin {cin} > {CUDA_MAX_CIN}")
    if packed.dtype != x.dtype or packed.cin != cin:
        raise ValueError("conv_block_res_chain: the packed weights do not match x's dtype or channels")
    if packed.device != x.device:
        raise ValueError("conv_block_res_chain: weights must be on the activation's device")
    fn = _cuda.function("unet_block", "rvc_conv_block_res_chain",
                        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_void_p])
    out = torch.empty((B, H, W, C), dtype=x.dtype, device=x.device)
    scratch = torch.empty((3, B, H, W, C), dtype=x.dtype, device=x.device)
    rc = fn(_cuda.ptr(x), _cuda.ptr(out), _cuda.ptr(scratch), ctypes.cast(packed.params, ctypes.c_void_p),
            len(packed.blocks), B, H, W, cin, C, 0 if x.dtype == torch.float32 else 1, _cuda.stream_of(x))
    _cuda.check(rc, f"conv_block_res_chain ({cin}->{C}, {len(packed.blocks)} blocks)")
    with _cuda.COUNT_LOCK:
        LAUNCHES += 1
    return out
