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
the CPU and launches the CUDA kernel (``csrc/unet_block.cu``, one launch per
block) for a tensor on a card; it never falls back from one to the other.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from obs_rvc_tpu_torch.ops import _cuda

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


def conv_block_res_chain(x, blocks) -> torch.Tensor:
    """Fused ConvBlockRes chain, ``[B, H, W, Cin] → [B, H, W, C]``."""
    if x.device.type == "cpu":
        return conv_block_res_chain_plain(x, blocks)
    if x.device.type != "cuda":
        raise ValueError(f"conv_block_res_chain: unsupported device {x.device}")
    return _chain_cuda(x, blocks)


def _kernel_weight(w, dt):
    return None if w is None else w.to(dt).float().contiguous()


def _chain_cuda(x, blocks) -> torch.Tensor:
    global LAUNCHES
    if x.dim() != 4 or not x.is_contiguous():
        raise ValueError("conv_block_res_chain: x must be a contiguous NHWC tensor")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"conv_block_res_chain: unsupported dtype {x.dtype}")
    B, H, W, cin = x.shape
    C = blocks[0][0].shape[-1]
    if C not in CUDA_CHANNELS:
        raise NotImplementedError(f"conv_block_res_chain: the CUDA kernel takes C in {CUDA_CHANNELS}, got {C}")
    if cin > CUDA_MAX_CIN:
        raise NotImplementedError(f"conv_block_res_chain: Cin {cin} > {CUDA_MAX_CIN}")
    fn = _cuda.function("unet_block", "rvc_conv_block_res",
                        [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    dt_code = 0 if x.dtype == torch.float32 else 1
    stream = _cuda.stream_of(x)
    out = torch.empty((B, H, W, C), dtype=x.dtype, device=x.device)
    tmp = [torch.empty_like(out), torch.empty_like(out)]
    src = x
    for i, (w1, b1, w2, b2, wsc, bsc) in enumerate(blocks):
        if w1.shape != (3, 3, cin, C) or w2.shape != (3, 3, C, C):
            raise ValueError(f"conv_block_res_chain: block {i} weight shapes {tuple(w1.shape)}, {tuple(w2.shape)}")
        if b1.shape != (C,) or b2.shape != (C,):
            raise ValueError(f"conv_block_res_chain: block {i} bias shapes")
        if wsc is None and cin != C:
            raise ValueError(f"conv_block_res_chain: block {i} changes channels without a shortcut")
        if wsc is not None:
            wsc = wsc.reshape(cin, C)
            if bsc is None or bsc.shape != (C,):
                raise ValueError(f"conv_block_res_chain: block {i} shortcut bias shape")
        for t in (w1, b1, w2, b2, wsc, bsc):
            if t is not None and t.device != x.device:
                raise ValueError("conv_block_res_chain: weights must be on the activation's device")
        dst = out if i + 1 == len(blocks) else tmp[i % 2]
        w1f, b1f, w2f, b2f, wscf, bscf = (_kernel_weight(t, x.dtype) for t in (w1, b1, w2, b2, wsc, bsc))
        rc = fn(_cuda.ptr(src), _cuda.ptr(dst), _cuda.ptr(w1f), _cuda.ptr(b1f), _cuda.ptr(w2f),
                _cuda.ptr(b2f), _cuda.ptr(wscf), _cuda.ptr(bscf), B, H, W, cin, C, dt_code, stream)
        _cuda.check(rc, f"conv_block_res_chain (block {i}, {cin}->{C})")
        src, cin = dst, C
    with _cuda.COUNT_LOCK:
        LAUNCHES += 1
    return out
