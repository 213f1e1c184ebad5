"""Host-side packing for the port's tensor-core kernels (``csrc/mma.cuh``):
a weight in the order of the ``mma.sync.m16n8k8`` B fragments, float32 split
into TF32 ``hi`` and ``lo`` for 3xTF32, bfloat16 rounded. Both
``ops/unet_block.py:pack_chain`` and ``ops/resblock.py:pack_bank`` use it,
once per weight version. Also the products of their plain versions, which
round where the kernels round (:func:`conv_rounded`).
"""

from __future__ import annotations

import torch


def tf32_split(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``(hi, lo)`` with ``hi`` the float32 ``w`` rounded to TF32 (10-bit
    mantissa, to nearest, ties away from zero, as ``cvt.rna.tf32.f32``) and
    ``lo = w - hi`` exactly, so ``hi + lo == w``."""
    bits = w.float().contiguous().view(torch.int32)
    hi = ((bits + 0x1000) & -0x2000).view(torch.float32)
    return hi, w.float() - hi


def pack_weight(w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """A weight ``[K, C]``, or ``[G, K, C]`` for G slabs of K one after the
    other (the chain's warp groups split a 3x3 conv's K by the taps' row:
    ``[3, 3 * Cin, C]``, ``k = dw * Cin + ci``; the bank walks a ``[k, C, C]``
    conv one tap's ``C`` at a time), in the order of the
    ``mma.m16n8k8`` B fragments, each slab's K padded to a multiple of 8
    with zeros: ``[G * Kp/8, C/8, 32 lanes, ...]``, lane ``4 g + t`` holding
    column ``g`` of the n8 tile at rows ``t, t + 4`` of the k8 step as
    ``(hi, hi, lo, lo)`` float32 (``dtype`` float32, 3xTF32), or at rows
    ``2t, 2t + 1`` as two bfloat16 (``dtype`` bfloat16)."""
    w = w.float().reshape(-1, *w.shape[-2:])
    G, K, C = w.shape
    kp = -(-K // 8) * 8
    w = torch.cat([w, w.new_zeros((G, kp - K, C))], dim=1).reshape(G * kp, C)
    nk = G * kp // 8
    if dtype == torch.float32:
        hi, lo = (a.reshape(nk, 2, 4, C // 8, 8).permute(0, 3, 4, 2, 1).reshape(nk, C // 8, 32, 2)
                  for a in tf32_split(w))
        return torch.cat([hi, lo], dim=-1).contiguous()
    return w.to(dtype).reshape(nk, 4, 2, C // 8, 8).permute(0, 3, 4, 1, 2).reshape(nk, C // 8, 32, 2).contiguous()


def conv_rounded(conv, x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, **kw) -> torch.Tensor:
    """``conv(x, w) + b`` in ``x``'s dtype as the Pallas kernels compute it:
    the weights rounded to that dtype, products and sums in float32, the sum
    rounded to the dtype, then the bias (also rounded) added in the dtype.
    In float32 that is ``conv(x, w, b)``."""
    dt = x.dtype
    w, b = w.to(dt), b.to(dt)
    if dt == torch.float32:
        return conv(x, w, b, **kw)
    y = conv(x.float(), w.float(), **kw).to(dt)
    return y + b.reshape(-1, *(1,) * (y.dim() - 2))
