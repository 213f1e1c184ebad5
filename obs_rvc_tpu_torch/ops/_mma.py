"""Host-side packing for the tensor-core kernels (``csrc/mma.cuh``): a
conv weight in the order of the ``mma.sync`` B fragments, ``m16n8k8``
float32 (split into TF32 hi and lo in the kernel) or ``m16n8k16`` bfloat16,
which ``ops/unet_block.py:pack_chain`` and ``ops/resblock.py:pack_bank``
make once per weight version. Also the products of the chain's and the
bank's plain versions, which round where the kernels round
(:func:`conv_rounded`).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def k_step(dtype: torch.dtype) -> int:
    """Channels one mma K step takes: 16 bf16 (m16n8k16), 8 TF32 (m16n8k8)."""
    return 8 if dtype == torch.float32 else 16


def pack_taps(w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """A conv weight ``[taps, Cin, C]`` (the chain's ``[3, 3, Cin, C]``
    flattened to 9 taps, a 1x1 one as 1; a bank conv's ``[k, C, C]``) in the
    order of the kernels' B fragments: Cin padded with zeros to a multiple
    of :func:`k_step` ``ks``, K = tap * Cinp + ci, ``[taps * Cinp / ks, C /
    8, 32 lanes, ...]``, lane ``4 g + t`` holding column ``g`` of the n8
    tile as two float32 at rows ``t, t + 4`` of the k8 step (``dtype``
    float32; the kernel splits them into TF32 hi and lo) or four bfloat16 at
    rows ``2t, 2t + 1, 2t + 8, 2t + 9`` of the k16 step (``dtype``
    bfloat16). A tap's fragments are one slab of ``Cinp / ks`` K steps."""
    taps, cin, C = w.shape
    ks = k_step(dtype)
    cinp = -(-cin // ks) * ks
    w = F.pad(w.float(), (0, 0, 0, cinp - cin)).reshape(taps * cinp, C)
    nk = taps * cinp // ks
    if dtype == torch.float32:  # k = 4 i + t
        return w.reshape(nk, 2, 4, C // 8, 8).permute(0, 3, 4, 2, 1).reshape(nk, C // 8, 32, 2).contiguous()
    # k = 8 h + 2 t + i: the lane's registers (h = 0, i = 0, 1) and (h = 1, i = 0, 1)
    return w.to(dtype).reshape(nk, 2, 4, 2, C // 8, 8).permute(0, 4, 5, 2, 1, 3).reshape(
        nk, C // 8, 32, 4).contiguous()


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
