"""A cumulative sum that gives the same bits at every call on a card.

``torch.cumsum`` over a tensor whose every other axis has size 1 (one
stream's ``[1, L]``) hands the scan to CUB's device-wide scan, whose tiles
take their prefix from whichever tiles before them have finished: the order
of the float32 sums, and so the last bits, can change from call to call. A
scan over more than one row goes row by row in PyTorch's own kernel, in a
fixed order. So on a card a one-row scan is run as two equal rows and the
first kept: the same bits at every call, and the same as that stream's row
in a batched scan. On the CPU the scan is sequential already.
"""

from __future__ import annotations

import torch


def cumsum_rows(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``torch.cumsum(x, dim)``, bit for bit repeatable on a card."""
    if x.device.type != "cuda" or x.numel() != x.shape[dim]:
        return torch.cumsum(x, dim=dim)
    return torch.cumsum(x.expand(2, *x.shape), dim=dim % x.dim() + 1)[0]
