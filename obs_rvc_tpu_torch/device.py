"""Where the port's entry points put their tensors."""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """``None`` means the card; with no card that is an error, never a silent
    move to the CPU (pass ``device="cpu"`` for that)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass device='cpu' to run on the CPU")
        return torch.device("cuda")
    return torch.device(device)
