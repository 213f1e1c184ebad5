"""Shared layers of the port's networks (counterpart of ``obs_rvc_tpu/models/layers.py``).

The JAX package needs wrappers to reproduce PyTorch's transposed-convolution
and weight layouts; here those are PyTorch's own modules, so what remains
is the leaky-ReLU slope and the channel-first LayerNorm of VITS.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

#: HiFiGAN's leaky-ReLU slope.
LRELU_SLOPE = 0.1


class VitsLayerNorm(nn.Module):
    """VITS ``modules.LayerNorm``: normalises the channel axis of ``[B, C, T]``,
    parameters ``gamma``/``beta``, eps 1e-5."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.channels = channels
        self.eps = eps
        self.gamma = nn.Parameter(torch.ones(channels))
        self.beta = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.transpose(1, -1)
        x = F.layer_norm(x, (self.channels,), self.gamma, self.beta, self.eps)
        return x.transpose(1, -1)
