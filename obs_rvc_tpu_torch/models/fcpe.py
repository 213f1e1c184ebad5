"""FCPE pitch-salience network and its decoder (counterpart of
``obs_rvc_tpu/models/fcpe.py``).

torchfcpe's ``CFNaiveMelPE`` as the JAX package defines it (hidden 512, 6
conformer-conv layers, 360 output bins):

- input stack: Conv1d(k3) → GroupNorm(4) → LeakyReLU(0.01) → Conv1d(k3)
- N residual conformer convolution modules: LayerNorm → pointwise conv to
  2x the width → GLU (the first half gated by the sigmoid of the second) →
  depthwise conv (k31) → SiLU → pointwise conv back
- LayerNorm → the weight-normed Linear ``output_proj`` → sigmoid

Module names follow torchfcpe (``input_stack.{0,3}``, ``input_stack.1``,
``net.encoder_layers.{i}.conformer.net.{0,2,4.conv,6}``, ``norm``,
``output_proj``), so its checkpoints load by name; ``output_proj`` holds the
folded weight ``v · g / ‖v‖`` (the norm over the input axis per output
unit), which ``models/weights.py`` and ``models/checkpoints.py`` compute.

The network computes in its weights' dtype and returns float32. The
depthwise conv goes through :func:`~obs_rvc_tpu_torch.ops.conv_rounded`:
PyTorch's bfloat16 grouped convolution on the CPU (oneDNN) gives wrong sums
at a few channels a group, and a depthwise conv has one.

Unlike RMVPE's and CREPE's, FCPE's 360 bins span a linspace cent grid
between ``F0_MIN`` and ``F0_MAX`` (~19.8 cents a bin) and its decoder clamps
the 9-bin window at the edges, so :func:`decode_f0_fcpe` is its own. Its
mel is the Slaney-scale one with fmin 0, not RMVPE's HTK scale.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from obs_rvc_tpu_torch.models.layers import GroupNorm
from obs_rvc_tpu_torch.ops import conv_rounded

N_CLASS = 360
F0_MIN = 32.70
F0_MAX = 1975.5


@dataclasses.dataclass(frozen=True)
class FcpeConfig:
    n_mels: int = 128
    hidden: int = 512
    n_layers: int = 6
    out_dims: int = N_CLASS
    expansion: int = 2
    conv_kernel: int = 31


class _DepthWiseConv1d(nn.Module):
    def __init__(self, channels: int, kernel: int):
        super().__init__()
        self.conv = nn.Conv1d(channels, channels, kernel, groups=channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pad = self.conv.kernel_size[0] // 2
        return conv_rounded(F.conv1d, x, self.conv.weight, self.conv.bias, padding=pad, groups=self.conv.groups)


class _ConformerConvModule(nn.Module):
    """``[B, T, dim]`` → ``[B, T, dim]``, the residual added by the caller.
    ``net`` keeps torchfcpe's indices; the empty slots are its Transpose,
    GLU and SiLU."""

    def __init__(self, dim: int, expansion: int, kernel: int):
        super().__init__()
        inner = dim * expansion
        self.inner = inner
        self.net = nn.Sequential(nn.LayerNorm(dim, eps=1e-5), nn.Identity(), nn.Conv1d(dim, 2 * inner, 1),
                                 nn.Identity(), _DepthWiseConv1d(inner, kernel), nn.Identity(),
                                 nn.Conv1d(inner, dim, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        net = self.net
        h = net[2](net[0](x).transpose(1, 2))  # [B, 2*inner, T]
        h = h[:, : self.inner] * torch.sigmoid(h[:, self.inner :])
        h = F.silu(net[4](h))
        return net[6](h).transpose(1, 2)


class _EncoderLayer(nn.Module):
    def __init__(self, cfg: FcpeConfig):
        super().__init__()
        self.conformer = _ConformerConvModule(cfg.hidden, cfg.expansion, cfg.conv_kernel)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.conformer(x)


class Fcpe(nn.Module):
    """Log-mel ``[B, T, n_mels]`` → salience ``[B, T, 360]`` (sigmoid); one
    stream's ``[T, n_mels]`` is the B=1 view, ``[T, 360]`` out."""

    def __init__(self, cfg: FcpeConfig = FcpeConfig()):
        super().__init__()
        self.cfg = cfg
        self.input_stack = nn.Sequential(nn.Conv1d(cfg.n_mels, cfg.hidden, 3, padding=1),
                                         GroupNorm(4, cfg.hidden, eps=1e-5), nn.Identity(),
                                         nn.Conv1d(cfg.hidden, cfg.hidden, 3, padding=1))
        self.net = nn.Module()
        self.net.encoder_layers = nn.ModuleList(_EncoderLayer(cfg) for _ in range(cfg.n_layers))
        self.norm = nn.LayerNorm(cfg.hidden, eps=1e-5)
        self.output_proj = nn.Linear(cfg.hidden, cfg.out_dims)

    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        if mel.dim() == 2:
            return self(mel[None])[0]
        st = self.input_stack
        x = mel.to(self.output_proj.weight.dtype).transpose(1, 2)  # [B, n_mels, T]
        x = st[3](F.leaky_relu(st[1](st[0](x)), 0.01)).transpose(1, 2)  # [B, T, hidden]
        for layer in self.net.encoder_layers:
            x = layer(x)
        return torch.sigmoid(self.output_proj(self.norm(x))).float()


def fcpe_cent_table(out_dims: int = N_CLASS, f0_min: float = F0_MIN, f0_max: float = F0_MAX) -> np.ndarray:
    """torchfcpe's cent grid: linspace between ``1200*log2(f/10)`` of f0_min
    and f0_max over ``out_dims`` bins, float32."""
    lo = 1200.0 * math.log2(f0_min / 10.0)
    hi = 1200.0 * math.log2(f0_max / 10.0)
    return np.linspace(lo, hi, out_dims, dtype=np.float32)


@functools.lru_cache(maxsize=4)
def _table_on(device: torch.device) -> torch.Tensor:
    return torch.from_numpy(fcpe_cent_table()).to(device)


def decode_f0_fcpe(salience: torch.Tensor, threshold: float = 0.05) -> torch.Tensor:
    """Salience ``[..., T, 360]`` → f0 Hz ``[..., T]``, torchfcpe's local-argmax decode:
    the cent table averaged over the 9 bins centred on each frame's argmax,
    the indices clamped at the edges (edge bins repeat), weighted by the
    salience, over ``max(Σw, 1e-12)``; a frame whose peak is not above
    ``threshold`` is unvoiced (0 Hz). Reads nothing back to the host."""
    n = salience.shape[-1]
    center = torch.argmax(salience, dim=-1)
    conf = torch.amax(salience, dim=-1)
    idx = torch.clamp(center[..., None] - 4 + torch.arange(9, device=salience.device), 0, n - 1)
    w = torch.gather(salience, -1, idx)
    cents = torch.sum(w * _table_on(salience.device)[idx], dim=-1) / torch.clamp(torch.sum(w, dim=-1), min=1e-12)
    f0 = 10.0 * torch.exp2(cents / 1200.0)
    return torch.where(conf > threshold, f0, torch.zeros_like(f0))
