"""FCPE, torchfcpe's ``CFNaiveMelPE`` as RVC's ``--f0method fcpe`` runs it
(hidden 512, 6 conformer-conv layers, 360 bins): a Slaney log-mel (fmin 0)
through an input stack, gated depthwise-conv layers and a sigmoid head,
decoded by torchfcpe's local argmax on its linear cent grid.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from benchmark.reference.nets import FLOAT32, Precision, _conv1d, _lin
from benchmark.reference.step import log_mel

PROGRAM = {"pitch_algorithm": "fcpe", "config": "FcpeConfig", "pipeline_kw": "fcpe_cfg"}
#: the salience head, by the key of its weight
HEADS = ("output_proj.weight",)
TINY = {"n_mels": 128, "hidden": 64, "n_layers": 2, "expansion": 2, "conv_kernel": 31}


@dataclasses.dataclass(frozen=True)
class Size:
    n_mels: int = 128
    hidden: int = 512
    n_layers: int = 6
    expansion: int = 2
    conv_kernel: int = 31


class _Dw(nn.Module):
    def __init__(self, c, k):
        super().__init__()
        self.conv = nn.Conv1d(c, c, k, groups=c)


class _Conformer(nn.Module):
    def __init__(self, dim, inner, k):
        super().__init__()
        self.net = nn.Sequential(nn.LayerNorm(dim), nn.Identity(), nn.Conv1d(dim, 2 * inner, 1), nn.Identity(),
                                 _Dw(inner, k), nn.Identity(), nn.Conv1d(inner, dim, 1))


class _FcpeLayer(nn.Module):
    def __init__(self, s: Size):
        super().__init__()
        self.conformer = _Conformer(s.hidden, s.hidden * s.expansion, s.conv_kernel)


class Net(nn.Module):
    """Slaney log-mel ``[B, T, 128]`` → salience ``[B, T, 360]``."""

    def __init__(self, s: Size = Size(), prec: Precision = FLOAT32):
        super().__init__()
        self.s, self.prec = s, prec
        self.input_stack = nn.Sequential(nn.Conv1d(s.n_mels, s.hidden, 3, padding=1), nn.GroupNorm(4, s.hidden),
                                         nn.Identity(), nn.Conv1d(s.hidden, s.hidden, 3, padding=1))
        self.net = nn.Module()
        self.net.encoder_layers = nn.ModuleList(_FcpeLayer(s) for _ in range(s.n_layers))
        self.norm = nn.LayerNorm(s.hidden)
        self.output_proj = nn.Linear(s.hidden, 360)

    def forward(self, mel):
        p, st = self.prec, self.input_stack
        x = mel.float().transpose(1, 2)
        x = _conv1d(p, st[3], F.leaky_relu(st[1](_conv1d(p, st[0], x)), 0.01)).transpose(1, 2)
        inner = self.s.hidden * self.s.expansion
        for layer in self.net.encoder_layers:
            net = layer.conformer.net
            h = _conv1d(p, net[2], net[0](x).transpose(1, 2))
            h = h[:, :inner] * torch.sigmoid(h[:, inner:])
            dw = net[4].conv
            h = F.silu(_conv1d(p, dw, h, padding=dw.kernel_size[0] // 2))
            x = x + _conv1d(p, net[6], h).transpose(1, 2)
        return torch.sigmoid(_lin(p, self.output_proj, self.norm(x)))


def inputs(window: torch.Tensor) -> torch.Tensor:
    """The pitch window ``[B, L]`` → its Slaney log-mel from 0 Hz, ``[B, T, 128]``."""
    return log_mel(window, htk=False, fmin=0.0).transpose(1, 2)


def decode(sal: torch.Tensor, threshold=0.05) -> torch.Tensor:
    """torchfcpe's local-argmax decode on its linear cent grid (32.70 to 1975.5 Hz)."""
    n = sal.shape[-1]
    table = torch.linspace(1200.0 * math.log2(32.70 / 10.0), 1200.0 * math.log2(1975.5 / 10.0), n,
                           dtype=torch.float64, device=sal.device).float()
    c = torch.argmax(sal, dim=-1)
    idx = torch.clamp(c[..., None] - 4 + torch.arange(9, device=sal.device), 0, n - 1)
    w = torch.gather(sal, -1, idx)
    cents = (w * table[idx]).sum(-1) / w.sum(-1).clamp(min=1e-12)
    f0 = 10.0 * torch.exp2(cents / 1200.0)
    return torch.where(sal.amax(-1) > threshold, f0, torch.zeros_like(f0))
