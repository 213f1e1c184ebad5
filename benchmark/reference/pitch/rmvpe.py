"""RMVPE, the ``E2E`` model of arXiv:2306.15412 that RVC ships as
``rmvpe.pt``: an HTK log-mel (fmin 30 Hz) through a U-Net of residual conv
blocks, a BiGRU and a sigmoid over 360 pitch bins of 20 cents, decoded by
the salience-weighted mean of the cents around the peak.

Departure from upstream, the served program's own: the BiGRU is written out
gate by gate, in PyTorch's (r, z, n) order.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from benchmark.reference.nets import FLOAT32, Precision, _conv2d, _lin
from benchmark.reference.step import log_mel

PROGRAM = {"pitch_algorithm": "rmvpe", "config": "RMVPEConfig", "pipeline_kw": "rmvpe_cfg"}
#: the salience head, by the key of its weight
HEADS = ("fc.1.weight",)
TINY = {"en_de_layers": 3, "inter_layers": 1, "n_blocks": 2, "en_out_channels": 8, "gru_hidden": 32,
        "pallas_unet_max_ch": 32}


@dataclasses.dataclass(frozen=True)
class Size:
    en_de_layers: int = 5
    inter_layers: int = 4
    n_blocks: int = 4
    en_out_channels: int = 16
    gru_hidden: int = 256


class _ConvBlockRes(nn.Module):
    def __init__(self, cin, c):
        super().__init__()
        self.conv = nn.Sequential(nn.Conv2d(cin, c, 3, padding=1, bias=False), nn.BatchNorm2d(c), nn.ReLU(),
                                  nn.Conv2d(c, c, 3, padding=1, bias=False), nn.BatchNorm2d(c), nn.ReLU())
        self.shortcut = nn.Conv2d(cin, c, 1) if cin != c else None

    def run(self, p, x):
        y = F.relu(self.conv[1](_conv2d(p, self.conv[0], x)))
        y = F.relu(self.conv[4](_conv2d(p, self.conv[3], y)))
        return y + (_conv2d(p, self.shortcut, x) if self.shortcut is not None else x)


def _chain(cin, c, n):
    return nn.ModuleList([_ConvBlockRes(cin, c)] + [_ConvBlockRes(c, c) for _ in range(n - 1)])


class _Enc(nn.Module):
    def __init__(self, cin, c, n):
        super().__init__()
        self.conv = _chain(cin, c, n)


class _Dec(nn.Module):
    def __init__(self, cin, c, n):
        super().__init__()
        self.conv1 = nn.Sequential(nn.ConvTranspose2d(cin, c, 3, stride=2, padding=1, output_padding=1,
                                                      bias=False), nn.BatchNorm2d(c))
        self.conv2 = _chain(2 * c, c, n)


class _Gru(nn.Module):
    def __init__(self, n_in, hidden):
        super().__init__()
        self.gru = nn.GRU(n_in, hidden, 1, batch_first=True, bidirectional=True)


class Net(nn.Module):
    """log-mel ``[B, 128, T]`` → salience ``[B, T, 360]``."""

    def __init__(self, s: Size = Size(), prec: Precision = FLOAT32):
        super().__init__()
        self.s, self.prec = s, prec
        unet = nn.Module()
        unet.encoder = nn.Module()
        unet.encoder.bn = nn.BatchNorm2d(1)
        unet.encoder.layers = nn.ModuleList()
        cin, c = 1, s.en_out_channels
        for _ in range(s.en_de_layers):
            unet.encoder.layers.append(_Enc(cin, c, s.n_blocks))
            cin, c = c, c * 2
        unet.intermediate = nn.Module()
        unet.intermediate.layers = nn.ModuleList([_Enc(cin, c, s.n_blocks)]
                                                 + [_Enc(c, c, s.n_blocks) for _ in range(s.inter_layers - 1)])
        unet.decoder = nn.Module()
        unet.decoder.layers = nn.ModuleList()
        for _ in range(s.en_de_layers):
            unet.decoder.layers.append(_Dec(c, c // 2, s.n_blocks))
            c //= 2
        self.unet = unet
        self.cnn = nn.Conv2d(s.en_out_channels, 3, 3, padding=1)
        self.fc = nn.Sequential(_Gru(3 * 128, s.gru_hidden), nn.Linear(2 * s.gru_hidden, 360))

    def _gru_dir(self, x, suffix):
        p, g = self.prec, self.fc[0].gru
        w_ih, w_hh = getattr(g, "weight_ih_l0" + suffix), getattr(g, "weight_hh_l0" + suffix)
        b_ih, b_hh = getattr(g, "bias_ih_l0" + suffix), getattr(g, "bias_hh_l0" + suffix)
        B, T, _ = x.shape
        H = w_hh.shape[1]
        gi = F.linear(p.act(x), w_ih, b_ih)  # [B, T, 3H]
        h = x.new_zeros(B, H)
        out = [None] * T
        steps = range(T - 1, -1, -1) if suffix else range(T)
        for t in steps:
            gh = F.linear(p.act(h), w_hh, b_hh)
            r = torch.sigmoid(gi[:, t, :H] + gh[:, :H])
            z = torch.sigmoid(gi[:, t, H : 2 * H] + gh[:, H : 2 * H])
            n = torch.tanh(gi[:, t, 2 * H :] + r * gh[:, 2 * H :])
            h = (1.0 - z) * n + z * h
            out[t] = h
        return torch.stack(out, dim=1)

    def forward(self, mel):
        p = self.prec
        x = self.unet.encoder.bn(mel.float().transpose(-1, -2).unsqueeze(1))
        skips = []
        for layer in self.unet.encoder.layers:
            for blk in layer.conv:
                x = blk.run(p, x)
            skips.append(x)
            x = F.avg_pool2d(x, 2)
        for layer in self.unet.intermediate.layers:
            for blk in layer.conv:
                x = blk.run(p, x)
        for i, layer in enumerate(self.unet.decoder.layers):
            up = layer.conv1[0]
            x = F.conv_transpose2d(p.act(x), up.weight, None, stride=2, padding=1, output_padding=1)
            x = torch.cat((F.relu(layer.conv1[1](x)), skips[-1 - i]), dim=1)
            for blk in layer.conv2:
                x = blk.run(p, x)
        x = _conv2d(p, self.cnn, x).transpose(1, 2).flatten(-2)  # [B, T, 384]
        h = torch.cat([self._gru_dir(x, ""), self._gru_dir(x, "_reverse")], dim=-1)
        return torch.sigmoid(_lin(p, self.fc[1], h))


def inputs(window: torch.Tensor) -> torch.Tensor:
    """The pitch window ``[B, L]`` → its HTK log-mel from 30 Hz, ``[B, 128, T]``."""
    return log_mel(window, htk=True, fmin=30.0)


CENTS = torch.from_numpy(((np.arange(368, dtype=np.float64) - 4.0) * 20.0 + 1997.3794084376191).astype(np.float32))


def decode(sal: torch.Tensor, threshold=0.03) -> torch.Tensor:
    """Salience ``[B, T, 360]`` → f0 Hz: the salience-weighted mean of the
    cents of the 9 bins around the peak (4 bins of zeros padded each side),
    0 where the peak is not above ``threshold``."""
    padded = F.pad(sal, (4, 4))
    c = torch.argmax(padded, dim=-1).clamp(4, padded.shape[-1] - 5)
    idx = c[..., None] - 4 + torch.arange(9, device=sal.device)
    w = torch.gather(padded, -1, idx)
    cents = (w * CENTS.to(sal.device)[idx]).sum(-1) / w.sum(-1).clamp(min=1e-12)
    cents = torch.where(sal.amax(-1) > threshold, cents, torch.zeros_like(cents))
    f0 = 10.0 * torch.exp2(cents / 1200.0)
    return torch.where(f0 == 10.0, torch.zeros_like(f0), f0)
