"""CREPE (Kim et al., "CREPE: A Convolutional Representation for Pitch
Estimation", arXiv:1802.06182) as torchcrepe builds it and RVC's
``--f0method crepe`` runs it, at torchcrepe's ``full`` capacity: 1024-sample
16 kHz frames, each normalised, through six blocks of convolution → ReLU →
BatchNorm (eps 1e-3, inference mode) → max-pool 2 (channels 1 → 1024 → 128
→ 128 → 128 → 256 → 512; the first kernel 512 with stride 4, the other
five 64), flattened time-major, then a 2048 → 360 classifier and a sigmoid
over 20-cent pitch bins. Written from that description, with torchcrepe's
keys (``conv{i}`` ``Conv2d`` with ``(k, 1)`` kernels, ``conv{i}_BN``
``BatchNorm1d``, ``classifier``).

Departures from RVC WebUI's CREPE path, the served program's own:

- The window. A chunk's frames are the step's whole pitch window (10080
  samples at this geometry: 64 frames, centred at ``t * 160``), hop-aligned
  with RMVPE's mel frames so that either network fills the same pitch
  cache. RVC WebUI's real-time loop rounds its pitch window up to RMVPE's
  length for RMVPE alone (``tools/rvc_for_realtime.py``), so CREPE there
  may see fewer frames.
- The decoding. The salience-weighted mean of the cents around the peak
  on RMVPE's cents grid with a 0.03 threshold, RMVPE's decode
  (:func:`benchmark.reference.pitch.rmvpe.decode`). torchcrepe's
  ``predict`` decodes by Viterbi, and RVC adds a periodicity filter.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn as nn
import torch.nn.functional as F

from benchmark.reference.nets import FLOAT32, Precision, _conv2d, _lin
from benchmark.reference.pitch import rmvpe

PROGRAM = {"pitch_algorithm": "crepe", "config": "CrepeConfig", "pipeline_kw": "crepe_cfg"}
#: the salience head, by the key of its weight
HEADS = ("classifier.weight",)
TINY = {"capacity": "tiny"}

#: each block's output channels, by torchcrepe's capacity (the input is one channel)
CHANNELS = {
    "full": (1024, 128, 128, 128, 256, 512),
    "tiny": (128, 16, 16, 16, 32, 64),
}
KERNELS = (512, 64, 64, 64, 64, 64)
STRIDES = (4, 1, 1, 1, 1, 1)
#: each block's zero padding of its input, before and after
PADS = ((254, 254),) + ((31, 32),) * 5
FRAME, HOP, BINS = 1024, 160, 360
#: positions left after the six blocks (1024 samples → 256 → … → 4), each ``CHANNELS[-1]`` wide
POSITIONS = 4


@dataclasses.dataclass(frozen=True)
class Size:
    capacity: str = "full"


class Net(nn.Module):
    """Normalised frames ``[B, T, 1024]`` → salience ``[B, T, 360]``."""

    def __init__(self, s: Size = Size(), prec: Precision = FLOAT32):
        super().__init__()
        self.s, self.prec = s, prec
        cin = 1
        for i, (c, k, stride) in enumerate(zip(CHANNELS[s.capacity], KERNELS, STRIDES), 1):
            setattr(self, f"conv{i}", nn.Conv2d(cin, c, (k, 1), stride=(stride, 1)))
            setattr(self, f"conv{i}_BN", nn.BatchNorm1d(c, eps=1e-3))
            cin = c
        self.classifier = nn.Linear(POSITIONS * cin, BINS)

    def forward(self, frames):
        p = self.prec
        B, T, _ = frames.shape
        x = frames.float().reshape(B * T, 1, FRAME)
        for i, pad in enumerate(PADS, 1):
            x = _conv2d(p, getattr(self, f"conv{i}"), F.pad(x, pad)[..., None])[..., 0]
            bn = getattr(self, f"conv{i}_BN")
            x = F.batch_norm(F.relu(x), bn.running_mean, bn.running_var, bn.weight, bn.bias, training=False,
                             eps=bn.eps)
            x = F.max_pool1d(x, 2, 2)
        x = x.transpose(1, 2).reshape(B * T, -1)  # time-major: [N, C, 4] → [N, 4 * C]
        return torch.sigmoid(_lin(p, self.classifier, x)).reshape(B, T, BINS)


def inputs(window: torch.Tensor) -> torch.Tensor:
    """The pitch window ``[B, L]`` → ``1 + L // 160`` frames of 1024 samples
    centred at ``t * 160`` (zeros past both ends), each less its mean and
    over its unbiased standard deviation clamped at 1e-10 (a silent frame
    is 0): ``[B, T, 1024]``."""
    T = 1 + window.shape[-1] // HOP
    frames = F.pad(window.float(), (FRAME // 2, FRAME // 2)).unfold(-1, FRAME, HOP)[:, :T]
    frames = frames - frames.mean(-1, keepdim=True)
    return frames / frames.std(-1, keepdim=True).clamp(min=1e-10)


def decode(sal: torch.Tensor, threshold=0.03) -> torch.Tensor:
    """Salience ``[B, T, 360]`` → f0 Hz, as RMVPE's (same grid and threshold)."""
    return rmvpe.decode(sal, threshold)
