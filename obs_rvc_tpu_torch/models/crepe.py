"""CREPE pitch-salience network (counterpart of ``obs_rvc_tpu/models/crepe.py``).

torchcrepe's ``Crepe``: six blocks of Conv → ReLU → BatchNorm (eps 1e-3) →
MaxPool(2) over 1024-sample 16 kHz frames, then a Linear classifier and a
sigmoid over the 360-bin, 20-cent grid RMVPE shares, so ``dsp.f0.decode_f0``
decodes both. ReLU comes before the norm, as in torchcrepe. The first conv
(kernel 512, stride 4) is padded (254, 254), the others (kernel 64) (31, 32).

Module names and weights follow torchcrepe (``conv{i}``, ``conv{i}_BN``,
``classifier``), whose checkpoints load as they are: the convolutions are
``Conv2d`` with ``(k, 1)`` kernels over ``[N, C, L, 1]``, the activations in
between ``[N, C, L]`` (1-d BatchNorm and max-pool). cuDNN runs the 2-d
form of these convolutions faster in bfloat16 than the 1-d one (conv6:
0.10 against 1.46 ms on an H100, ``scripts/torch_crepe_probe.py``).

The network computes in its weights' dtype: the frames are cast to it on
entry, and the salience comes out in float32. In bfloat16 (eval) the first
two blocks, conv through pool, run on the hand kernel
(``ops/crepe_conv.py``, ``csrc/crepe_conv.cu``) wherever its shape rule
admits them (``crepe_conv.takes_kernel``: ``full``'s conv1 and conv2,
``tiny``'s conv1), its params folded and packed once per weight version;
conv1 hands conv2 its output channels-last, blocked by 8 channels. Every
other block, and float32, stays on cuDNN. Frames are hop-aligned with
RMVPE's mel frames (hop 160, centred), so the step's pitch-cache geometry
is the same for either network.

The forward names a point before the first block, after each block and
after the classifier (``serve/metrics.py:Marks``), where the stage it runs
in records them: a stage graph's capture on a card, as CUDA events that
each replay records again, read on the timed steps as the spans
``crepe.conv1`` … ``crepe.conv6`` and ``crepe.head`` (device ms), and a
timed step on the CPU, by the host clock. Anywhere else it records nothing.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn as nn
import torch.nn.functional as F

from obs_rvc_tpu_torch.dsp.stft import frame_signal
from obs_rvc_tpu_torch.ops import crepe_conv
from obs_rvc_tpu_torch.serve.metrics import stage_marks

WINDOW_SIZE = 1024
N_CLASS = 360

_CAPACITIES = {
    # capacity: (in_channels, out_channels, flattened features)
    "full": ([1, 1024, 128, 128, 128, 256], [1024, 128, 128, 128, 256, 512], 2048),
    "tiny": ([1, 128, 16, 16, 16, 32], [128, 16, 16, 16, 32, 64], 256),
}
_KERNELS = [512] + [64] * 5
_STRIDES = [4] + [1] * 5
_PADS = [(254, 254)] + [(31, 32)] * 5


@dataclasses.dataclass(frozen=True)
class CrepeConfig:
    capacity: str = "full"


class Crepe(nn.Module):
    """Normalised frames ``[N, 1024]`` → salience ``[N, 360]``."""

    def __init__(self, cfg: CrepeConfig = CrepeConfig()):
        super().__init__()
        self.cfg = cfg
        in_ch, out_ch, self.in_features = _CAPACITIES[cfg.capacity]
        for i in range(6):
            setattr(self, f"conv{i + 1}", nn.Conv2d(in_ch[i], out_ch[i], (_KERNELS[i], 1), stride=(_STRIDES[i], 1)))
            setattr(self, f"conv{i + 1}_BN", nn.BatchNorm1d(out_ch[i], eps=1e-3))
        self.classifier = nn.Linear(self.in_features, N_CLASS)
        #: by block: (weights' key, its fold, its pack or None), replaced as one tuple on a change, so
        #: threads sharing the module never pair a pack with another weight version's fold
        self._kernel_params = {}

    def __getstate__(self):
        # a pack holds device tensors derived from the weights: a copy folds and packs its own
        return {**self.__dict__, "_kernel_params": {}}

    def _block_params(self, i: int, kind: str, device: torch.device):
        """Block ``i``'s params for the kernel's wrapper: its fold on the CPU,
        its pack on a card, made again when a parameter or buffer changed."""
        conv, bn = getattr(self, f"conv{i + 1}"), getattr(self, f"conv{i + 1}_BN")
        key = tuple((t.data_ptr(), t._version) for t in (*conv.parameters(), *bn.parameters(), *bn.buffers()))
        entry = self._kernel_params.get(i)
        if entry is None or entry[0] != key:
            entry = (key, crepe_conv.fold(conv, bn), None)
        if device.type == "cuda" and entry[2] is None:
            with torch.no_grad():
                entry = (key, entry[1], crepe_conv.pack(entry[1], kind))
        self._kernel_params[i] = entry
        return entry[2] if device.type == "cuda" else entry[1]

    def forward(self, frames: torch.Tensor) -> torch.Tensor:
        marks = stage_marks()
        if marks is not None:
            marks.mark("crepe")
        dtype = self.classifier.weight.dtype
        x = frames.to(dtype)[:, None, :]  # [N, 1, 1024]; [N, C, L], or [N, C / 8, L, 8] after the kernel
        for i in range(6):
            conv = getattr(self, f"conv{i + 1}")
            kind = crepe_conv.takes_kernel(conv, dtype, self.training, x.shape[2])
            if kind == "frames":
                x = crepe_conv.block_frames(x[:, 0].contiguous(), self._block_params(i, kind, x.device))
            elif kind == "taps":
                x = crepe_conv.block_taps(x if x.dim() == 4 else crepe_conv.to_blocked(x),
                                          self._block_params(i, kind, x.device))
            else:
                if x.dim() == 4:
                    x = crepe_conv.from_blocked(x)
                x = conv(F.pad(x, _PADS[i])[..., None])[..., 0]
                x = getattr(self, f"conv{i + 1}_BN")(F.relu(x))
                x = F.max_pool1d(x, 2, 2)
            if marks is not None:
                marks.mark(f"crepe.conv{i + 1}")
        if x.dim() == 4:
            x = crepe_conv.from_blocked(x)
        # time-major, as torchcrepe's permute(0, 2, 1, 3) and flax's NWC reshape: [N, C, H] → [N, H*C]
        x = x.transpose(1, 2).reshape(x.shape[0], -1)
        assert x.shape[-1] == self.in_features, x.shape
        out = torch.sigmoid(self.classifier(x)).float()
        if marks is not None:
            marks.mark("crepe.head")
        return out


def extract_crepe_frames(x16: torch.Tensor, num_frames: int, hop_length: int = 160) -> torch.Tensor:
    """16 kHz signal → per-frame normalised ``[num_frames, 1024]`` windows
    centred at ``t*hop`` (torchcrepe's ``preprocess``): zero-padded by 512 on
    each side, framed, mean-centred and divided by the unbiased std clamped
    at 1e-10, so a silent frame comes out 0. Streams ``[B, L]`` give
    ``[B, num_frames, 1024]``."""
    padded = F.pad(x16.float(), (WINDOW_SIZE // 2, WINDOW_SIZE // 2))
    frames = frame_signal(padded, WINDOW_SIZE, hop_length, num_frames)
    centered = frames - frames.mean(dim=-1, keepdim=True)
    var = (centered * centered).sum(dim=-1, keepdim=True) / (WINDOW_SIZE - 1)
    return centered / torch.clamp(torch.sqrt(var), min=1e-10)
