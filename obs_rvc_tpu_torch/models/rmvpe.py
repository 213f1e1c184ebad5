"""RMVPE E2E pitch-salience network (counterpart of ``obs_rvc_tpu/models/rmvpe.py``).

log-mel ``[B, 128, T]`` → salience ``[B, T, 360]``, T a multiple of 32:
DeepUnet (encoder levels of ConvBlockRes + 2x2 mean pool, intermediate
levels, decoder levels with a transposed conv and skip concat) → 3-channel
3x3 conv → BiGRU (PyTorch's GRU: the (r, z, n) gate order the JAX module
keeps) → Linear → sigmoid. Module names follow the published ``E2E`` so its
state dict loads as is.

With ``RMVPEConfig.pallas_unet`` (on by default here, off in the JAX
package, see the field), the levels with at most ``pallas_unet_max_ch``
channels (the C=16 and C=32 levels at the largest feature maps) run their
ConvBlockRes chain through
:func:`~obs_rvc_tpu_torch.ops.unet_block.conv_block_res_chain` with the
BatchNorms folded, as the JAX package sends them to its Pallas kernel; the
wider levels, and every level with the switch off, run the ``ConvBlockRes``
modules' own ``conv2d`` layers (cuDNN on a card), as the JAX package runs
its flax blocks through XLA.

The network computes in its weights' dtype, as the JAX module does in its
``dtype``: the float32 mel enters the first BatchNorm, which normalises it
in float32 and returns the compute dtype
(:class:`~obs_rvc_tpu_torch.models.layers.BatchNorm2d`); the chain levels
fold theirs from the stored (bfloat16, once cast) values, as the JAX
package folds them before its Pallas kernel; the BiGRU and the output layer
run in the compute dtype, and the salience comes out in float32. (PyTorch
flattens a GRU's weights for cuDNN in float16, float32 and float64 only, so
in bfloat16 cuDNN copies them into one buffer on each call.)
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn as nn
import torch.nn.functional as F

from obs_rvc_tpu_torch.models.layers import BatchNorm2d
from obs_rvc_tpu_torch.ops.unet_block import PackedChain, conv_block_res_chain, fold_bn, pack_chain

N_MELS = 128
N_CLASS = 360


@dataclasses.dataclass(frozen=True)
class RMVPEConfig:
    en_de_layers: int = 5
    inter_layers: int = 4
    n_blocks: int = 4
    en_out_channels: int = 16
    gru_hidden: int = 256
    n_gru: int = 1
    #: the JAX package's switch: the levels of at most ``pallas_unet_max_ch`` channels through the chain kernel
    #: (its plain version on the CPU), else through the blocks' own convolutions. On by default, where the JAX
    #: default is off: there the CPU path would be Pallas interpret mode (``models/synthesizer.py``'s
    #: ``pallas_resblocks`` says why float32 was kept off the TPU's kernels)
    pallas_unet: bool = True
    pallas_unet_max_ch: int = 32

    def fused(self, ch: int) -> bool:
        """Whether a level of ``ch`` output channels runs through the chain kernel."""
        return self.pallas_unet and ch <= self.pallas_unet_max_ch


class ConvBlockRes(nn.Module):
    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.conv = nn.Sequential(
            nn.Conv2d(in_ch, out_ch, 3, padding=1, bias=False),
            nn.BatchNorm2d(out_ch),
            nn.ReLU(),
            nn.Conv2d(out_ch, out_ch, 3, padding=1, bias=False),
            nn.BatchNorm2d(out_ch),
            nn.ReLU(),
        )
        self.shortcut = nn.Conv2d(in_ch, out_ch, 1) if in_ch != out_ch else None

    def forward(self, x):  # NCHW
        y = self.conv(x)
        return y + (self.shortcut(x) if self.shortcut is not None else x)

    def folded(self) -> tuple:
        """``(W1 [3,3,Cin,C], b1, W2 [3,3,C,C], b2, Wsc [Cin,C] | None, bsc | None)``
        with both BatchNorms folded, the layout of the chain kernel."""
        out = []
        for conv, bn in ((self.conv[0], self.conv[1]), (self.conv[3], self.conv[4])):
            out.extend(fold_bn(conv.weight.permute(2, 3, 1, 0), bn.weight, bn.bias,
                               bn.running_mean, bn.running_var, bn.eps))
        if self.shortcut is not None:
            out += [self.shortcut.weight[:, :, 0, 0].T, self.shortcut.bias]
        else:
            out += [None, None]
        return tuple(None if t is None else t.contiguous() for t in out)


class _Chain(nn.ModuleList):
    """A level's ConvBlockRes blocks; through the chain kernel when ``fused``."""

    def __init__(self, in_ch: int, out_ch: int, n_blocks: int, fused: bool):
        super().__init__([ConvBlockRes(in_ch, out_ch)]
                         + [ConvBlockRes(out_ch, out_ch) for _ in range(n_blocks - 1)])
        self.fused = fused
        #: (weights' key, folded blocks, their packs by dtype), replaced as one
        #: object on a refold, so threads sharing the module never pair a
        #: pack with blocks of another weight version
        self._fold = None

    def __getstate__(self):
        # the fold is derived from the weights, and a pack holds ctypes pointers into them: a copy
        # (a mesh row's on another card, parallel/sharding.py) folds and packs its own
        return {**self.__dict__, "_fold": None}

    def _folded(self) -> tuple:
        key = tuple((p.data_ptr(), p._version) for p in self.parameters()) + tuple(
            (b.data_ptr(), b._version) for b in self.buffers()
        )
        fold = self._fold
        if fold is None or fold[0] != key:
            with torch.no_grad():
                fold = self._fold = (key, [blk.folded() for blk in self], {})
        return fold

    def _blocks(self) -> list[tuple]:
        """The folded blocks, refolded when a parameter or buffer changed
        since the last fold."""
        return self._folded()[1]

    def _packed(self, dtype: torch.dtype) -> PackedChain:
        """The folded blocks packed for the chain kernel in ``dtype``, once
        per weight version."""
        _, blocks, packs = self._folded()
        if dtype not in packs:
            with torch.no_grad():
                packs[dtype] = pack_chain(blocks, dtype)
        return packs[dtype]

    def forward(self, x):  # NCHW
        if self.fused:
            blocks = self._packed(x.dtype) if x.device.type == "cuda" else self._blocks()
            y = conv_block_res_chain(x.permute(0, 2, 3, 1).contiguous(), blocks)
            return y.permute(0, 3, 1, 2)
        for blk in self:
            x = blk(x)
        return x


class ResEncoderBlock(nn.Module):
    def __init__(self, in_ch, out_ch, pool: bool, n_blocks: int, fused: bool):
        super().__init__()
        self.conv = _Chain(in_ch, out_ch, n_blocks, fused)
        self.pool = pool

    def forward(self, x):
        x = self.conv(x)
        if self.pool:
            return x, F.avg_pool2d(x, 2)  # (skip, pooled)
        return x


class ResDecoderBlock(nn.Module):
    def __init__(self, in_ch, out_ch, n_blocks: int, fused: bool):
        super().__init__()
        self.conv1 = nn.Sequential(
            nn.ConvTranspose2d(in_ch, out_ch, 3, stride=2, padding=1, output_padding=1, bias=False),
            nn.BatchNorm2d(out_ch),
            nn.ReLU(),
        )
        self.conv2 = _Chain(out_ch * 2, out_ch, n_blocks, fused)

    def forward(self, x, skip):
        return self.conv2(torch.cat((self.conv1(x), skip), dim=1))


class _BiGRU(nn.Module):
    def __init__(self, input_size: int, hidden: int, num_layers: int):
        super().__init__()
        self.gru = nn.GRU(input_size, hidden, num_layers, batch_first=True, bidirectional=True)

    def forward(self, x):
        return self.gru(x)[0]


class RMVPE(nn.Module):
    """mel ``[B, 128, T]`` → salience ``[B, T, 360]`` (T % 32 == 0)."""

    def __init__(self, cfg: RMVPEConfig = RMVPEConfig()):
        super().__init__()
        self.cfg = cfg
        unet = nn.Module()
        encoder = nn.Module()
        encoder.bn = BatchNorm2d(1)
        encoder.layers = nn.ModuleList()
        in_ch, out_ch = 1, cfg.en_out_channels
        for _ in range(cfg.en_de_layers):
            encoder.layers.append(ResEncoderBlock(in_ch, out_ch, True, cfg.n_blocks, cfg.fused(out_ch)))
            in_ch, out_ch = out_ch, out_ch * 2
        unet.encoder = encoder
        inter = nn.Module()
        inter.layers = nn.ModuleList(
            [ResEncoderBlock(in_ch, out_ch, False, cfg.n_blocks, False)]
            + [ResEncoderBlock(out_ch, out_ch, False, cfg.n_blocks, False)
               for _ in range(cfg.inter_layers - 1)]
        )
        unet.intermediate = inter
        decoder = nn.Module()
        decoder.layers = nn.ModuleList()
        ch = out_ch
        for _ in range(cfg.en_de_layers):
            decoder.layers.append(ResDecoderBlock(ch, ch // 2, cfg.n_blocks, cfg.fused(ch // 2)))
            ch //= 2
        unet.decoder = decoder
        self.unet = unet
        self.cnn = nn.Conv2d(cfg.en_out_channels, 3, 3, padding=1)
        self.fc = nn.Sequential(
            _BiGRU(3 * N_MELS, cfg.gru_hidden, cfg.n_gru),
            nn.Linear(2 * cfg.gru_hidden, N_CLASS),
        )

    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        assert mel.shape[1] == N_MELS, f"expected [B, {N_MELS}, T], got {tuple(mel.shape)}"
        assert mel.shape[2] % 32 == 0, "RMVPE frame count must be a multiple of 32"
        x = self.unet.encoder.bn(mel.transpose(-1, -2).unsqueeze(1))  # [B, 1, T, 128]
        skips = []
        for layer in self.unet.encoder.layers:
            skip, x = layer(x)
            skips.append(skip)
        for layer in self.unet.intermediate.layers:
            x = layer(x)
        for i, layer in enumerate(self.unet.decoder.layers):
            x = layer(x, skips[-1 - i])
        x = self.cnn(x)  # [B, 3, T, 128]
        x = x.transpose(1, 2).flatten(-2)  # [B, T, 384], channel-major per frame
        return torch.sigmoid(self.fc(x)).float()
