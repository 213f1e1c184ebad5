"""ContentVec / HuBERT-base feature encoder (counterpart of
``obs_rvc_tpu/models/contentvec.py``).

16 kHz waveform ``[B, L]`` → features ``[B, T, out_dim]`` at 50 Hz with
``T = feature_frames(L)``: a 7-layer strided conv frontend (GroupNorm after
the first), LayerNorm + projection, grouped positional conv, a post-LN
transformer stack tapped at ``tap_layer``, and for v1 a final projection.
Module names follow fairseq's ``HubertModel`` so its state dict loads as is.
Attention is a plain matmul and softmax in the JAX module's order (q scaled
by ``1/sqrt(D)`` after its bias).

The network computes in its weights' dtype, as the JAX module does in its
``dtype``: the waveform is cast to it on entry, the convolutions, products,
GELUs, norms and softmax run in it (the norms as
:mod:`~obs_rvc_tpu_torch.models.layers` says), and the features come out in
float32.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from obs_rvc_tpu_torch.models.layers import GroupNorm
from obs_rvc_tpu_torch.ops import conv_rounded

#: wav2vec2-base conv frontend: (channels, kernel, stride), 320x total stride.
CONV_LAYERS: tuple[tuple[int, int, int], ...] = (
    (512, 10, 5),
    (512, 3, 2),
    (512, 3, 2),
    (512, 3, 2),
    (512, 3, 2),
    (512, 2, 2),
    (512, 2, 2),
)


def feature_frames(num_samples: int) -> int:
    """50 Hz frame count for a 16 kHz input of ``num_samples``."""
    t = num_samples
    for _, k, s in CONV_LAYERS:
        t = (t - k) // s + 1
    return t


@dataclasses.dataclass(frozen=True)
class ContentVecConfig:
    dim: int = 768
    num_layers: int = 12
    tap_layer: int = 12
    num_heads: int = 12
    ffn_dim: int = 3072
    out_dim: int = 768
    final_proj: bool = False
    conv_pos_kernel: int = 128
    conv_pos_groups: int = 16
    layer_norm_eps: float = 1e-5
    #: tanh-approximated GELU (the serving default of the JAX package);
    #: False gives fairseq's exact erf GELU
    gelu_approximate: bool = True

    @staticmethod
    def v1() -> "ContentVecConfig":
        return ContentVecConfig(num_layers=9, tap_layer=9, out_dim=256, final_proj=True)

    @staticmethod
    def v2() -> "ContentVecConfig":
        return ContentVecConfig(num_layers=12, tap_layer=12, out_dim=768, final_proj=False)


class _ConvLayer(nn.Sequential):
    """``Conv1d(bias=False)`` [→ GroupNorm] → GELU; the conv at index 0 and
    the norm at index 2, as fairseq numbers them."""

    def __init__(self, in_ch, out_ch, k, s, group_norm: bool, gelu: str, eps: float):
        mods = [nn.Conv1d(in_ch, out_ch, k, stride=s, bias=False), nn.Identity()]
        if group_norm:
            mods.append(GroupNorm(out_ch, out_ch, eps=eps, affine=True))
        mods.append(nn.GELU(approximate=gelu))
        super().__init__(*mods)


class _SelfAttention(nn.Module):
    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.q_proj = nn.Linear(dim, dim)
        self.k_proj = nn.Linear(dim, dim)
        self.v_proj = nn.Linear(dim, dim)
        self.out_proj = nn.Linear(dim, dim)
        self.heads = heads

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # [B, T, E]
        B, T, E = x.shape
        H = self.heads
        D = E // H

        def split(t):
            return t.view(B, T, H, D).transpose(1, 2)  # [B, H, T, D]

        q = split(self.q_proj(x)) / math.sqrt(D)
        k = split(self.k_proj(x))
        v = split(self.v_proj(x))
        w = torch.softmax(q @ k.transpose(-1, -2), dim=-1)
        return self.out_proj((w @ v).transpose(1, 2).reshape(B, T, E))


class _TransformerLayer(nn.Module):
    """Post-LN encoder layer (fairseq ``layer_norm_first=False``)."""

    def __init__(self, cfg: ContentVecConfig):
        super().__init__()
        self.self_attn = _SelfAttention(cfg.dim, cfg.num_heads)
        self.self_attn_layer_norm = nn.LayerNorm(cfg.dim, eps=cfg.layer_norm_eps)
        self.fc1 = nn.Linear(cfg.dim, cfg.ffn_dim)
        self.fc2 = nn.Linear(cfg.ffn_dim, cfg.dim)
        self.final_layer_norm = nn.LayerNorm(cfg.dim, eps=cfg.layer_norm_eps)
        self.gelu = "tanh" if cfg.gelu_approximate else "none"

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.self_attn_layer_norm(x + self.self_attn(x))
        h = self.fc2(F.gelu(self.fc1(x), approximate=self.gelu))
        return self.final_layer_norm(x + h)


class ContentVec(nn.Module):
    """Waveform ``[B, L]`` → features ``[B, T, out_dim]`` at 50 Hz."""

    def __init__(self, cfg: ContentVecConfig):
        super().__init__()
        self.cfg = cfg
        gelu = "tanh" if cfg.gelu_approximate else "none"
        fe = nn.Module()
        fe.conv_layers = nn.ModuleList()
        in_ch = 1
        for i, (ch, k, s) in enumerate(CONV_LAYERS):
            fe.conv_layers.append(_ConvLayer(in_ch, ch, k, s, i == 0, gelu, cfg.layer_norm_eps))
            in_ch = ch
        self.feature_extractor = fe
        self.layer_norm = nn.LayerNorm(in_ch, eps=cfg.layer_norm_eps)
        self.post_extract_proj = nn.Linear(in_ch, cfg.dim)

        enc = nn.Module()
        enc.pos_conv = nn.Sequential(
            nn.Conv1d(cfg.dim, cfg.dim, cfg.conv_pos_kernel, padding=cfg.conv_pos_kernel // 2,
                      groups=cfg.conv_pos_groups),
        )
        enc.layer_norm = nn.LayerNorm(cfg.dim, eps=cfg.layer_norm_eps)
        enc.layers = nn.ModuleList(_TransformerLayer(cfg) for _ in range(cfg.num_layers))
        self.encoder = enc
        self.final_proj = nn.Linear(cfg.dim, cfg.out_dim) if cfg.final_proj else None
        self._gelu = gelu

    def embed(self, wav: torch.Tensor) -> torch.Tensor:
        """The conv frontend, the projection and the positional conv: the
        first transformer layer's input ``[B, T, dim]`` in the compute dtype."""
        x = wav[:, None, :].to(self.post_extract_proj.weight.dtype)
        for layer in self.feature_extractor.conv_layers:
            x = layer(x)
        x = self.post_extract_proj(self.layer_norm(x.transpose(1, 2)))  # [B, T, dim]
        # PyTorch's bfloat16 grouped convolution on the CPU (oneDNN) returns wrong
        # sums at a few channels a group; float32 sums of the rounded values,
        # rounded once and the bias added after, are what flax's Conv computes
        conv = self.encoder.pos_conv[0]
        pos = conv_rounded(F.conv1d, x.transpose(1, 2), conv.weight, conv.bias, padding=conv.padding,
                           groups=conv.groups)
        if self.cfg.conv_pos_kernel % 2 == 0:
            pos = pos[:, :, :-1]
        return self.encoder.layer_norm(x + F.gelu(pos, approximate=self._gelu).transpose(1, 2))

    def tapped_layers(self):
        """The transformer layers up to ``tap_layer``, whose last output is the features'."""
        if self.cfg.tap_layer > len(self.encoder.layers):
            raise ValueError("tap_layer exceeds num_layers")
        return self.encoder.layers[: self.cfg.tap_layer]

    def head(self, x: torch.Tensor) -> torch.Tensor:
        """The tapped layer's output → the features, in float32 (v1: through ``final_proj``)."""
        if self.final_proj is not None:
            x = self.final_proj(x)
        return x.float()

    def forward(self, wav: torch.Tensor) -> torch.Tensor:
        x = self.embed(wav)
        for layer in self.tapped_layers():
            x = layer(x)
        return self.head(x)


def extract_feature(features_50hz: torch.Tensor) -> torch.Tensor:
    """2x time upsampling 50 Hz → 100 Hz: ``[B, T, C] → [B, 2T+1, C]``, frame
    ``k`` taken from ``min(k//2, T-1)``."""
    doubled = torch.repeat_interleave(features_50hz, 2, dim=1)
    return torch.cat([doubled, features_50hz[:, -1:, :]], dim=1)
