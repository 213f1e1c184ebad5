"""RVC synthesizer, ``SynthesizerTrnMs{256,768}NSFsid`` inference graph
(counterpart of ``obs_rvc_tpu/models/synthesizer.py``).

``phone [B, T, C]`` (100 Hz features), ``pitch [B, T]`` (coarse codes),
``pitchf [B, T]`` (f0 Hz), ``sid [B]`` → waveform ``[B, T * upp]``:

1. TextEncoder: phone projection + pitch embedding → x√hidden → leaky-ReLU
   → transformer with windowed relative-position attention → (m_p, logs_p).
2. ``z_p = m_p + exp(logs_p) * rnd * 0.66666`` (``rnd`` zeros by default).
3. flow⁻¹: mean-only residual coupling layers with WaveNet hidden nets,
   applied in reverse with channel flips.
4. GeneratorNSF: sine source from f0 + transposed-conv upsampling with
   per-level source injection and ResBlock1 banks; final leaky-ReLU at
   PyTorch's default slope 0.01.

Module names follow upstream RVC so its state dicts load as is. With
``SynthesizerConfig.pallas_resblocks`` (the JAX package's switch; on by
default here, see the field), the levels with C <= 64 channels and shared
dilations run their resblock bank through
:func:`~obs_rvc_tpu_torch.ops.resblock.resblock_bank`, as the JAX package
sends C<=64 levels to its Pallas kernels, with their weights stacked (and,
on a card, packed for the kernel) once per weight version; the other levels,
and every level with the switch off, run the ``ResBlock1`` modules' own
``conv1d`` layers (cuDNN on a card), as the JAX package runs its flax
``ResBlock1`` through XLA.

The network computes in its weights' dtype, where the JAX module computes
in its ``dtype``, casting where it casts: the features at the phone
projection, the prior sample at the flow's input projections, the sine
source (float32, from the float32 f0) at the source projection and the
flow's output at ``conv_pre``; the resblock banks run in the compute dtype
and the waveform comes out in float32.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from obs_rvc_tpu_torch.dsp.scan import cumsum_rows
from obs_rvc_tpu_torch.models.layers import LRELU_SLOPE, VitsLayerNorm
from obs_rvc_tpu_torch.ops.resblock import PackedBank, pack_bank, resblock_bank

#: with ``pallas_resblocks``, the levels up to this width with shared dilations run their bank through the bank
#: kernel, as the JAX package sends them to its Pallas kernels
BANK_MAX_CH = 64


@dataclasses.dataclass(frozen=True)
class SynthesizerConfig:
    feature_dim: int = 768
    inter_channels: int = 192
    hidden_channels: int = 192
    filter_channels: int = 768
    n_heads: int = 2
    n_layers: int = 6
    kernel_size: int = 3
    attn_window: int = 10
    resblock_kernel_sizes: tuple[int, ...] = (3, 7, 11)
    resblock_dilation_sizes: tuple[tuple[int, ...], ...] = ((1, 3, 5), (1, 3, 5), (1, 3, 5))
    upsample_rates: tuple[int, ...] = (10, 10, 2, 2)
    upsample_kernel_sizes: tuple[int, ...] = (16, 16, 4, 4)
    upsample_initial_channel: int = 512
    spk_embed_dim: int = 109
    gin_channels: int = 256
    sample_rate: int = 40000
    flow_layers: int = 3
    flow_flows: int = 4
    flow_kernel: int = 5
    temperature: float = 0.66666
    #: the JAX package's switch: the C <= 64 levels' banks through the bank kernel (its plain version on the
    #: CPU), else through the ResBlock1 modules' own convolutions. On by default, where the JAX default is off:
    #: there the CPU path would be Pallas interpret mode, and Mosaic's VMEM budget kept float32 off its kernels
    pallas_resblocks: bool = True

    @property
    def upp(self) -> int:
        return math.prod(self.upsample_rates)

    @staticmethod
    def for_sample_rate(sr: int, feature_dim: int = 768) -> "SynthesizerConfig":
        """Standard RVC generator geometries per target rate."""
        if sr == 32000:
            rates, kernels = (10, 8, 2, 2), (20, 16, 4, 4)
        elif sr == 40000:
            rates, kernels = (10, 10, 2, 2), (16, 16, 4, 4)
        elif sr == 48000:
            rates, kernels = (12, 10, 2, 2), (24, 20, 4, 4)
        else:
            raise ValueError(f"unsupported model sample rate {sr}")
        return SynthesizerConfig(feature_dim=feature_dim, upsample_rates=rates,
                                 upsample_kernel_sizes=kernels, sample_rate=sr)


# ---------------------------------------------------------------------------
# TextEncoder
# ---------------------------------------------------------------------------


class RelPosAttention(nn.Module):
    """VITS ``attentions.MultiHeadAttention`` with a relative-position window."""

    def __init__(self, channels: int, n_heads: int, window_size: int):
        super().__init__()
        self.n_heads = n_heads
        self.k_channels = channels // n_heads
        self.window_size = window_size
        self.conv_q = nn.Conv1d(channels, channels, 1)
        self.conv_k = nn.Conv1d(channels, channels, 1)
        self.conv_v = nn.Conv1d(channels, channels, 1)
        self.conv_o = nn.Conv1d(channels, channels, 1)
        self.emb_rel_k = nn.Parameter(torch.zeros(1, 2 * window_size + 1, self.k_channels))
        self.emb_rel_v = nn.Parameter(torch.zeros(1, 2 * window_size + 1, self.k_channels))

    def _relative_embeddings(self, emb, length):
        pad_length = max(length - (self.window_size + 1), 0)
        start = max((self.window_size + 1) - length, 0)
        if pad_length > 0:
            emb = F.pad(emb, (0, 0, pad_length, pad_length))
        return emb[:, start : start + 2 * length - 1]

    @staticmethod
    def _relative_to_absolute(x):
        b, h, l, _ = x.shape
        x = F.pad(x, (0, 1)).reshape(b, h, l * 2 * l)
        x = F.pad(x, (0, l - 1)).reshape(b, h, l + 1, 2 * l - 1)
        return x[:, :, :l, l - 1 :]

    @staticmethod
    def _absolute_to_relative(x):
        b, h, l, _ = x.shape
        x = F.pad(x, (0, l - 1)).reshape(b, h, l * (2 * l - 1))
        x = F.pad(x, (l, 0)).reshape(b, h, l, 2 * l)
        return x[:, :, :, 1:]

    def forward(self, x):  # [B, C, T]
        b, c, t = x.shape
        H, D = self.n_heads, self.k_channels

        def split(tensor):
            return tensor.reshape(b, H, D, t).transpose(2, 3)  # [B, H, T, D]

        q = split(self.conv_q(x)) / math.sqrt(D)
        k, v = split(self.conv_k(x)), split(self.conv_v(x))
        scores = q @ k.transpose(-2, -1)
        rel_k = self._relative_embeddings(self.emb_rel_k, t)
        scores = scores + self._relative_to_absolute(q @ rel_k.unsqueeze(0).transpose(-2, -1))
        p = torch.softmax(scores, dim=-1)
        out = p @ v
        rel_v = self._relative_embeddings(self.emb_rel_v, t)
        out = out + self._absolute_to_relative(p) @ rel_v.unsqueeze(0)
        return self.conv_o(out.transpose(2, 3).reshape(b, c, t))


class _FFN(nn.Module):
    def __init__(self, channels, filter_channels, kernel_size):
        super().__init__()
        self.conv_1 = nn.Conv1d(channels, filter_channels, kernel_size)
        self.conv_2 = nn.Conv1d(filter_channels, channels, kernel_size)
        self.pad = ((kernel_size - 1) // 2, kernel_size // 2)

    def forward(self, x):
        x = torch.relu(self.conv_1(F.pad(x, self.pad)))
        return self.conv_2(F.pad(x, self.pad))


class TextEncoder(nn.Module):
    """features + pitch → (m_p, logs_p), each ``[B, inter, T]``."""

    def __init__(self, cfg: SynthesizerConfig):
        super().__init__()
        h = cfg.hidden_channels
        self.hidden = h
        self.emb_phone = nn.Linear(cfg.feature_dim, h)
        self.emb_pitch = nn.Embedding(256, h)
        enc = nn.Module()
        enc.attn_layers = nn.ModuleList(
            RelPosAttention(h, cfg.n_heads, cfg.attn_window) for _ in range(cfg.n_layers))
        enc.norm_layers_1 = nn.ModuleList(VitsLayerNorm(h) for _ in range(cfg.n_layers))
        enc.ffn_layers = nn.ModuleList(
            _FFN(h, cfg.filter_channels, cfg.kernel_size) for _ in range(cfg.n_layers))
        enc.norm_layers_2 = nn.ModuleList(VitsLayerNorm(h) for _ in range(cfg.n_layers))
        self.encoder = enc
        self.proj = nn.Conv1d(h, cfg.inter_channels * 2, 1)
        self.inter_channels = cfg.inter_channels

    def forward(self, phone, pitch):  # [B, T, C], [B, T]
        phone = phone.to(self.emb_phone.weight.dtype)
        x = (self.emb_phone(phone) + self.emb_pitch(pitch)) * math.sqrt(self.hidden)
        x = F.leaky_relu(x, LRELU_SLOPE).transpose(1, 2)  # [B, C, T]
        enc = self.encoder
        for attn, n1, ffn, n2 in zip(enc.attn_layers, enc.norm_layers_1, enc.ffn_layers,
                                     enc.norm_layers_2):
            x = n1(x + attn(x))
            x = n2(x + ffn(x))
        m, logs = torch.split(self.proj(x), self.inter_channels, dim=1)
        return m, logs


# ---------------------------------------------------------------------------
# flow
# ---------------------------------------------------------------------------


class WN(nn.Module):
    """Gated dilated-conv stack (VITS ``modules.WN``) with speaker conditioning."""

    def __init__(self, hidden, kernel_size, dilation_rate, n_layers, gin):
        super().__init__()
        self.hidden = hidden
        self.n_layers = n_layers
        self.cond_layer = nn.Conv1d(gin, 2 * hidden * n_layers, 1)
        self.in_layers = nn.ModuleList()
        self.res_skip_layers = nn.ModuleList()
        for i in range(n_layers):
            dilation = dilation_rate**i
            pad = (kernel_size * dilation - dilation) // 2
            self.in_layers.append(
                nn.Conv1d(hidden, 2 * hidden, kernel_size, dilation=dilation, padding=pad))
            out_ch = 2 * hidden if i < n_layers - 1 else hidden
            self.res_skip_layers.append(nn.Conv1d(hidden, out_ch, 1))

    def forward(self, x, g):  # [B, H, T], [B, gin, 1]
        output = torch.zeros_like(x)
        g = self.cond_layer(g)
        H = self.hidden
        for i in range(self.n_layers):
            acts = self.in_layers[i](x) + g[:, i * 2 * H : (i + 1) * 2 * H, :]
            acts = torch.tanh(acts[:, :H]) * torch.sigmoid(acts[:, H:])
            res_skip = self.res_skip_layers[i](acts)
            if i < self.n_layers - 1:
                x = x + res_skip[:, :H]
                output = output + res_skip[:, H:]
            else:
                output = output + res_skip
        return output


class ResidualCouplingLayer(nn.Module):
    """Mean-only affine coupling (VITS ``modules.ResidualCouplingLayer``)."""

    def __init__(self, channels, hidden, kernel_size, dilation_rate, n_layers, gin):
        super().__init__()
        self.half = channels // 2
        self.pre = nn.Conv1d(self.half, hidden, 1)
        self.enc = WN(hidden, kernel_size, dilation_rate, n_layers, gin)
        self.post = nn.Conv1d(hidden, self.half, 1)

    def forward(self, x, g, reverse: bool):
        x0, x1 = torch.split(x, [self.half, self.half], dim=1)
        m = self.post(self.enc(self.pre(x0.to(self.pre.weight.dtype)), g))
        return torch.cat([x0, x1 - m if reverse else x1 + m], dim=1)


class _Flip(nn.Module):
    def forward(self, x):
        return torch.flip(x, [1])


class ResidualCouplingBlock(nn.Module):
    def __init__(self, cfg: SynthesizerConfig):
        super().__init__()
        self.flows = nn.ModuleList()
        for _ in range(cfg.flow_flows):
            self.flows.append(ResidualCouplingLayer(cfg.inter_channels, cfg.hidden_channels,
                                                    cfg.flow_kernel, 1, cfg.flow_layers,
                                                    cfg.gin_channels))
            self.flows.append(_Flip())

    def forward(self, x, g):
        """The inverse flow (inference direction)."""
        for f in reversed(self.flows):
            x = f(x) if isinstance(f, _Flip) else f(x, g, reverse=True)
        return x


# ---------------------------------------------------------------------------
# NSF-HiFiGAN generator
# ---------------------------------------------------------------------------


def sine_source(
    f0: torch.Tensor,
    upp: int,
    sample_rate: int,
    generator: Optional[torch.Generator] = None,
    sine_amp: float = 0.1,
    noise_std: float = 0.003,
    voiced_threshold: float = 0.0,
) -> torch.Tensor:
    """SineGen: frame-rate f0 ``[B, T]`` → harmonic source ``[B, T*upp]``.

    Phase-continuous fundamental from the cumulative phase of the
    nearest-upsampled frequency, with the wrap corrections RVC applies to
    keep the sample-rate cumsum aligned with the frame-rate one. Noise is
    drawn only when a ``generator`` is given."""
    B, T = f0.shape
    rad = (f0 / sample_rate) % 1.0
    cum_frame = cumsum_rows(rad, dim=1) * upp
    size = T * upp
    pos = torch.arange(size, dtype=torch.float32, device=f0.device) * float(
        torch.tensor((T - 1) / (size - 1), dtype=torch.float32))
    lo = torch.clamp(torch.floor(pos).long(), 0, T - 1)
    hi = torch.clamp(torch.ceil(pos).long(), 0, T - 1)
    frac = pos - lo.float()
    over_one = (cum_frame[:, lo] * (1 - frac) + cum_frame[:, hi] * frac) % 1.0
    rad_s = torch.repeat_interleave(rad, upp, dim=1)
    wrap = (over_one[:, 1:] - over_one[:, :-1]) < 0
    shift = F.pad(wrap.to(rad_s.dtype) * -1.0, (1, 0))
    sine = torch.sin(2.0 * math.pi * cumsum_rows(rad_s + shift, dim=1)) * sine_amp
    uv = torch.repeat_interleave((f0 > voiced_threshold).to(rad_s.dtype), upp, dim=1)
    out = sine * uv
    if generator is not None:
        noise_amp = uv * noise_std + (1.0 - uv) * (sine_amp / 3.0)
        out = out + noise_amp * torch.randn(sine.shape, generator=generator, device=f0.device)
    return out


class ResBlock1(nn.Module):
    def __init__(self, channels: int, kernel_size: int, dilations: tuple[int, ...]):
        super().__init__()
        self.kernel_size = kernel_size
        self.convs1 = nn.ModuleList(
            nn.Conv1d(channels, channels, kernel_size, dilation=d,
                      padding=(kernel_size * d - d) // 2) for d in dilations)
        self.convs2 = nn.ModuleList(
            nn.Conv1d(channels, channels, kernel_size, padding=kernel_size // 2)
            for _ in dilations)

    def forward(self, x):  # [B, C, L]
        for c1, c2 in zip(self.convs1, self.convs2):
            xt = c2(F.leaky_relu(c1(F.leaky_relu(x, LRELU_SLOPE)), LRELU_SLOPE))
            x = xt + x
        return x

    def bank_params(self) -> tuple[torch.Tensor, ...]:
        """``(W1 [S, k, C, C], b1 [S, C], W2, b2)`` in the bank kernel's
        ``[tap, in, out]`` layout."""
        return (
            torch.stack([c.weight.permute(2, 1, 0) for c in self.convs1]).contiguous(),
            torch.stack([c.bias for c in self.convs1]).contiguous(),
            torch.stack([c.weight.permute(2, 1, 0) for c in self.convs2]).contiguous(),
            torch.stack([c.bias for c in self.convs2]).contiguous(),
        )


class _SourceModule(nn.Module):
    """SourceModuleHnNSF with no harmonics: sine source → Linear(1, 1) → tanh."""

    def __init__(self, sample_rate: int):
        super().__init__()
        self.sample_rate = sample_rate
        self.l_linear = nn.Linear(1, 1)

    def forward(self, f0, upp, generator=None):  # → [B, 1, L]
        har = sine_source(f0, upp, self.sample_rate, generator)[..., None]
        return torch.tanh(self.l_linear(har.to(self.l_linear.weight.dtype))).transpose(1, 2)


class GeneratorNSF(nn.Module):
    def __init__(self, cfg: SynthesizerConfig):
        super().__init__()
        self.cfg = cfg
        self.num_kernels = len(cfg.resblock_kernel_sizes)
        self.upp = cfg.upp
        self.m_source = _SourceModule(cfg.sample_rate)
        c0 = cfg.upsample_initial_channel
        self.conv_pre = nn.Conv1d(cfg.inter_channels, c0, 7, padding=3)
        self.cond = nn.Conv1d(cfg.gin_channels, c0, 1)
        self.ups = nn.ModuleList()
        self.noise_convs = nn.ModuleList()
        self.resblocks = nn.ModuleList()
        self.shared_dilations = all(
            rd == cfg.resblock_dilation_sizes[0] for rd in cfg.resblock_dilation_sizes)
        for i, (u, k) in enumerate(zip(cfg.upsample_rates, cfg.upsample_kernel_sizes)):
            ch = c0 // (2 ** (i + 1))
            self.ups.append(nn.ConvTranspose1d(c0 // (2**i), ch, k, stride=u, padding=(k - u) // 2))
            if i + 1 < len(cfg.upsample_rates):
                stride_f0 = math.prod(cfg.upsample_rates[i + 1 :])
                self.noise_convs.append(nn.Conv1d(1, ch, kernel_size=stride_f0 * 2,
                                                  stride=stride_f0, padding=stride_f0 // 2))
            else:
                self.noise_convs.append(nn.Conv1d(1, ch, kernel_size=1))
            for rk, rd in zip(cfg.resblock_kernel_sizes, cfg.resblock_dilation_sizes):
                self.resblocks.append(ResBlock1(ch, rk, rd))
        self.conv_post = nn.Conv1d(ch, 1, 7, padding=3, bias=False)
        #: per upsample level, (its banks' weights key, their stacked params,
        #: their packs by dtype), replaced as one object when a weight changed,
        #: so threads sharing the module never pair a pack with other weights
        self._bank_cache = [None] * len(cfg.upsample_rates)

    def __getstate__(self):
        # the cache is derived from the weights, and a pack holds ctypes pointers into them: a copy
        # (a mesh row's on another card, parallel/sharding.py) stacks and packs its own
        return {**self.__dict__, "_bank_cache": [None] * len(self._bank_cache)}

    def uses_bank_kernel(self, ch: int) -> bool:
        return self.cfg.pallas_resblocks and self.shared_dilations and ch <= BANK_MAX_CH

    def _bank_level(self, i: int) -> tuple:
        banks = self.resblocks[i * self.num_kernels : (i + 1) * self.num_kernels]
        key = tuple((p.data_ptr(), p._version) for p in banks.parameters())
        level = self._bank_cache[i]
        if level is None or level[0] != key:
            with torch.no_grad():
                level = (key, [b.bank_params() for b in banks], {})
            self._bank_cache[i] = level
        return level

    def bank_params(self, i: int) -> list:
        """Level ``i``'s stacked bank params (the plain version's form),
        restacked when a parameter changed since the last call."""
        return self._bank_level(i)[1]

    def packed_bank(self, i: int, dtype: torch.dtype) -> PackedBank:
        """Level ``i``'s bank params packed for the kernel in ``dtype``, once
        per weight version."""
        _, params, packs = self._bank_level(i)
        if dtype not in packs:
            with torch.no_grad():
                packs[dtype] = pack_bank(params, self.cfg.resblock_kernel_sizes,
                                         self.cfg.resblock_dilation_sizes[0], dtype)
        return packs[dtype]

    def forward(self, x, f0, g, generator=None):  # [B, C, T], [B, T], [B, gin, 1] → [B, L]
        cfg = self.cfg
        har = self.m_source(f0, self.upp, generator)
        x = self.conv_pre(x.to(self.conv_pre.weight.dtype)) + self.cond(g)
        nk = self.num_kernels
        for i, up in enumerate(self.ups):
            x = up(F.leaky_relu(x, LRELU_SLOPE)) + self.noise_convs[i](har)
            if self.uses_bank_kernel(x.shape[1]):
                params = self.packed_bank(i, x.dtype) if x.device.type == "cuda" else self.bank_params(i)
                y = resblock_bank(x.transpose(1, 2).contiguous(), params,
                                  cfg.resblock_kernel_sizes, cfg.resblock_dilation_sizes[0])
                x = y.transpose(1, 2)
            else:
                xs = None
                for b in self.resblocks[i * nk : (i + 1) * nk]:
                    y = b(x)
                    xs = y if xs is None else xs + y
                x = xs / nk
        x = self.conv_post(F.leaky_relu(x, 0.01))
        return torch.tanh(x[:, 0, :]).float()


class Synthesizer(nn.Module):
    """``(phone, pitch, pitchf, sid[, rnd]) → audio [B, T * upp]``."""

    def __init__(self, cfg: SynthesizerConfig):
        super().__init__()
        self.cfg = cfg
        self.enc_p = TextEncoder(cfg)
        self.flow = ResidualCouplingBlock(cfg)
        self.dec = GeneratorNSF(cfg)
        self.emb_g = nn.Embedding(cfg.spk_embed_dim, cfg.gin_channels)

    def forward(self, phone, pitch, pitchf, sid, rnd=None, generator=None):
        """``phone [B, T, C]``, ``pitch [B, T]`` int, ``pitchf [B, T]``, ``sid [B]``
        int, ``rnd [B, T, inter]`` prior noise (zeros when None)."""
        g = self.emb_g(sid).unsqueeze(-1)  # [B, gin, 1]
        m_p, logs_p = self.enc_p(phone, pitch)
        z_p = m_p
        if rnd is not None:
            z_p = m_p + torch.exp(logs_p) * rnd.transpose(1, 2) * self.cfg.temperature
        z = self.flow(z_p, g)
        return self.dec(z, pitchf, g, generator)
