"""The three networks of an RVC v2 streaming step, in plain PyTorch and float32.

A frozen reference, written from the published descriptions (fairseq's
HuBERT-base as ContentVec, RMVPE's ``E2E`` of arXiv:2306.15412, torchfcpe's
``CFNaiveMelPE``, RVC's ``SynthesizerTrnMs768NSFsid``). It imports nothing
of the program under test: no kernel, no packing, no graph. Module and
parameter names follow the upstream checkpoints, so one state dict loads
into the program and into this file alike.

Every product (a linear layer, a convolution, an attention product, a GRU
gate) reads its activation through ``prec.act`` and its weight as loaded:
:class:`Precision` is float32 by default and, for the control of the
benchmark's comparison, rounds both to a lower precision
(``prec_weights`` rounds a state dict the same way before it is loaded).
Departures from upstream, each the served program's own:

- ContentVec's GELU is the tanh approximation, and its positional conv has
  a plain weight (upstream holds it weight-normed; a checkpoint folds it).
- RMVPE's BiGRU is written out gate by gate, in PyTorch's (r, z, n) order.
- The synthesizer takes no prior noise and no source noise (the streaming
  step passes neither), so its output is a function of its inputs.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F


class Precision:
    """Where the reference rounds. ``None``: nowhere (float32). ``"fp8"``:
    each product's activation and weight to float8 e4m3 with a per-tensor
    scale (the tensor's largest magnitude to 448)."""

    def __init__(self, kind: Optional[str] = None):
        if kind not in (None, "fp8"):
            raise ValueError(f"unknown precision {kind!r}")
        self.kind = kind

    def act(self, x: torch.Tensor) -> torch.Tensor:
        if self.kind is None or not x.is_floating_point():
            return x
        scale = x.abs().amax().clamp(min=1e-30) / 448.0
        return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


FLOAT32 = Precision()


def prec_weights(sd: dict, prec: Precision) -> dict:
    """A state dict with every weight of a product rounded by ``prec`` (norms'
    scales and shifts, biases and running statistics are left alone)."""
    if prec.kind is None:
        return sd
    out = {}
    for k, v in sd.items():
        leaf = k.rsplit(".", 1)[-1]
        product = v.is_floating_point() and v.dim() >= 2 or leaf.startswith(("weight_ih", "weight_hh"))
        out[k] = prec.act(v) if product and leaf not in ("running_mean", "running_var") else v
    return out


def _lin(prec, m: nn.Linear, x):
    return F.linear(prec.act(x), m.weight, m.bias)


def _conv1d(prec, m: nn.Conv1d, x, **kw):
    kw = {"stride": m.stride, "padding": m.padding, "dilation": m.dilation, "groups": m.groups, **kw}
    return F.conv1d(prec.act(x), m.weight, m.bias, **kw)


def _conv2d(prec, m: nn.Conv2d, x):
    return F.conv2d(prec.act(x), m.weight, m.bias, stride=m.stride, padding=m.padding)


def _mm(prec, a, b):
    return prec.act(a) @ prec.act(b)


# ---------------------------------------------------------------------------
# ContentVec (HuBERT base, v2: 768 wide, 12 layers, the 12th tapped)
# ---------------------------------------------------------------------------

CONV_LAYERS = ((512, 10, 5),) + ((512, 3, 2),) * 4 + ((512, 2, 2),) * 2


def feature_frames(num_samples: int) -> int:
    t = num_samples
    for _, k, s in CONV_LAYERS:
        t = (t - k) // s + 1
    return t


@dataclasses.dataclass(frozen=True)
class ContentVecSize:
    dim: int = 768
    num_layers: int = 12
    num_heads: int = 12
    ffn_dim: int = 3072
    conv_pos_kernel: int = 128
    conv_pos_groups: int = 16


class _Attn(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.q_proj, self.k_proj, self.v_proj, self.out_proj = (nn.Linear(dim, dim) for _ in range(4))


class _Layer(nn.Module):
    def __init__(self, s: ContentVecSize):
        super().__init__()
        self.self_attn = _Attn(s.dim)
        self.self_attn_layer_norm = nn.LayerNorm(s.dim)
        self.fc1 = nn.Linear(s.dim, s.ffn_dim)
        self.fc2 = nn.Linear(s.ffn_dim, s.dim)
        self.final_layer_norm = nn.LayerNorm(s.dim)


class ContentVec(nn.Module):
    """16 kHz waveform ``[B, L]`` → features ``[B, T, dim]`` at 50 Hz."""

    def __init__(self, s: ContentVecSize = ContentVecSize(), prec: Precision = FLOAT32):
        super().__init__()
        self.s, self.prec = s, prec
        fe = nn.Module()
        fe.conv_layers = nn.ModuleList()
        cin = 1
        for i, (ch, k, st) in enumerate(CONV_LAYERS):
            mods = [nn.Conv1d(cin, ch, k, stride=st, bias=False), nn.Identity()]
            if i == 0:
                mods.append(nn.GroupNorm(ch, ch))
            fe.conv_layers.append(nn.Sequential(*mods))
            cin = ch
        self.feature_extractor = fe
        self.layer_norm = nn.LayerNorm(cin)
        self.post_extract_proj = nn.Linear(cin, s.dim)
        enc = nn.Module()
        enc.pos_conv = nn.Sequential(nn.Conv1d(s.dim, s.dim, s.conv_pos_kernel, padding=s.conv_pos_kernel // 2,
                                               groups=s.conv_pos_groups))
        enc.layer_norm = nn.LayerNorm(s.dim)
        enc.layers = nn.ModuleList(_Layer(s) for _ in range(s.num_layers))
        self.encoder = enc

    def forward(self, wav):
        p, s = self.prec, self.s
        x = wav[:, None, :].float()
        for i, layer in enumerate(self.feature_extractor.conv_layers):
            x = _conv1d(p, layer[0], x)
            if i == 0:
                x = layer[2](x)
            x = F.gelu(x, approximate="tanh")
        x = _lin(p, self.post_extract_proj, self.layer_norm(x.transpose(1, 2)))
        pos = _conv1d(p, self.encoder.pos_conv[0], x.transpose(1, 2))
        if s.conv_pos_kernel % 2 == 0:
            pos = pos[:, :, :-1]
        x = self.encoder.layer_norm(x + F.gelu(pos, approximate="tanh").transpose(1, 2))
        B, T, E = x.shape
        H, D = s.num_heads, E // s.num_heads
        for layer in self.encoder.layers:
            a = layer.self_attn

            def split(t):
                return t.view(B, T, H, D).transpose(1, 2)

            q = split(_lin(p, a.q_proj, x)) / math.sqrt(D)
            k, v = split(_lin(p, a.k_proj, x)), split(_lin(p, a.v_proj, x))
            w = torch.softmax(_mm(p, q, k.transpose(-1, -2)), dim=-1)
            att = _lin(p, a.out_proj, _mm(p, w, v).transpose(1, 2).reshape(B, T, E))
            x = layer.self_attn_layer_norm(x + att)
            h = _lin(p, layer.fc2, F.gelu(_lin(p, layer.fc1, x), approximate="tanh"))
            x = layer.final_layer_norm(x + h)
        return x


# ---------------------------------------------------------------------------
# RMVPE
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class RmvpeSize:
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


class Rmvpe(nn.Module):
    """log-mel ``[B, 128, T]`` → salience ``[B, T, 360]``."""

    def __init__(self, s: RmvpeSize = RmvpeSize(), prec: Precision = FLOAT32):
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


# ---------------------------------------------------------------------------
# FCPE (torchfcpe CFNaiveMelPE: hidden 512, 6 layers)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class FcpeSize:
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
    def __init__(self, s: FcpeSize):
        super().__init__()
        self.conformer = _Conformer(s.hidden, s.hidden * s.expansion, s.conv_kernel)


class Fcpe(nn.Module):
    """Slaney log-mel ``[B, T, 128]`` → salience ``[B, T, 360]``."""

    def __init__(self, s: FcpeSize = FcpeSize(), prec: Precision = FLOAT32):
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


# ---------------------------------------------------------------------------
# the synthesizer (SynthesizerTrnMs768NSFsid)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SynthSize:
    feature_dim: int = 768
    inter_channels: int = 192
    hidden_channels: int = 192
    filter_channels: int = 768
    n_heads: int = 2
    n_layers: int = 6
    kernel_size: int = 3
    attn_window: int = 10
    resblock_kernel_sizes: tuple = (3, 7, 11)
    resblock_dilation_sizes: tuple = ((1, 3, 5), (1, 3, 5), (1, 3, 5))
    upsample_rates: tuple = (10, 10, 2, 2)
    upsample_kernel_sizes: tuple = (16, 16, 4, 4)
    upsample_initial_channel: int = 512
    spk_embed_dim: int = 109
    gin_channels: int = 256
    sample_rate: int = 40000
    flow_layers: int = 3
    flow_flows: int = 4
    flow_kernel: int = 5


def _embedding(n: int, dim: int) -> nn.Embedding:
    """An embedding whose weight is left to the state dict (its own random
    init, on the meta device, would pull in the compiler's machinery)."""
    return nn.Embedding(n, dim, _weight=torch.empty(n, dim))


class _RelAttn(nn.Module):
    def __init__(self, c, heads, window):
        super().__init__()
        self.conv_q, self.conv_k, self.conv_v, self.conv_o = (nn.Conv1d(c, c, 1) for _ in range(4))
        self.emb_rel_k = nn.Parameter(torch.zeros(1, 2 * window + 1, c // heads))
        self.emb_rel_v = nn.Parameter(torch.zeros(1, 2 * window + 1, c // heads))
        self.heads, self.window = heads, window

    def _rel(self, emb, length):
        pad = max(length - (self.window + 1), 0)
        start = max((self.window + 1) - length, 0)
        if pad > 0:
            emb = F.pad(emb, (0, 0, pad, pad))
        return emb[:, start : start + 2 * length - 1]

    def run(self, p, x):  # [B, C, T]
        b, c, t = x.shape
        H, D = self.heads, c // self.heads

        def split(y):
            return y.reshape(b, H, D, t).transpose(2, 3)

        q = split(_conv1d(p, self.conv_q, x)) / math.sqrt(D)
        k, v = split(_conv1d(p, self.conv_k, x)), split(_conv1d(p, self.conv_v, x))
        scores = _mm(p, q, k.transpose(-2, -1))
        rel = _mm(p, q, self._rel(self.emb_rel_k, t).unsqueeze(0).transpose(-2, -1))  # [b, H, t, 2t-1]
        rel = F.pad(rel, (0, 1)).reshape(b, H, 2 * t * t)
        scores = scores + F.pad(rel, (0, t - 1)).reshape(b, H, t + 1, 2 * t - 1)[:, :, :t, t - 1 :]
        w = torch.softmax(scores, dim=-1)
        out = _mm(p, w, v)
        wr = F.pad(w, (0, t - 1)).reshape(b, H, t * (2 * t - 1))
        wr = F.pad(wr, (t, 0)).reshape(b, H, t, 2 * t)[:, :, :, 1:]
        out = out + _mm(p, wr, self._rel(self.emb_rel_v, t).unsqueeze(0))
        return _conv1d(p, self.conv_o, out.transpose(2, 3).reshape(b, c, t))


class _VitsNorm(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(c))
        self.beta = nn.Parameter(torch.zeros(c))

    def forward(self, x):
        return F.layer_norm(x.transpose(1, -1), (x.shape[1],), self.gamma, self.beta, 1e-5).transpose(1, -1)


class _Ffn(nn.Module):
    def __init__(self, c, f, k):
        super().__init__()
        self.conv_1, self.conv_2 = nn.Conv1d(c, f, k), nn.Conv1d(f, c, k)


class _TextEncoder(nn.Module):
    def __init__(self, s: SynthSize):
        super().__init__()
        h = s.hidden_channels
        self.emb_phone = nn.Linear(s.feature_dim, h)
        self.emb_pitch = _embedding(256, h)
        e = nn.Module()
        e.attn_layers = nn.ModuleList(_RelAttn(h, s.n_heads, s.attn_window) for _ in range(s.n_layers))
        e.norm_layers_1 = nn.ModuleList(_VitsNorm(h) for _ in range(s.n_layers))
        e.ffn_layers = nn.ModuleList(_Ffn(h, s.filter_channels, s.kernel_size) for _ in range(s.n_layers))
        e.norm_layers_2 = nn.ModuleList(_VitsNorm(h) for _ in range(s.n_layers))
        self.encoder = e
        self.proj = nn.Conv1d(h, 2 * s.inter_channels, 1)


class _WN(nn.Module):
    def __init__(self, h, k, n, gin):
        super().__init__()
        self.cond_layer = nn.Conv1d(gin, 2 * h * n, 1)
        self.in_layers = nn.ModuleList(nn.Conv1d(h, 2 * h, k, padding=(k - 1) // 2) for _ in range(n))
        self.res_skip_layers = nn.ModuleList(nn.Conv1d(h, 2 * h if i < n - 1 else h, 1) for i in range(n))


class _Coupling(nn.Module):
    def __init__(self, c, h, k, n, gin):
        super().__init__()
        self.pre = nn.Conv1d(c // 2, h, 1)
        self.enc = _WN(h, k, n, gin)
        self.post = nn.Conv1d(h, c // 2, 1)


class _Flows(nn.Module):
    def __init__(self, s: SynthSize):
        super().__init__()
        self.flows = nn.ModuleList()
        for _ in range(s.flow_flows):
            self.flows.append(_Coupling(s.inter_channels, s.hidden_channels, s.flow_kernel, s.flow_layers,
                                        s.gin_channels))
            self.flows.append(nn.Identity())  # the flip: no parameters


class _ResBlock(nn.Module):
    def __init__(self, c, k, dils):
        super().__init__()
        self.convs1 = nn.ModuleList(nn.Conv1d(c, c, k, dilation=d, padding=(k * d - d) // 2) for d in dils)
        self.convs2 = nn.ModuleList(nn.Conv1d(c, c, k, padding=k // 2) for _ in dils)


class _Generator(nn.Module):
    def __init__(self, s: SynthSize):
        super().__init__()
        self.m_source = nn.Module()
        self.m_source.l_linear = nn.Linear(1, 1)
        c0 = s.upsample_initial_channel
        self.conv_pre = nn.Conv1d(s.inter_channels, c0, 7, padding=3)
        self.cond = nn.Conv1d(s.gin_channels, c0, 1)
        self.ups, self.noise_convs, self.resblocks = nn.ModuleList(), nn.ModuleList(), nn.ModuleList()
        for i, (u, k) in enumerate(zip(s.upsample_rates, s.upsample_kernel_sizes)):
            ch = c0 // 2 ** (i + 1)
            self.ups.append(nn.ConvTranspose1d(c0 // 2**i, ch, k, stride=u, padding=(k - u) // 2))
            if i + 1 < len(s.upsample_rates):
                sf = math.prod(s.upsample_rates[i + 1 :])
                self.noise_convs.append(nn.Conv1d(1, ch, sf * 2, stride=sf, padding=sf // 2))
            else:
                self.noise_convs.append(nn.Conv1d(1, ch, 1))
            for rk, rd in zip(s.resblock_kernel_sizes, s.resblock_dilation_sizes):
                self.resblocks.append(_ResBlock(ch, rk, rd))
        self.conv_post = nn.Conv1d(ch, 1, 7, padding=3, bias=False)


def sine_source(f0: torch.Tensor, upp: int, sample_rate: int, sine_amp: float = 0.1) -> torch.Tensor:
    """RVC's SineGen with no harmonics and no noise: frame-rate f0 ``[B, T]``
    → the voiced sine ``[B, T*upp]``, with the phase-wrap corrections RVC
    applies to keep the sample-rate cumulative phase on the frame-rate one."""
    B, T = f0.shape
    rad = (f0 / sample_rate) % 1.0
    cum_frame = torch.cumsum(rad, dim=1) * upp
    size = T * upp
    step = float(torch.tensor((T - 1) / (size - 1), dtype=torch.float32, device="cpu"))
    pos = torch.arange(size, dtype=torch.float32, device=f0.device) * step
    lo = torch.clamp(torch.floor(pos).long(), 0, T - 1)
    hi = torch.clamp(torch.ceil(pos).long(), 0, T - 1)
    frac = pos - lo.float()
    over_one = (cum_frame[:, lo] * (1 - frac) + cum_frame[:, hi] * frac) % 1.0
    rad_s = torch.repeat_interleave(rad, upp, dim=1)
    wrap = (over_one[:, 1:] - over_one[:, :-1]) < 0
    shift = F.pad(wrap.float() * -1.0, (1, 0))
    sine = torch.sin(2.0 * math.pi * torch.cumsum(rad_s + shift, dim=1)) * sine_amp
    return sine * torch.repeat_interleave((f0 > 0).float(), upp, dim=1)


class Synth(nn.Module):
    """``(phone [B, T, 768], pitch [B, T] codes, pitchf [B, T] Hz, sid [B])``
    → waveform ``[B, T * upp]`` at the model rate."""

    def __init__(self, s: SynthSize = SynthSize(), prec: Precision = FLOAT32):
        super().__init__()
        self.s, self.prec = s, prec
        self.enc_p = _TextEncoder(s)
        self.flow = _Flows(s)
        self.dec = _Generator(s)
        self.emb_g = _embedding(s.spk_embed_dim, s.gin_channels)

    def _wn(self, wn: _WN, x, g):
        p, H = self.prec, x.shape[1]
        n = len(wn.in_layers)
        g = _conv1d(p, wn.cond_layer, g)
        out = torch.zeros_like(x)
        for i in range(n):
            acts = _conv1d(p, wn.in_layers[i], x) + g[:, i * 2 * H : (i + 1) * 2 * H]
            acts = torch.tanh(acts[:, :H]) * torch.sigmoid(acts[:, H:])
            rs = _conv1d(p, wn.res_skip_layers[i], acts)
            if i < n - 1:
                x = x + rs[:, :H]
                out = out + rs[:, H:]
            else:
                out = out + rs
        return out

    def forward(self, phone, pitch, pitchf, sid):
        p, s, te = self.prec, self.s, self.enc_p
        g = self.emb_g(sid).unsqueeze(-1)
        x = (_lin(p, te.emb_phone, phone.float()) + te.emb_pitch(pitch)) * math.sqrt(s.hidden_channels)
        x = F.leaky_relu(x, 0.1).transpose(1, 2)
        e = te.encoder
        pad = ((s.kernel_size - 1) // 2, s.kernel_size // 2)
        for attn, n1, ffn, n2 in zip(e.attn_layers, e.norm_layers_1, e.ffn_layers, e.norm_layers_2):
            x = n1(x + attn.run(p, x))
            h = torch.relu(_conv1d(p, ffn.conv_1, F.pad(x, pad)))
            x = n2(x + _conv1d(p, ffn.conv_2, F.pad(h, pad)))
        z, _ = torch.split(_conv1d(p, te.proj, x), s.inter_channels, dim=1)  # z_p = m_p: no prior noise
        half = s.inter_channels // 2
        for f in reversed(self.flow.flows):
            if isinstance(f, nn.Identity):
                z = torch.flip(z, [1])
                continue
            x0, x1 = z[:, :half], z[:, half:]
            m = _conv1d(p, f.post, self._wn(f.enc, _conv1d(p, f.pre, x0), g))
            z = torch.cat([x0, x1 - m], dim=1)
        d = self.dec
        upp = math.prod(s.upsample_rates)
        har = sine_source(pitchf.float(), upp, s.sample_rate)[..., None]
        har = torch.tanh(_lin(p, d.m_source.l_linear, har)).transpose(1, 2)
        x = _conv1d(p, d.conv_pre, z) + _conv1d(p, d.cond, g)
        nk = len(s.resblock_kernel_sizes)
        for i, up in enumerate(d.ups):
            x = F.conv_transpose1d(p.act(F.leaky_relu(x, 0.1)), up.weight, up.bias, stride=up.stride,
                                   padding=up.padding)
            x = x + _conv1d(p, d.noise_convs[i], har)
            total = None
            for rb in d.resblocks[i * nk : (i + 1) * nk]:
                y = x
                for c1, c2 in zip(rb.convs1, rb.convs2):
                    t = F.leaky_relu(_conv1d(p, c1, F.leaky_relu(y, 0.1)), 0.1)
                    y = y + _conv1d(p, c2, t)
                total = y if total is None else total + y
            x = total / nk
        return torch.tanh(_conv1d(p, d.conv_post, F.leaky_relu(x, 0.01))[:, 0])
