"""The streaming conversion step of the obs-rvc plugin, in plain PyTorch and
float32: the benchmark's reference for what the program emits.

One chunk of device-rate audio goes through::

    the device-rate ring, its last window resampled to 16 kHz into the 16 kHz ring
    → ContentVec features, doubled to 100 Hz, the chunk's frames sliced
    → the pitch window's log-mel (RMVPE: HTK scale; FCPE: Slaney) → salience → f0
      → the pitch shift → the chunk's track, quantised to coarse codes
    → the synthesizer at the model rate → resampled to the device rate
    → the loudness envelope mixed toward the input's
    → SOLA: the offset that best continues the last chunk's tail, a crossfade

Two forms share these pieces:

- :meth:`Reference.outputs` works out, for chunk ``k`` of a stream, what
  every stage gives from the stream's input alone: the rings are a
  function of the last eight chunks of input, and the part of the pitch
  cache a chunk reads is written by that chunk (checked from the geometry).
  Only SOLA carries a choice from chunk to chunk; :mod:`benchmark.judge`
  reads it from the program's output.
- :class:`ReferenceStreams` steps ``B`` streams chunk by chunk with a state
  of its own, as a server would: the control of the comparison, put in the
  program's place.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference import nets

ZC_16K = 160
PITCH_CACHE = 1024


@dataclasses.dataclass(frozen=True)
class Geometry:
    """The plugin's chunk algebra at 10 ms blocks."""

    sample_rate: int = 48000
    model_rate: int = 40000
    chunk_s: float = 0.30
    fade_s: float = 0.07
    context_s: float = 2.00

    @property
    def zc(self):
        return self.sample_rate // 100

    @property
    def chunk(self):
        return round(self.chunk_s * self.sample_rate / self.zc) * self.zc

    @property
    def chunk16(self):
        return self.chunk // self.zc * ZC_16K

    @property
    def sola(self):
        return min(round(self.fade_s * self.sample_rate / self.zc) * self.zc, 4 * self.zc)

    @property
    def search(self):
        return self.zc

    @property
    def extra(self):
        return round(self.context_s * self.sample_rate / self.zc) * self.zc

    @property
    def ring(self):
        crossfade = round(self.fade_s * self.sample_rate / self.zc) * self.zc
        return self.extra + crossfade + self.search + self.chunk

    @property
    def ring16(self):
        return ZC_16K * self.ring // self.zc

    @property
    def return_frames(self):
        return (self.chunk + self.sola + self.search) // self.zc

    @property
    def skip_head(self):
        return self.extra // self.zc

    @property
    def down_window(self):
        return self.chunk + 2 * self.zc

    @property
    def down_keep(self):
        return (self.chunk // self.zc + 1) * ZC_16K

    @property
    def pitch_window(self):
        return 5120 * ((self.chunk16 + 800 - 1) // 5120 + 1) - ZC_16K

    @property
    def pitch_frames(self):
        return 1 + self.pitch_window // ZC_16K

    @property
    def hubert_length(self):
        return min(self.ring16 // ZC_16K, 2 * nets.feature_frames(self.ring16) + 1)


# ---------------------------------------------------------------------------
# DSP
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=8)
def _lowpass(up: int, down: int, taps: int = 16, beta: float = 8.555) -> np.ndarray:
    m = max(up, down)
    n = np.arange(-taps * m, taps * m + 1, dtype=np.float64)
    h = (1.0 / m) * np.sinc(n / m) * np.kaiser(2 * taps * m + 1, beta)
    return (h / h.sum() * up).astype(np.float32)


def resample(x: torch.Tensor, sr_in: int, sr_out: int) -> torch.Tensor:
    """``[B, n]`` → ``[B, ceil(n*up/down)]``: zero-stuffed by ``up``, a
    zero-phase Kaiser-windowed sinc lowpass, every ``down``-th sample kept;
    zeros past both edges."""
    g = math.gcd(sr_in, sr_out)
    up, down = sr_out // g, sr_in // g
    h = torch.from_numpy(_lowpass(up, down)).to(x.device)
    pad = (h.shape[0] - 1) // 2
    stuffed = x.new_zeros(x.shape[0], (x.shape[1] - 1) * up + 1)
    stuffed[:, ::up] = x
    stuffed = F.pad(stuffed, (pad, pad + up - 1))
    y = F.conv1d(stuffed[:, None], h.flip(0)[None, None], stride=down)[:, 0]
    return y[:, : -(-x.shape[1] * up // down)]


def _hz_to_mel(f, htk):
    f = np.asarray(f, np.float64)
    if htk:
        return 2595.0 * np.log10(1.0 + f / 700.0)
    lin = f / (200.0 / 3)
    return np.where(f >= 1000.0, 15.0 + np.log(np.maximum(f, 1e-10) / 1000.0) / (np.log(6.4) / 27.0), lin)


def _mel_to_hz(m, htk):
    m = np.asarray(m, np.float64)
    if htk:
        return 700.0 * (10.0 ** (m / 2595.0) - 1.0)
    return np.where(m >= 15.0, 1000.0 * np.exp(np.log(6.4) / 27.0 * (m - 15.0)), m * (200.0 / 3))


@functools.lru_cache(maxsize=4)
def mel_basis(htk: bool, fmin: float, sr=16000, n_fft=1024, n_mels=128, fmax=8000.0) -> np.ndarray:
    """librosa's triangular filters with Slaney area normalisation, ``[n_mels, n_fft/2+1]``."""
    freqs = np.linspace(0.0, sr / 2.0, n_fft // 2 + 1)
    pts = _mel_to_hz(np.linspace(_hz_to_mel(fmin, htk), _hz_to_mel(fmax, htk), n_mels + 2), htk)
    ramps = pts[:, None] - freqs[None, :]
    fd = np.diff(pts)
    w = np.maximum(0.0, np.minimum(-ramps[:-2] / fd[:-1, None], ramps[2:] / fd[1:, None]))
    return (w * (2.0 / (pts[2:] - pts[:-2]))[:, None]).astype(np.float32)


def log_mel(x: torch.Tensor, htk: bool, fmin: float, hop=160, n_fft=1024) -> torch.Tensor:
    """``[B, L]`` → ``[B, 128, 1 + L // hop]``: centred frames (reflect
    padding), periodic Hann, one-sided FFT magnitude, mel product, ``ln(max(., 1e-5))``."""
    T = 1 + x.shape[-1] // hop
    xp = F.pad(x[:, None], (n_fft // 2, n_fft // 2), mode="reflect")[:, 0]
    frames = xp.unfold(-1, n_fft, hop)[:, :T]
    i = torch.arange(n_fft, dtype=torch.float64, device=x.device)
    window = (0.5 * (1 - torch.cos(2 * math.pi * i / n_fft))).float()
    mag = torch.fft.rfft(frames * window, dim=-1).abs()
    basis = torch.from_numpy(mel_basis(htk, fmin)).to(x.device)
    return torch.log(torch.clamp(mag @ basis.T, min=1e-5)).transpose(1, 2)


RMVPE_CENTS = torch.from_numpy(((np.arange(368, dtype=np.float64) - 4.0) * 20.0 + 1997.3794084376191)
                               .astype(np.float32))


def decode_rmvpe(sal: torch.Tensor, threshold=0.03) -> torch.Tensor:
    """Salience ``[B, T, 360]`` → f0 Hz: the salience-weighted mean of the
    cents of the 9 bins around the peak (4 bins of zeros padded each side),
    0 where the peak is not above ``threshold``."""
    padded = F.pad(sal, (4, 4))
    c = torch.argmax(padded, dim=-1).clamp(4, padded.shape[-1] - 5)
    idx = c[..., None] - 4 + torch.arange(9, device=sal.device)
    w = torch.gather(padded, -1, idx)
    cents = (w * RMVPE_CENTS.to(sal.device)[idx]).sum(-1) / w.sum(-1).clamp(min=1e-12)
    cents = torch.where(sal.amax(-1) > threshold, cents, torch.zeros_like(cents))
    f0 = 10.0 * torch.exp2(cents / 1200.0)
    return torch.where(f0 == 10.0, torch.zeros_like(f0), f0)


def decode_fcpe(sal: torch.Tensor, threshold=0.05) -> torch.Tensor:
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


def coarse_codes(f0: torch.Tensor) -> torch.Tensor:
    """f0 Hz → RVC's coarse pitch codes 1..255 on the mel scale between 50 and 500 Hz."""
    lo, hi = (1127.0 * math.log(1.0 + f / 700.0) for f in (50.0, 500.0))
    mel = torch.log(f0 / 700.0 + 1.0) * 1127.0
    scaled = torch.where(mel > 0, (mel - lo) * 254.0 / (hi - lo) + 1.0, mel)
    return torch.clamp(torch.round(scaled), 1.0, 255.0).long()


def _rms(y: torch.Tensor, frame: int, hop: int) -> torch.Tensor:
    y2 = F.pad(y * y, (frame // 2, frame // 2))
    n = (y2.shape[-1] - frame) // hop + 1
    return torch.sqrt(y2.unfold(-1, frame, hop)[..., :n, :].sum(-1) / frame)


def _interp(x: torch.Tensor, size: int) -> torch.Tensor:
    """Align-corners linear interpolation of the last axis to ``size`` points."""
    return F.interpolate(x[:, None], size=size, mode="linear", align_corners=True)[:, 0]


def envelope_mix(inp: torch.Tensor, out: torch.Tensor, zc: int, mix: torch.Tensor) -> torch.Tensor:
    """``out * (rms_in / max(rms_out, 1e-3)) ** (1 - mix)``, framewise RMS
    (frame 4 zc, hop zc) interpolated to every sample."""
    n = out.shape[-1]
    r1 = _interp(_rms(inp[:, :n], 4 * zc, zc), n + 1)[:, :n]
    r2 = torch.clamp(_interp(_rms(out, 4 * zc, zc), n + 1), min=1e-3)[:, :n]
    return out * (r1 / r2) ** (1.0 - mix)[:, None]


def sola_scores(out: torch.Tensor, tail: torch.Tensor, search: int) -> torch.Tensor:
    """``[B, search+1]``: for each offset j, ``<out[j:j+S], tail> / sqrt(sum(out[j:j+S]^2) + 1e-8)``."""
    S = tail.shape[-1]
    win = out[:, : S + search].unfold(-1, S, 1)  # [B, search+1, S]
    return (win * tail[:, None]).sum(-1) / torch.sqrt((win * win).sum(-1) + 1e-8)


def fade(n: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    x = torch.linspace(0.0, 1.0, n, dtype=torch.float64, device=device)
    fin = torch.sin(x * 0.5 * math.pi) ** 2
    return fin.float(), (1.0 - fin).float()


def crossfade(out: torch.Tensor, tail: torch.Tensor, offset: torch.Tensor, chunk: int):
    """``(emitted [B, chunk], next tail [B, S])`` of ``out`` taken at each row's ``offset``."""
    S = tail.shape[-1]
    idx = offset[:, None] + torch.arange(chunk + S, device=out.device)
    aligned = torch.gather(out, 1, idx)
    fin, fout = fade(S, out.device)
    head = aligned[:, :S] * fin + tail * fout
    return torch.cat([head, aligned[:, S:chunk]], dim=1), aligned[:, chunk:]


# ---------------------------------------------------------------------------
# the networks' part and the rings
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Controls:
    pitch_shift: float = 12.0
    rms_mix_rate: float = 0.5
    sid: int = 0


class Reference:
    """The step's stages over ``B`` chunks at once, with the networks'
    weights as the configuration serves them (rounded to its dtype, then
    computed in float32), or rounded further by ``prec`` for the control."""

    def __init__(self, geo: Geometry, pitch: str, contentvec, pitch_net, synth, controls: Controls):
        if pitch not in ("rmvpe", "fcpe"):
            raise ValueError(f"the reference has no pitch network {pitch!r}")
        self.geo, self.pitch, self.controls = geo, pitch, controls
        self.contentvec, self.pitch_net, self.synth = contentvec, pitch_net, synth
        g = geo
        start = PITCH_CACHE - g.hubert_length + g.skip_head
        written = PITCH_CACHE + 4 - g.pitch_frames
        if start < written or start + g.return_frames > PITCH_CACHE:
            raise ValueError("the chunk's pitch slice reads cache frames an earlier chunk wrote")
        #: the f0 frames of this chunk's own pitch window that the synthesizer reads
        self.f0_slice = slice(3 + start - written, 3 + start - written + g.return_frames)

    def rings(self, signal: torch.Tensor, k: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """``(device-rate ring [B, ring], 16 kHz ring [B, ring16])`` after chunk
        ``k[b]`` of ``signal[b]`` (``[B, n]``, zeros before the stream's start).
        The 16 kHz ring holds the last 16 kHz pieces of the chunks before:
        each chunk's ``down_keep`` samples resampled from its last
        ``down_window`` input samples, each earlier one's first ``chunk16``."""
        g = self.geo
        B = signal.shape[0]
        n_pieces = -(-(g.ring16 - g.down_keep) // g.chunk16) + 1
        lead = g.ring + n_pieces * g.chunk
        padded = F.pad(signal, (lead, 0))
        rows = torch.arange(B, device=signal.device)[:, None]
        end = (k + 1) * g.chunk + lead  # [B]: the end of chunk k in padded
        ring = padded[rows, end[:, None] - g.ring + torch.arange(g.ring, device=signal.device)]
        pieces = []
        for j in range(n_pieces - 1, -1, -1):  # chunk k - j
            e = end - j * g.chunk
            win = padded[rows, e[:, None] - g.down_window + torch.arange(g.down_window, device=signal.device)]
            res = resample(win, g.sample_rate, 16000)[:, -g.down_keep :]
            pieces.append(res if j == 0 else res[:, : g.chunk16])
        ring16 = torch.cat(pieces, dim=1)[:, -g.ring16 :]
        return ring, ring16

    @torch.no_grad()
    def model_out(self, ring16: torch.Tensor) -> torch.Tensor:
        """The synthesizer's audio at the model rate, ``[B, return_frames * model_rate/100]``."""
        g, c = self.geo, self.controls
        feats = self.contentvec(ring16)
        feats = torch.cat([torch.repeat_interleave(feats, 2, dim=1), feats[:, -1:]], dim=1)
        phone = feats[:, g.skip_head : g.skip_head + g.return_frames]
        window = ring16[:, -g.pitch_window :]
        if self.pitch == "rmvpe":
            f0 = decode_rmvpe(self.pitch_net(log_mel(window, htk=True, fmin=30.0)))
        else:
            f0 = decode_fcpe(self.pitch_net(log_mel(window, htk=False, fmin=0.0).transpose(1, 2)))
        f0 = f0 * float(torch.exp2(torch.tensor(c.pitch_shift, dtype=torch.float32, device="cpu") / 12.0))
        f0 = f0[:, self.f0_slice]
        sid = torch.full((f0.shape[0],), c.sid, dtype=torch.long, device=f0.device)
        return self.synth(phone, coarse_codes(f0), f0, sid)

    def unaligned(self, ring: torch.Tensor, model: torch.Tensor) -> torch.Tensor:
        """The model's audio at the device rate with the input's envelope mixed
        in: what SOLA takes its offset and the emitted chunk from."""
        g = self.geo
        out = resample(model, g.model_rate, g.sample_rate)
        mix = torch.full((out.shape[0],), self.controls.rms_mix_rate, device=out.device)
        return envelope_mix(ring[:, g.extra :], out, g.zc, mix)

    @torch.no_grad()
    def outputs(self, signal: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
        """``[B, chunk + sola + search]``: chunk ``k[b]``'s unaligned output."""
        ring, ring16 = self.rings(signal, k)
        return self.unaligned(ring, self.model_out(ring16))


class ReferenceStreams:
    """``B`` streams stepped chunk by chunk with their own state: the
    reference in the program's place. ``step(chunks [B, chunk])`` →
    emitted ``[B, chunk]``."""

    def __init__(self, ref: Reference, batch: int, device):
        g = ref.geo
        self.ref = ref
        self.ring = torch.zeros(batch, g.ring, device=device)
        self.ring16 = torch.zeros(batch, g.ring16, device=device)
        self.tail = torch.zeros(batch, g.sola, device=device)

    @torch.no_grad()
    def step(self, chunks: torch.Tensor) -> torch.Tensor:
        g, ref = self.ref.geo, self.ref
        self.ring = torch.cat([self.ring[:, g.chunk :], chunks.float()], dim=1)
        res = resample(self.ring[:, -g.down_window :], g.sample_rate, 16000)
        kept = self.ring16[:, g.chunk16 : g.ring16 - (g.down_keep - g.chunk16)]
        self.ring16 = torch.cat([kept, res[:, -g.down_keep :]], dim=1)
        out = ref.unaligned(self.ring, ref.model_out(self.ring16))
        offset = torch.argmax(sola_scores(out, self.tail, g.search), dim=-1)
        emitted, self.tail = crossfade(out, self.tail, offset, g.chunk)
        return emitted


def build(geo: Geometry, pitch: str, sizes: dict, state_dicts: dict, controls: Controls, device,
          prec: nets.Precision = nets.FLOAT32) -> Reference:
    """The reference's networks on ``device`` from ``state_dicts`` (by
    network: ``contentvec``, the pitch network's name, ``synthesizer``),
    each weight as given (rounded by ``prec`` for the control)."""
    makers = {"contentvec": (nets.ContentVec, nets.ContentVecSize),
              "rmvpe": (nets.Rmvpe, nets.RmvpeSize), "fcpe": (nets.Fcpe, nets.FcpeSize),
              "synthesizer": (nets.Synth, nets.SynthSize)}
    mods = {}
    for name in ("contentvec", pitch, "synthesizer"):
        cls, size = makers[name]
        mods[name] = make_module(cls, size(**sizes.get(name, {})), device, prec,
                                 nets.prec_weights(state_dicts[name], prec))
    return Reference(geo, pitch, mods["contentvec"], mods[pitch], mods["synthesizer"], controls)


def make_module(cls, size, device, prec=nets.FLOAT32, state_dict=None):
    """A reference network built without initialising its weights, then
    given ``state_dict`` (all of its entries, in float32) on ``device``."""
    with torch.device("meta"):
        m = cls(size, prec)
    m = m.to_empty(device=device)
    if state_dict is not None:
        m.load_state_dict({k: v.to(device, torch.float32) if v.is_floating_point() else v.to(device)
                           for k, v in state_dict.items()}, strict=True)
    return m.eval()
