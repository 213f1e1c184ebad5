"""The benchmark's one traffic generator: a voice-like signal per stream,
made on the device from the seed, by the parameters of a mix's file.

Each stream gets a signal of its own: a harmonic series whose f0 glides
between the mix's bounds (a smooth path through points drawn every
``glide_s``, in log frequency) with vibrato, harmonics falling off as
``1/h**tilt`` up to ``max_hz``, pauses covering about ``pause_share`` of
the time (each ``pause_s`` long, with 10 ms ramps), white noise at
``noise_db`` under the voice, the voiced part at ``level_dbfs`` RMS. A
stream's signal is ``period_s`` long and repeats; chunk ``k`` of stream
``s`` is ``chunk(signal, s, k)``.
"""

from __future__ import annotations

import math

import torch

DEFAULTS = {"f0_hz": [80.0, 400.0], "glide_s": 0.5, "vibrato_hz": [4.5, 6.5], "vibrato_semitones": 0.4,
            "harmonics": 24, "tilt": 1.2, "max_hz": 7000.0, "pause_share": 0.2, "pause_s": [0.2, 0.6],
            "noise_db": -30.0, "level_dbfs": -20.0, "period_s": 12.0}


def _cumsum(x: torch.Tensor) -> torch.Tensor:
    """A cumulative sum over the last axis that repeats bit for bit on a card
    (more than one row, so PyTorch's row-wise scan and not a device-wide one)."""
    return torch.cumsum(torch.cat([x, x[:1]]), dim=-1)[: x.shape[0]]


def voice(params: dict, streams: int, sample_rate: int, chunk: int, seed: int, device) -> torch.Tensor:
    """``[streams, n]`` float32 on ``device``, ``n`` the period rounded to whole chunks."""
    p = {**DEFAULTS, **params}
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % 2**63 ^ 0x5EED)

    def uniform(lo, hi, *shape):
        return lo + (hi - lo) * torch.rand(*shape, generator=gen, device=device, dtype=torch.float64)

    n = max(1, round(p["period_s"] * sample_rate / chunk)) * chunk
    t = torch.arange(n, device=device, dtype=torch.float64) / sample_rate
    # f0: a cosine-smoothed path through log-uniform points, plus vibrato
    lo, hi = (math.log(f) for f in p["f0_hz"])
    n_pts = int(n / sample_rate / p["glide_s"]) + 2
    pts = uniform(lo, hi, streams, n_pts)
    pos = t / p["glide_s"]
    i = pos.floor().long().clamp(max=n_pts - 2)
    frac = 0.5 - 0.5 * torch.cos(math.pi * (pos - i))
    log_f0 = pts[:, i] * (1 - frac) + pts[:, i + 1] * frac
    rate = uniform(*p["vibrato_hz"], streams, 1)
    phase0 = uniform(0.0, 2 * math.pi, streams, 1)
    f0 = torch.exp(log_f0) * 2.0 ** (p["vibrato_semitones"] / 12.0 * torch.sin(2 * math.pi * rate * t + phase0))
    phase = 2 * math.pi * _cumsum(f0 / sample_rate)
    sig = torch.zeros(streams, n, device=device, dtype=torch.float64)
    for h in range(1, int(p["harmonics"]) + 1):
        sig += torch.where(h * f0 < p["max_hz"], torch.sin(h * phase) / h ** p["tilt"], 0.0)
    # pauses: segments on and off, about pause_share of the time off
    mean_off = sum(p["pause_s"]) / 2
    mean_on = mean_off * (1 - p["pause_share"]) / max(p["pause_share"], 1e-6)
    n_seg = int(n / sample_rate / (mean_on + mean_off)) + 2
    on = uniform(0.5 * mean_on, 1.5 * mean_on, streams, n_seg)
    off = uniform(*p["pause_s"], streams, n_seg)
    bounds = _cumsum(torch.stack([on, off], dim=-1).reshape(streams, -1))  # end of each on, then off, ...
    seg = torch.searchsorted(bounds, t.expand(streams, -1).contiguous())
    gate = (seg % 2 == 0).double()
    ramp = int(0.01 * sample_rate)
    kernel = torch.full((1, 1, 2 * ramp + 1), 1.0 / (2 * ramp + 1), device=device, dtype=torch.float64)
    gate = torch.nn.functional.conv1d(gate[:, None], kernel, padding=ramp)[:, 0]
    voiced = sig * gate
    rms = torch.sqrt((voiced**2).sum(-1, keepdim=True) / (gate**2).sum(-1, keepdim=True).clamp(min=1.0))
    level = 10.0 ** (p["level_dbfs"] / 20.0)
    noise = torch.randn(streams, n, generator=gen, device=device, dtype=torch.float64)
    out = voiced * (level / rms) + noise * level * 10.0 ** (p["noise_db"] / 20.0)
    return out.float()


def chunk(signal, stream: int, k: int, size: int):
    """Chunk ``k`` of ``stream`` (the signal repeats), zeros for ``k < 0``."""
    if k < 0:
        return signal[stream, :size] * 0
    per = signal.shape[1] // size
    j = k % per
    return signal[stream, j * size : (j + 1) * size]


def history(signal, stream: int, k: int, size: int, n: int):
    """Chunks ``k-n+1 .. k`` of ``stream`` end to end (zeros before the stream's start)."""
    return torch.cat([chunk(signal, stream, j, size) for j in range(k - n + 1, k + 1)])
