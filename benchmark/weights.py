"""Seeded random weights for a configuration, made on the device.

The keys and shapes are those of the reference's networks
(:mod:`benchmark.reference.nets`, :mod:`benchmark.reference.pitch`), which
follow the upstream checkpoints; the program loads the same dict
(``load_state_dict(strict=True)``), so a key that one side lacks fails the
run. The rule: norms' scales and
variances 1, biases, shifts and means 0, every other weight
``N(0, 1) / sqrt(fan_in)`` (activations stay near unit size through the
depth), drawn in one call a network from a ``torch.Generator`` on the
device.

Two weights take the shape a trained model gives them, because the step
makes a discrete choice from what they produce, and a random weight puts
that choice on a knife's edge (a rounding in the last bit moves it, and the
audio with it):

- the pitch embedding (``emb_pitch``, one row per coarse pitch code) varies
  smoothly from code to code, as a trained one does: a sum of a few
  low-frequency cosines over the codes, with random amplitudes and phases
  per channel. A code that rounds the other way then changes the
  synthesizer's input a little, not by a whole random row;
- the pitch network's salience head (the keys its file names in ``HEADS``)
  makes one peak over the pitch bins, near the middle of a voice's range, that moves
  with the input and never saturates the sigmoid, as a trained head's peak
  does not: with ``x = b - 150`` for bin ``b``, row ``b`` of the weight is
  ``sin(w x) v`` (``w`` a period of 40 bins, ``v`` random) and its bias
  ``C cos(w x) - E (x/60)**2 - C + 1.5``, so the logits are
  ``C cos(w x) + (v.h) sin(w x) - E (x/60)**2 - C + 1.5``: one peak within a
  few bins of bin 150 (about 190 Hz), its logit between 1.5 and about 3,
  where the sigmoid is still steep enough that bfloat16 tells the bins
  apart. (A head whose peak logit grows with the input, as a random one's
  does, rounds the top bins of a bfloat16 salience to 1 alike, and the
  argmax then picks a side peak: a whole chunk's pitch jumps.)

And one weight is set small: the harmonic source's projection
(``dec.m_source.l_linear``, a 1x1 layer) is 0.05, so the sine the NSF
generator adds at each upsample level is a few percent of its signal. The
sine's phase is the running sum of f0 over the chunk: a bfloat16 f0 that is
off by a hundredth of a percent turns into a phase that drifts by a radian
by the chunk's end, and a random projection near 1 makes that drift a tenth
of the audio, in any correct bfloat16 program. At 0.05 the comparison sees
the precision of every layer instead of the drift of one sine, and does not
see the sine itself: a step with the source dropped reads as a sound one.

The others are drawn from the seed, at the rule's scale.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn

from benchmark.reference import nets
from benchmark.reference.step import network

NORMS = (nn.LayerNorm, nn.GroupNorm, nn.BatchNorm1d, nn.BatchNorm2d, nets._VitsNorm)


def _fan_in(owner: nn.Module, shape: tuple) -> int:
    if isinstance(owner, (nn.ConvTranspose1d, nn.ConvTranspose2d)):
        return owner.in_channels * math.prod(owner.kernel_size) // math.prod(owner.stride)
    return math.prod(shape[1:]) if len(shape) > 1 else 1


def skeleton(name: str, size) -> nn.Module:
    """The reference network ``name`` on the meta device: its keys, shapes and owners."""
    with torch.device("meta"):
        return network(name).Net(size)


def make_state_dict(module: nn.Module, gen: torch.Generator, device) -> dict:
    """Weights for ``module``'s keys by the rule above, float32 on ``device``."""
    plan, total = [], 0
    for key, t in module.state_dict().items():
        owner_name, _, leaf = key.rpartition(".")
        owner = module.get_submodule(owner_name) if owner_name else module
        shape = tuple(t.shape)
        if leaf == "num_batches_tracked":
            kind = "count"
        elif (isinstance(owner, NORMS) and leaf in ("weight", "running_var")) or leaf == "gamma":
            kind = "one"
        elif "bias" in leaf or leaf in ("running_mean", "beta"):
            kind = "zero"
        else:
            kind = "draw"
        plan.append((key, shape, kind, _fan_in(owner, shape) ** -0.5 if kind == "draw" else 0.0, total))
        if kind == "draw":
            total += math.prod(shape)
    draws = torch.randn(total, generator=gen, device=device, dtype=torch.float32)
    sd = {}
    for key, shape, kind, scale, at in plan:
        if kind == "count":
            sd[key] = torch.zeros(shape, dtype=torch.long, device=device)
        elif kind == "draw":
            sd[key] = draws[at : at + math.prod(shape)].view(shape).mul_(scale)
        else:
            sd[key] = torch.full(shape, 1.0 if kind == "one" else 0.0, device=device)
    return sd


#: the cosines a smooth embedding sums
SMOOTH_TERMS = 4
#: the peaked head: its centre bin, period in bins, the scale of v, C, E and the peak's logit
HEAD_CENTRE, HEAD_PERIOD, HEAD_GAIN, HEAD_CONFINE, HEAD_ENVELOPE, HEAD_LIFT = 150, 40, 1.0, 3.0, 4.0, 1.5


def _smooth_rows(shape, gen, device) -> torch.Tensor:
    """``[n, c]``: each column a sum of ``SMOOTH_TERMS`` cosines of the row index, unit variance."""
    n, c = shape
    x = torch.arange(n, device=device, dtype=torch.float32)[:, None, None] / max(n - 1, 1)
    m = torch.arange(1, SMOOTH_TERMS + 1, device=device, dtype=torch.float32)
    amp = torch.randn(1, c, SMOOTH_TERMS, generator=gen, device=device) / m
    phase = 2 * math.pi * torch.rand(1, c, SMOOTH_TERMS, generator=gen, device=device)
    out = (amp * torch.cos(math.pi * m * x + phase)).sum(-1)
    return out / out.std().clamp(min=1e-12)


def _peaked_head(shape, gen, device) -> tuple[torch.Tensor, torch.Tensor]:
    """``([n, c] weight, [n] bias)`` of the peaked head (see the module)."""
    n, c = shape
    x = torch.arange(n, device=device, dtype=torch.float32) - HEAD_CENTRE
    wx = 2 * math.pi / HEAD_PERIOD * x
    v = torch.randn(1, c, generator=gen, device=device) * (HEAD_GAIN / math.sqrt(c))
    weight = torch.sin(wx)[:, None] * v
    bias = HEAD_CONFINE * torch.cos(wx) - HEAD_ENVELOPE * (x / 60.0) ** 2 - HEAD_CONFINE + HEAD_LIFT
    return weight, bias


#: the harmonic source's projection (see the module)
SOURCE_KEY, SOURCE_GAIN = "dec.m_source.l_linear.weight", 0.05


def structure(sd: dict, gen: torch.Generator, device, heads: tuple) -> dict:
    """``sd`` with the pitch embedding made smooth, the salience head (the
    weights keyed by ``heads``) peaked and the harmonic source's projection
    small (see the module)."""
    if SOURCE_KEY in sd:
        sd[SOURCE_KEY] = torch.full_like(sd[SOURCE_KEY], SOURCE_GAIN)
    for key in list(sd):
        if key.endswith("emb_pitch.weight"):
            sd[key] = _smooth_rows(tuple(sd[key].shape), gen, device)
        elif key in heads:
            sd[key], sd[key[: -len("weight")] + "bias"] = _peaked_head(tuple(sd[key].shape), gen, device)
    return sd


def make_weights(nets_sizes: dict, seed: int, device) -> dict:
    """``{network: state dict}`` for ``nets_sizes`` (``{network: size dataclass}``),
    every draw from one generator on ``device`` seeded with ``seed``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % 2**63)
    return {name: structure(make_state_dict(skeleton(name, size), gen, device), gen, device, network(name).HEADS)
            for name, size in nets_sizes.items()}


def round_to(sd: dict, dtype: torch.dtype) -> dict:
    """The dict as a network served in ``dtype`` holds it, back in float32:
    what the program's load rounds each floating entry to."""
    return {k: v.to(dtype).to(torch.float32) if v.is_floating_point() else v for k, v in sd.items()}
