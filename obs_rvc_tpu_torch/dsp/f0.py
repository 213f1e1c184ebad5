"""RMVPE salience decoding and f0 post-processing (counterpart of
``obs_rvc_tpu/dsp/f0.py``).

- decode: salience-weighted average of the 9 bins centred on the per-frame
  argmax of the 4-bin-padded salience, gated by a confidence threshold,
  ``f0 = 10 * 2^(cents/1200)``, unvoiced → 0;
- ``get_f0_post``: mel-scale quantisation of f0 to coarse codes 1..=255;
- pitch shift as the float power ``2**(semitones/12)``, in float32 (the
  shift may be a 0-d tensor: a graph input).
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

#: ``(i-4)*20 + 1997.3794084376191`` for i in 0..368.
CENTS_MAPPING = (
    (np.arange(360 + 2 * 4, dtype=np.float64) - 4.0) * 20.0 + 1997.3794084376191
).astype(np.float32)

F0_MIN = 50.0
F0_MAX = 500.0
F0_MEL_MIN = float(np.log(F0_MIN / 700.0 + 1.0) * 1127.0)
F0_MEL_MAX = float(np.log(F0_MAX / 700.0 + 1.0) * 1127.0)


@functools.lru_cache(maxsize=4)
def _cents_on(device: torch.device) -> torch.Tensor:
    return torch.from_numpy(CENTS_MAPPING).to(device)


def to_local_average_cents(salience: torch.Tensor, threshold: float = 0.03) -> torch.Tensor:
    """Per-frame weighted-average cents from salience ``[T, 360]``."""
    padded = F.pad(salience, (4, 4))  # [T, 368]
    center = torch.argmax(padded, dim=1)
    win_idx = center[:, None] - 4 + torch.arange(9, device=salience.device)[None, :]
    todo_salience = torch.gather(padded, 1, win_idx)
    todo_cents = _cents_on(salience.device)[win_idx]
    product_sum = torch.sum(todo_salience * todo_cents, dim=1)
    weight_sum = torch.sum(todo_salience, dim=1)
    cents = product_sum / torch.clamp(weight_sum, min=1e-12)
    maxx = torch.amax(salience, dim=1)
    return torch.where(maxx > threshold, cents, torch.zeros_like(cents))


def decode_f0(salience: torch.Tensor, threshold: float = 0.03) -> torch.Tensor:
    """Salience ``[T, 360]`` → f0 Hz ``[T]``."""
    f0 = 10.0 * torch.exp2(to_local_average_cents(salience, threshold) / 1200.0)
    return torch.where(f0 == 10.0, torch.zeros_like(f0), f0)


def get_f0_post(f0: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """f0 Hz → (coarse int64 codes 1..=255, f0 Hz)."""
    f0_mel = torch.log(f0 / 700.0 + 1.0) * 1127.0
    scaled = torch.where(
        f0_mel > 0.0,
        (f0_mel - F0_MEL_MIN) * 254.0 / (F0_MEL_MAX - F0_MEL_MIN) + 1.0,
        f0_mel,
    )
    coarse = torch.clamp(torch.round(scaled), 1.0, 255.0).long()
    return coarse, f0


def apply_pitch_shift(f0: torch.Tensor, semitones) -> torch.Tensor:
    """Scale f0 by ``exp2(float32(semitones) / 12)``, all in float32 as the
    JAX function computes it; ``semitones`` a number or a 0-d tensor."""
    st = torch.as_tensor(semitones, dtype=torch.float32, device=f0.device)
    return f0 * torch.exp2(st / 12.0)


def median_filter_f0(f0: torch.Tensor, radius: int = 3) -> torch.Tensor:
    """Odd-width, edge-replicated median filter over the f0 track; a no-op
    for ``radius < 3``, an even radius widened by one."""
    if radius < 3:
        return f0
    if radius % 2 == 0:
        radius += 1
    half = radius // 2
    padded = F.pad(f0[None, None], (half, half), mode="replicate")[0, 0]
    return padded.unfold(0, radius, 1).median(dim=1).values
