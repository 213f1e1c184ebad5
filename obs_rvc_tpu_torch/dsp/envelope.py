"""RMS envelope matching, the "loudness factor" (counterpart of
``obs_rvc_tpu/dsp/envelope.py``): framewise RMS (frame ``4*zc``, hop ``zc``,
zero-pad ``frame/2``), align-corners linear interpolation to per-sample
envelopes, ``out *= (rms_in / max(rms_out, 1e-3)) ** (1 - mix_rate)``.

Every function works over the last axis; leading axes are streams, each
with its own ``mix_rate``.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from obs_rvc_tpu_torch.dsp.scan import cumsum_rows
from obs_rvc_tpu_torch.dsp.streams import per_stream


def rms_envelope(y: torch.Tensor, frame_length: int, hop_length: int) -> torch.Tensor:
    """Framewise RMS of ``y`` with centred zero padding, ``len(y)//hop + 1`` frames."""
    padding = frame_length // 2
    y2 = F.pad(y * y, (padding, padding))
    n_frames = (y2.shape[-1] - frame_length) // hop_length + 1
    csum = cumsum_rows(F.pad(y2, (1, 0)), dim=-1)
    starts = torch.arange(n_frames, device=y.device) * hop_length
    sums = csum[..., starts + frame_length] - csum[..., starts]
    return torch.sqrt(sums / frame_length)


def linear_interpolate_align_corners(x: torch.Tensor, size: int) -> torch.Tensor:
    """1-D align-corners linear interpolation to ``size`` points; an integral
    upsample factor is computed as per-segment ramps, any other by gathers."""
    n = x.shape[-1]
    if n >= 2 and (size - 1) % (n - 1) == 0:
        r = (size - 1) // (n - 1)
        ramp = torch.arange(r, dtype=torch.float32, device=x.device) / float(r)
        segs = x[..., :-1, None] + (x[..., 1:] - x[..., :-1])[..., None] * ramp
        return torch.cat([segs.flatten(-2), x[..., -1:]], dim=-1)
    # the step rounded to float32 on the host, as the JAX function's constant (no host-to-device copy)
    step = float(np.float32((n - 1) / (size - 1)))
    pos = torch.arange(size, dtype=torch.float32, device=x.device) * step
    lo = torch.clamp(torch.floor(pos).long(), 0, n - 1)
    hi = torch.clamp(torch.ceil(pos).long(), 0, n - 1)
    frac = pos - lo.float()
    return x[..., lo] * (1.0 - frac) + x[..., hi] * frac


def envelope_mixing(
    input_wav: torch.Tensor,
    output_wav: torch.Tensor,
    sample_rate: int,
    mix_rate,
) -> torch.Tensor:
    """Match ``output_wav``'s loudness envelope to ``input_wav``'s; ``mix_rate=1``
    leaves the output untouched (the exponent is 0 and the gain exactly 1).
    ``mix_rate`` is a number, a 0-d tensor or one per stream (``[B]`` for
    ``[B, n]`` signals); the exponent ``1 - mix_rate`` is taken in float32,
    as the JAX function takes it."""
    zc = sample_rate // 100
    out_len = output_wav.shape[-1]
    rms1 = rms_envelope(input_wav[..., :out_len], 4 * zc, zc)
    rms2 = rms_envelope(output_wav, 4 * zc, zc)
    rms1 = linear_interpolate_align_corners(rms1, out_len + 1)
    rms2 = torch.clamp(linear_interpolate_align_corners(rms2, out_len + 1), min=1e-3)
    mix_power = 1.0 - torch.as_tensor(mix_rate, dtype=torch.float32, device=output_wav.device)
    gain = (rms1[..., :out_len] / rms2[..., :out_len]) ** per_stream(mix_power, output_wav)
    return output_wav * gain
