"""The benchmark's own arithmetic: statistics over a window, the card's
published peaks, the operations and bytes of the program's hand kernels,
and the device's busy time in a profiler trace.

Copied, not imported, so that no change to the program moves the yardstick:

- ``chain_flops_bytes``, ``bank_flops_bytes`` and ``bound_ms`` from the
  repository's ``chip_smoke.py`` (each input and output byte counted once;
  the chain's block count and the bank's kernel sizes and dilations made
  arguments);
- the peaks and ``device_busy_ms`` from ``obs_rvc_tpu_torch/utils/benchlib.py``
  (busy time is the union of the device intervals: kernels in a replayed
  graph can overlap, and their sum can pass the wall time).
"""

from __future__ import annotations

import math

#: NVIDIA's data sheet for one H100 SXM at its full 700 W (dense rates)
BF16_PEAK_FLOPS = 989e12
F32_PEAK_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12
#: the peak a configuration's step is held to, by its dtype
PEAK_BY_DTYPE = {"bfloat16": BF16_PEAK_FLOPS, "float32": F32_PEAK_FLOPS}
#: activation bytes by dtype
ELEM = {"bfloat16": 2, "float32": 4}


def percentile(values, q: float) -> float:
    """The ``q``-th percentile of every value, linearly interpolated between
    the two nearest ranks (numpy's default rule)."""
    v = sorted(values)
    if not v:
        raise ValueError("percentile of no values")
    pos = (len(v) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


def chain_flops_bytes(B, H, W, cin, C, elem=4, welem=4, n_blocks=4):
    """Operations, and bytes: activations of ``elem`` bytes, weights of
    ``welem`` (bfloat16 packs hold 2), biases float32."""
    flops, wbytes, ci = 0, 0, cin
    for _ in range(n_blocks):
        flops += 2 * 9 * ci * C * H * W + 2 * 9 * C * C * H * W
        wbytes += welem * (9 * ci * C + 9 * C * C) + 4 * 2 * C
        if ci != C:
            flops += 2 * ci * C * H * W
            wbytes += welem * ci * C + 4 * C
        ci = C
    return B * flops, B * H * W * (cin + C) * elem + wbytes


def bank_flops_bytes(B, L, C, elem=4, welem=4, ks=(3, 7, 11), dils=(1, 3, 5)):
    """As :func:`chain_flops_bytes`; at the level's own C (a padded width's
    zero channels are no work the function needs)."""
    flops = B * sum(len(dils) * 2 * 2 * k * C * C * L for k in ks)
    wbytes = sum(len(dils) * 2 * (welem * k * C * C + 4 * C) for k in ks)
    return flops, 2 * B * L * C * elem + wbytes


def bound_ms(flops, nbytes, peak=F32_PEAK_FLOPS):
    """The least time of a kernel: the larger of operations over ``peak`` and bytes over HBM's rate."""
    t_ops, t_mem = flops / peak, nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_mem) * 1e3, ("operations" if t_ops >= t_mem else "bytes")


def intervals_union(spans):
    """``[(start, end), ...]`` merged, in start order."""
    out = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def busy(spans) -> float:
    """The time some span runs (the union's length), in the spans' unit."""
    return sum(e - s for s, e in intervals_union(spans))


def gaps(spans, start, end):
    """``[(gap_start, gap_end), ...]``: the times in ``[start, end]`` no span covers."""
    out, t = [], start
    for s, e in intervals_union(spans):
        if s > t:
            out.append((t, min(s, end)))
        t = max(t, e)
    if t < end:
        out.append((t, end))
    return [(s, e) for s, e in out if e > s]
