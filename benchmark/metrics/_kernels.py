"""Shared by the kernel roofline readers: the device time of the traced
kernels whose names hold one of the given markers, and the share of it the
kernels' bound takes."""


def device_s(trace, markers) -> float:
    return sum(e - s for name, s, e in trace["device"] if any(m in name for m in markers)) / 1e6


def share_pct(trace, markers, bound_ms_per_step: float):
    """``100 * bound / time`` over the traced steps; None when no such kernel ran."""
    if trace is None:
        return None
    t = device_s(trace, markers)
    if t <= 0 or bound_ms_per_step <= 0:
        return None
    return 100.0 * bound_ms_per_step * 1e-3 * trace["steps"] / t
