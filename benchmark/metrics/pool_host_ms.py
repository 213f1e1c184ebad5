"""The pool's own host work around the step, ms a tick: the mean over the
window's ticks of the controls, drain and merge phases the pool times
(``StreamPool.last_tick_phases``)."""

PHASES = ("controls_ms", "drain_ms", "merge_ms")


def read(ctx):
    ticks = [p for p in ctx.window["phases"] if all(k in p for k in PHASES)]
    if ctx.traffic["door"]["kind"] != "pool" or not ticks:
        return None
    return sum(sum(p[k] for k in PHASES) for p in ticks) / len(ticks)
