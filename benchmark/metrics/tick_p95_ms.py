"""95th percentile, over every tick of the window, of the host time of the
pool's ``process_pending`` and the pull of every slot's output (pool doors)."""

from benchmark.yardstick import percentile


def read(ctx):
    if ctx.traffic["door"]["kind"] != "pool" or not ctx.window["step_ms"]:
        return None
    return percentile(ctx.window["step_ms"], 95)
