"""95th percentile, over every chunk of the window, of the host time from
handing a chunk to the session to pulling its converted audio (session doors)."""

from benchmark.yardstick import percentile


def read(ctx):
    if ctx.traffic["door"]["kind"] != "session" or not ctx.window["step_ms"]:
        return None
    return percentile(ctx.window["step_ms"], 95)
