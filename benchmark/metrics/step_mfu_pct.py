"""The whole step's share of the card's peak: the configuration's FLOPs a
chunk (counted over the plain reference at one stream) times the chunks the
window completed, over the window's seconds, over the published dense peak
of the configuration's dtype (989 TFLOP/s in bfloat16)."""

from benchmark.yardstick import PEAK_BY_DTYPE


def read(ctx):
    flops = ctx.cfg.get("flops_per_chunk", {}).get("total")
    if not flops or not ctx.window["chunks"]:
        return None
    return 100.0 * flops * ctx.window["chunks"] / ctx.window["seconds"] / PEAK_BY_DTYPE[ctx.cfg["dtype"]]
