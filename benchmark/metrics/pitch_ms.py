"""Device ms of the pitch stages' graphs (``mel``, ``salience``,
``pitch_post``), each replayed alone after the window, summed."""

STAGES = ("mel", "salience", "pitch_post")


def read(ctx):
    if not ctx.stage_ms or not all(s in ctx.stage_ms for s in STAGES):
        return None
    return sum(ctx.stage_ms[s] for s in STAGES)
