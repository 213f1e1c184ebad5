"""Device ms of the ``synth`` stage's graph, replayed alone after the window
(CUDA events around back-to-back replays), at the cell's streams a step."""


def read(ctx):
    if not ctx.stage_ms or "synth" not in ctx.stage_ms:
        return None
    return ctx.stage_ms["synth"]
