"""Seconds of converted audio pulled from every stream, over the window's
seconds: the real-time streams the card carries."""


def read(ctx):
    return ctx.window["audio_s"] / ctx.window["seconds"]
