"""Seconds from the start of the process to the window's first chunk:
imports, weights, the program's construction, graph capture, kernel builds
and warm-up."""


def read(ctx):
    return ctx.setup_s
