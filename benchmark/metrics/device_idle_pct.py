"""The share of the traced slice's wall time in which no device operation
ran: 100 minus the union of the device intervals over the slice."""


def read(ctx):
    t = ctx.trace
    if t is None or t["window_s"] <= 0 or not t["device"]:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
