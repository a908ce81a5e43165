"""The card's idle share of the traced window: 1 - the union of kernel,
copy and fill intervals over the window's wall time."""

UNIT = "%"


def read(ctx):
    if not ctx.device_traced:
        return None
    return 100 * (1 - ctx.trace.busy_s / ctx.trace.window_s)
