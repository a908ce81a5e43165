"""Device ms a job of the port's ``q95.by_order`` and ``q95.aggregate`` spans:
the co-location by order and the per-order reductions."""

UNIT = "ms"


def read(ctx):
    return ctx.span_ms("q95.by_order", "q95.aggregate")
