"""Device ms a job of the port's ``fused.local_sort`` span."""

UNIT = "ms"


def read(ctx):
    return ctx.span_ms("fused.local_sort")
