"""Device ms a job of the port's ``fused.receive_sort`` span."""

UNIT = "ms"


def read(ctx):
    return ctx.span_ms("fused.receive_sort")
