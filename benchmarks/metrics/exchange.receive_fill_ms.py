"""Device ms a job of the port's ``exchange.receive_fill`` spans: the zero
fill of every exchange's receive buffer."""

UNIT = "ms"


def read(ctx):
    return ctx.span_ms("exchange.receive_fill")
