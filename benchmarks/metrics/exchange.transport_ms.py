"""Device ms a job of the port's ``exchange.transport`` spans: the transport of
every exchange."""

UNIT = "ms"


def read(ctx):
    return ctx.span_ms("exchange.transport")
