"""Device ms a job of the port's ``exchange.arena_copy`` spans: the copy
of each local receiver's rows out of the receive arena after a
cross-process exchange."""

UNIT = "ms"


def read(ctx):
    return ctx.span_ms("exchange.arena_copy")
