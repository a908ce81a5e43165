"""Device ms a job of the port's ``q95.date``, ``q95.addr`` and ``q95.site``
spans: the three dimension joins."""

UNIT = "ms"


def read(ctx):
    return ctx.span_ms("q95.date", "q95.addr", "q95.site")
