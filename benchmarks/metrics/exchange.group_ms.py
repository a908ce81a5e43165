"""Device ms a job of the port's ``exchange.group`` spans: the per-shard
grouping of rows by destination (a sort and a row gather) before each
shuffle exchange."""

UNIT = "ms"


def read(ctx):
    return ctx.span_ms("exchange.group")
