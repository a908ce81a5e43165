"""Device ms a job of the port's ``q95.aggregate.sort`` span: the two-pass
sort by (order, warehouse) and its row gather inside ``q95.aggregate``."""

UNIT = "ms"


def read(ctx):
    return ctx.span_ms("q95.aggregate.sort")
