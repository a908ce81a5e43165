"""Device ms a job of the port's ``q64.catalog_join`` and ``q64.store_join``
spans: the two pair joins, each two shuffles by pair and the pair lookup."""

UNIT = "ms"


def read(ctx):
    return ctx.span_ms("q64.catalog_join", "q64.store_join")
