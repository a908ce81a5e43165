"""Device ms a job of the port's ``als.gram`` spans: the normal equations'
sums, each chunk's gather of the other side's factors, its outer products
and its ``index_add_`` sums into the entities' float32 equations."""

UNIT = "ms"


def read(ctx):
    return ctx.span_ms("als.gram")
