"""Device ms a job of the port's ``q64.catalog_group`` and ``q64.by_item``
spans: the two shuffles by item, where the hot items' shard receives the
most rows, and the sorts, segment sums and lookup on their receive
buffers."""

UNIT = "ms"


def read(ctx):
    return ctx.span_ms("q64.catalog_group", "q64.by_item")
