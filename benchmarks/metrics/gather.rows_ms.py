"""Device ms a job of the port's ``mesh.take_rows`` spans: every row gather
(``take_rows``, one ``index_select``) wherever it runs, the sorts' row
gathers and the grouping before each exchange alike."""

UNIT = "ms"


def read(ctx):
    return ctx.span_ms("mesh.take_rows")
