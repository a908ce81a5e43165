"""Device ms a job of the port's ``lookup.unique`` spans: every unique-key
lookup of the query plans (q95's dimension rounds and returns semi-join,
q64's pair joins, date join and ``cs_ui`` semi-join), each a table
cleared, built from the live dimension rows and probed by the live
probes. A program without the span reads nothing."""

UNIT = "ms"


def read(ctx):
    return ctx.span_ms("lookup.unique")
