"""Device ms a job of the port's ``q64.pair_lookup`` spans: the two
lookups on 64-bit (item, ticket) and (item, order) pairs inside the pair
joins, each the pairs made from the received rows, the sort of one side
and the binary search of the other."""

UNIT = "ms"


def read(ctx):
    return ctx.span_ms("q64.pair_lookup")
