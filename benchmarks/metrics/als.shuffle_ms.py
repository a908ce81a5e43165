"""Device ms a job of the ALS half-steps' shuffles: the ``als.group``
spans (each shard's grouping by the solving side's block, with the
counts' copy to the host) and the chunked exchange's rounds
(``chunked.slot_fill``, ``pack``, ``transport`` and ``land``)."""

UNIT = "ms"


def read(ctx):
    if ctx.span_ms("als.group") is None:
        return None
    return ctx.span_ms("als.group", "chunked.slot_fill", "chunked.pack",
                       "chunked.transport", "chunked.land")
