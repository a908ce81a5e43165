"""Device ms a job of the port's ``als.solve`` spans: each shard's
entities found, their normal equations (``als.gram``, nested), the
regularised diagonal and the batched ``torch.linalg.solve``."""

UNIT = "ms"


def read(ctx):
    return ctx.span_ms("als.solve")
