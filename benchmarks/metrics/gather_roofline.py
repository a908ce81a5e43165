"""The row gather's share of its HBM roofline: the bytes the program counts
for its gathers (``gather.bytes``) at 3.35 TB/s, over the device time of
the ``mesh.take_rows`` spans."""

import sys

UNIT = "%"


def read(ctx):
    trace = sys.modules.get("sparkrdma_tpu_torch.utils.trace")
    counts = getattr(trace, "counts", None)
    total = counts().get("gather.bytes") if counts else None
    ms = ctx.span_ms("mesh.take_rows")
    if not total or not ms:
        return None
    per_job = total / ctx.trace.jobs
    return 100 * per_job / ctx.hbm_bytes_per_s / (ms / 1e3)
