"""The normal equations' sums' share of their HBM roofline: the bytes the
program counts for them (``als.gram_bytes``, from shapes: each rating's
other-side factor, rating and entity id read, each entity's k*k + k
float32 sums written) at 3.35 TB/s, over the device time of the
``als.gram`` spans."""

import sys

UNIT = "%"


def read(ctx):
    trace = sys.modules.get("sparkrdma_tpu_torch.utils.trace")
    counts = getattr(trace, "counts", None)
    total = counts().get("als.gram_bytes") if counts else None
    ms = ctx.span_ms("als.gram")
    if not total or not ms:
        return None
    per_job = total / ctx.trace.jobs
    return 100 * per_job / ctx.hbm_bytes_per_s / (ms / 1e3)
