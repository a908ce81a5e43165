"""The grouping by destination's share of its HBM roofline: the bytes the
program counts for its groupings (``exchange.group_bytes``: each
destination read and each index written by the partition, each picked row
read and written and its index read by the row gather) at 3.35 TB/s, over
the device time of the ``exchange.group`` spans."""

import sys

UNIT = "%"


def read(ctx):
    trace = sys.modules.get("sparkrdma_tpu_torch.utils.trace")
    counts = getattr(trace, "counts", None)
    total = counts().get("exchange.group_bytes") if counts else None
    ms = ctx.span_ms("exchange.group")
    if not total or not ms:
        return None
    per_job = total / ctx.trace.jobs
    return 100 * per_job / ctx.hbm_bytes_per_s / (ms / 1e3)
