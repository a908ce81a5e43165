"""The range step's receive merge's share of its HBM roofline: the bytes
the program counts for it (``fused.merge_bytes``: each received row read
and every output row written) at 3.35 TB/s, over the device time of the
``fused.receive_sort`` spans."""

import sys

UNIT = "%"


def read(ctx):
    trace = sys.modules.get("sparkrdma_tpu_torch.utils.trace")
    counts = getattr(trace, "counts", None)
    total = counts().get("fused.merge_bytes") if counts else None
    ms = ctx.span_ms("fused.receive_sort")
    if not total or not ms:
        return None
    per_job = total / ctx.trace.jobs
    return 100 * per_job / ctx.hbm_bytes_per_s / (ms / 1e3)
