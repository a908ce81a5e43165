"""The arena copy-out's share of its HBM roofline: the bytes the program
counts for it (``exchange.arena_copy_bytes``: rows copied × row bytes ×
2) at 3.35 TB/s, over the device time of the ``exchange.arena_copy``
spans."""

import sys

UNIT = "%"


def read(ctx):
    trace = sys.modules.get("sparkrdma_tpu_torch.utils.trace")
    counts = getattr(trace, "counts", None)
    total = counts().get("exchange.arena_copy_bytes") if counts else None
    ms = ctx.span_ms("exchange.arena_copy")
    if not total or not ms:
        return None
    per_job = total / ctx.trace.jobs
    return 100 * per_job / ctx.hbm_bytes_per_s / (ms / 1e3)
