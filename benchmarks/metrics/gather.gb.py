"""GB a job that the port's row gathers must move, as the program counts
them (``gather.bytes``, from shapes, over the profiled window): each
picked row read and written, and its 8-byte index read."""

import sys

UNIT = "GB"


def read(ctx):
    trace = sys.modules.get("sparkrdma_tpu_torch.utils.trace")
    counts = getattr(trace, "counts", None)
    total = counts().get("gather.bytes") if counts else None
    if not total or not ctx.trace.jobs:
        return None
    return total / ctx.trace.jobs / 1e9
