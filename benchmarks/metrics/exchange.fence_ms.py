"""Host ms a job that the port's cross-process exchanges spend in their
fences, as the program counts them (``exchange.fence_ns``, over the
profiled window): the read and all-gather of the counts, the shapes'
all-gather, the two stream synchronisations and the closing barrier.
Only a ``GlobalMesh`` exchange counts them."""

import sys

UNIT = "ms"


def read(ctx):
    trace = sys.modules.get("sparkrdma_tpu_torch.utils.trace")
    counts = getattr(trace, "counts", None)
    total = counts().get("exchange.fence_ns") if counts else None
    if not total or not ctx.trace.jobs:
        return None
    return total / ctx.trace.jobs / 1e6
