"""GB a job that the port's exchanges route, as the program counts them
(``exchange.bytes``, on the device, over the profiled window): every row
sent, read once and written once."""

import sys

UNIT = "GB"


def read(ctx):
    trace = sys.modules.get("sparkrdma_tpu_torch.utils.trace")
    counts = getattr(trace, "counts", None)
    total = counts().get("exchange.bytes") if counts else None
    if not total or not ctx.trace.jobs:
        return None
    return total / ctx.trace.jobs / 1e9
