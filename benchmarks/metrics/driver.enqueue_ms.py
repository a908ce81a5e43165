"""Host ms of one step call, no sync inside: the median over a few jobs
submitted one at a time onto an idle card, outside the profiler. In the
closed loop a call can also wait for room in the launch queue that the job
before filled; these jobs read the host's own work."""

import statistics

UNIT = "ms"


def read(ctx):
    return statistics.median(ctx.enqueue_ms) if ctx.enqueue_ms else None
