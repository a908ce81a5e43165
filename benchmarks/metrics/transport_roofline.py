"""The transport's share of its HBM roofline: the bytes the job's
exchanges must move (each row read once and written once, counted by the
job module from the workload) at 3.35 TB/s, over the device time of the
``exchange.transport`` spans."""

UNIT = "%"


def read(ctx):
    ms = ctx.span_ms("exchange.transport")
    if not ms:
        return None
    return 100 * ctx.exchange_bytes / ctx.hbm_bytes_per_s / (ms / 1e3)
