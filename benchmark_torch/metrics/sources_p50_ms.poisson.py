"""sources_p50_ms.poisson: median, over every message of the open loop's
window, of the time from when the message was due in the schedule to its
``sources`` frame at the client; a failed message counts as waited for
until the drain deadline. Host clock."""


def read(ctx):
    return ctx.arith.percentile(ctx.latencies_ms, 50) if ctx.latencies_ms else None
