"""sources_p95_ms.poisson: 95th percentile (nearest rank) of the times of
sources_p50_ms.poisson, over every message of the window. Host clock."""


def read(ctx):
    return ctx.arith.percentile(ctx.latencies_ms, 95) if ctx.latencies_ms else None
