"""commit_p95_ms: the 95th percentile of one commitment's time on the host
clock, over the window's commitments that the profiler did not record."""

import statistics


def read(ctx):
    lat = ctx.latencies[ctx.traced:]
    if len(lat) < 20:
        return None
    return 1e3 * statistics.quantiles(lat, n=20, method="inclusive")[18]
