"""device_idle_pct.prove: the share of the profiled proves in which the card
ran no operation: 100 minus the union of the device intervals that
torch.profiler recorded, over the profiled stretch."""


def read(ctx):
    if ctx.device is None:
        return None
    lo, hi = ctx.profiled
    return 100.0 * (1.0 - ctx.device.busy_seconds(lo, hi) / (hi - lo))
