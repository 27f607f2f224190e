"""witness_ms: milliseconds a prove spends in the witness upload (synthesis of the columns and MLPoly.from_fps): the span witness_collector-0 of
plonkish_tpu_torch's timer, over the proves the profiler did not record."""


def read(ctx):
    seconds = ctx.span_seconds_per_request(lambda name: name == "witness_collector-0")
    return None if seconds is None else 1e3 * seconds
