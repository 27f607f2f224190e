"""zero_check_ms: milliseconds a prove spends in the zero-check (its set-up and sum-check rounds): the span zero_check of
plonkish_tpu_torch's timer, over the proves the profiler did not record."""


def read(ctx):
    seconds = ctx.span_seconds_per_request(lambda name: name == "zero_check")
    return None if seconds is None else 1e3 * seconds
