"""permutation_ms: milliseconds a prove spends in the permutation's grand-product polynomials: the spans named permutation_z_polys-* of
plonkish_tpu_torch's timer, over the proves the profiler did not record."""


def read(ctx):
    seconds = ctx.span_seconds_per_request(lambda name: name.startswith("permutation_z_polys-"))
    return None if seconds is None else 1e3 * seconds
