"""batch_open_ms: milliseconds a prove spends in the PCS batch open (its sum-check and the KZG open): the spans named pcs_batch_open-* of
plonkish_tpu_torch's timer, over the proves the profiler did not record."""


def read(ctx):
    seconds = ctx.span_seconds_per_request(lambda name: name.startswith("pcs_batch_open-"))
    return None if seconds is None else 1e3 * seconds
