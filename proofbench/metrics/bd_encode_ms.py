"""bd_encode_ms: milliseconds a commit's encoding of its rows (the code's
sparse products, csrc/brakedown.cu via pcs/brakedown_code.py
encode_columns) stretches over on the card, the card's idle time inside it
included: the device stretch of the stage brakedown_encode-k under each
brakedown_commit-k root of plonkish_tpu_torch's timer, over the commits the
profiler did not record."""

from proofbench import brakedown_stages


def read(ctx):
    return brakedown_stages.stage_ms(ctx, ["brakedown_encode"])
