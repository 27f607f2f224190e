"""bd_readback_ms: milliseconds a commit's read-back of its canonical
codeword and Merkle tree to the host (pcs/brakedown.py _read_back, two copies
and the wait on them) stretches over on the card: the device stretch of the
stage brakedown_readback-k under each brakedown_commit-k root of
plonkish_tpu_torch's timer, over the commits the profiler did not record."""

from proofbench import brakedown_stages


def read(ctx):
    return brakedown_stages.stage_ms(ctx, ["brakedown_readback"])
