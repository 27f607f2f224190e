"""bd_commit_gap_ms: milliseconds a commit of the device stretch of its
brakedown_commit-k root (plonkish_tpu_torch's timer) that lies in none of the
root's stages (the encoding, the conversion, the column hashes, the tree, the
read-back), over the commits the profiler did not record."""

from proofbench import brakedown_stages


def read(ctx):
    return brakedown_stages.gap_ms(ctx)
