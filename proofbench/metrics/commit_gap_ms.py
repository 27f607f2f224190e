"""commit_gap_ms: milliseconds a commit of the device stretch of its
kzg_commit-k root (plonkish_tpu_torch's timer) that lies in none of the
root's stages (the conversion, the recode, K1, K2, the read-back), over the
commits the profiler did not record."""

from proofbench import spans


def read(ctx):
    return spans.commit_gap_ms(ctx)
