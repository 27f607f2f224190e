"""msm_bucket_ms: milliseconds a commit's K1 levels, the bucket sums
(csrc/msm.cuh via kernels/msm.py bucket_sums), stretch over on the card, the
card's idle time inside them included: the device stretch of the stage
msm_bucket_sums-k under each kzg_commit-k root of plonkish_tpu_torch's
timer, over the commits the profiler did not record."""

from proofbench import spans


def read(ctx):
    return spans.commit_stage_ms(ctx, "msm_bucket_sums")
