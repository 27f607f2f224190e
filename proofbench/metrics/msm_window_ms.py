"""msm_window_ms: milliseconds a commit's K2 levels and window combine
(kernels/msm.py window_sums) stretch over on the card, the card's idle time
inside them included: the device stretch of the stage msm_window_sums-k
under each kzg_commit-k root of plonkish_tpu_torch's timer, over the commits
the profiler did not record."""

from proofbench import spans


def read(ctx):
    return spans.commit_stage_ms(ctx, "msm_window_sums")
