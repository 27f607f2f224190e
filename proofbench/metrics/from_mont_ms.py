"""from_mont_ms: milliseconds a commit's conversion of the evaluations out of
Montgomery form (limb.from_mont in MultilinearKzg.commit) stretches over on
the card, the card's idle time inside it included: the device stretch of the
stage kzg_from_mont-k under each kzg_commit-k root of plonkish_tpu_torch's
timer, over the commits the profiler did not record."""

from proofbench import spans


def read(ctx):
    return spans.commit_stage_ms(ctx, "kzg_from_mont")
