"""msm_recode_ms: milliseconds a commit's recode of the scalars into signed
digits, with their keys, sort and gather (curves/msm.py signed_digits and
msm_entries), stretches over on the card, the card's idle time inside it
included: the device stretch of the stage msm_recode-k under each
kzg_commit-k root of plonkish_tpu_torch's timer, over the commits the
profiler did not record."""

from proofbench import spans


def read(ctx):
    return spans.commit_stage_ms(ctx, "msm_recode")
