"""bd_from_mont_ms: milliseconds a commit's conversion of the codeword out
of Montgomery form (limb.from_mont in MultilinearBrakedown.commit,
csrc/convert.cu, the kernel the KZG commit's conversion runs) stretches over
on the card, the card's idle time inside it included: the device stretch of
the stage brakedown_from_mont-k under each brakedown_commit-k root of
plonkish_tpu_torch's timer, over the commits the profiler did not record."""

from proofbench import brakedown_stages


def read(ctx):
    return brakedown_stages.stage_ms(ctx, ["brakedown_from_mont"])
