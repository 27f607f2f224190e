"""prove_minor_faults: the minor page faults the prover's thread took in a
prove (getrusage(RUSAGE_THREAD) over the hyperplonk_prove-k root span of
plonkish_tpu_torch's timer), over the proves the profiler did not record."""

from proofbench import spans


def read(ctx):
    return spans.per_prove(ctx, lambda root, req: float(root.minor_faults))
