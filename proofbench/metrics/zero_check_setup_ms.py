"""zero_check_setup_ms: milliseconds a prove spends in the span zero_check of
plonkish_tpu_torch's timer outside its child sum-check span
(sum_check_prove-<k>-<degree>): the span's self time, its duration less its
children's, over the proves the profiler did not record.

Despite the name, that is not the zero-check's set-up: the tables, the eq
polynomial and the tape are built inside the child span
(piop/sum_check.py:657).  It is the work after the sum-check: pcs_query, the
rotated queries' evaluations and their writing to the transcript
(backend/hyperplonk/prover.py:254-271).  Not declared: reading the set-up
needs a span around it in the program."""

from proofbench import spans


def read(ctx):
    from plonkish_tpu_torch.utils import timer

    def setup(root, req):
        zero = [r for r in req.children.get(root.id, []) if r.name == "zero_check"]
        if not zero:
            return None
        own = timer.self_seconds([r for z in zero for r in [z] + req.children.get(z.id, [])])
        return 1e3 * sum(own[z.id] for z in zero)

    return spans.per_prove(ctx, setup)
