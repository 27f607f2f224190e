"""zero_check_setup_ms: milliseconds a prove spends in the zero-check outside
its sum-check rounds (the tables, the eq polynomial, the tape): the self
time of the span zero_check of plonkish_tpu_torch's timer, its duration
less its children's, over the proves the profiler did not record."""

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
