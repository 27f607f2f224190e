"""batch_open_sum_check_ms: milliseconds a prove spends in the PCS batch
open's sum-check (the Coefficients sum-check of pcs/additive.py): the spans
sum_check_prove-* whose parent is a pcs_batch_open-* span of
plonkish_tpu_torch's timer, over the proves the profiler did not record."""

from proofbench import spans


def read(ctx):
    def sum_check(root, req):
        opens = [r for r in req.children.get(root.id, []) if r.name.startswith("pcs_batch_open-")]
        found = [r for o in opens for r in req.children.get(o.id, [])
                 if r.name.startswith("sum_check_prove-")]
        return 1e3 * sum(r.seconds for r in found) if found else None

    return spans.per_prove(ctx, sum_check)
