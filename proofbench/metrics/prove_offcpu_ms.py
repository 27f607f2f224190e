"""prove_offcpu_ms: milliseconds of a prove in which its thread ran on no
CPU (waiting on the card, on a lock, on the page cache, or runnable and not
scheduled): the hyperplonk_prove-k root span's wall time less the thread's
CPU time over it (plonkish_tpu_torch's timer), over the proves the profiler
did not record."""

from proofbench import spans


def read(ctx):
    return spans.per_prove(ctx, lambda root, req: 1e3 * (root.seconds - root.cpu_s))
