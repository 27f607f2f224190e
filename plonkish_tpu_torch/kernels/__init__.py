"""Hand-written Hopper kernels and their plain PyTorch versions (the
counterpart of plonkish_tpu/pallas/).

Each wrapper takes its plain version for a tensor on the CPU, and for a CUDA
tensor launches its kernel or raises.  ``LAUNCHES`` counts kernel launches
per wrapper; it is read by ``chip_smoke.py`` to show that a run went through
the kernels.
"""

LAUNCHES = {
    "msm_bucket_sums": 0,
    "msm_window_sums": 0,
    "sumcheck_round": 0,
    "sumcheck_fold": 0,
}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
