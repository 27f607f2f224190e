"""The port's flags (port of plonkish_tpu/config.py), read from the
environment at each call, under the JAX package's names and defaults:

| Env var                 | Values | Meaning                                     |
|-------------------------|--------|---------------------------------------------|
| PLONKISH_TPU_TIMER      | 0/1    | timing spans (utils/timer.py reads it once, at import, as the reference's timer does): each span's (name, depth, seconds), and its record (id, parent, root, host start and end, the counters launches, ints_in, ints_out, device_reads; thread CPU time, faults and context switches of a span that synchronises; the card's stretch of a stage that does not synchronise, from the request's first event) |
| PLONKISH_TPU_SANITY     | 0/1    | the reference's `sanity-check` feature: O(2^k) self-checks in the provers |
| PLONKISH_TPU_DEVICE_FS  | 1/0    | the sum-check's transcript sponge on the card (piop/fiat_shamir.py) |
| PLONKISH_TPU_FUSED_ROUNDS | 1/0  | under the device transcript, an Evaluations sum-check's rounds from the handover on as one launch of K7 (kernels/sumcheck.py fused_rounds) |

The JAX package's ``backend()`` (its cpp or jax kernels) has no counterpart:
every entry point of the port takes a ``device`` argument, the card unless
the caller asks for the CPU, and that argument chooses where the work runs.
"""

from __future__ import annotations

import os


def timer_enabled() -> bool:
    return os.environ.get("PLONKISH_TPU_TIMER", "0") == "1"


def sanity_checks() -> bool:
    """Gate for the expensive internal assertions of the reference's
    `sanity-check` feature: the sum-check's round sums, the lookup h polys'
    sum, the permutation grand product, the KZG open's claims."""
    return os.environ.get("PLONKISH_TPU_SANITY", "0") == "1"


def device_fs() -> bool:
    """Device-resident Fiat-Shamir for the sum-check on the card: each round
    enqueues K3 -> K6 -> K4 with no host read, and the messages come back in
    one transfer (piop/sum_check.py DeviceFsRun).  Default on; set
    PLONKISH_TPU_DEVICE_FS=0 for the per-round host squeeze.  A prove on the
    CPU always takes the host squeeze."""
    return os.environ.get("PLONKISH_TPU_DEVICE_FS", "1") == "1"


def fused_rounds() -> bool:
    """Fused sum-check rounds under the device transcript: an Evaluations
    sum-check's rounds from the handover (piop/sum_check.py
    ``FUSED_MAX_PAIRS``) to the last run as one launch of K7, which loops
    over the rounds on the card (K3's sums, K6's message and K4's fold a
    round).  Default on; set PLONKISH_TPU_FUSED_ROUNDS=0 for K3 -> K6 -> K4
    launched each round.  The Coefficients sum-check and the rounds whose
    rows are sharded over a mesh keep their per-round launches."""
    return os.environ.get("PLONKISH_TPU_FUSED_ROUNDS", "1") == "1"
