"""Hand-written Hopper kernels and their plain PyTorch versions (the
counterpart of plonkish_tpu/pallas/).

Each wrapper takes its plain version for a tensor on the CPU, and for a CUDA
tensor launches its kernel or raises.  ``LAUNCHES`` counts kernel launches
per wrapper; it is read by ``chip_smoke.py`` to show that a run went through
the kernels.

``FIELDS`` and ``CURVES`` are the one table of what the kernels are built
for: the id that every entry point takes for a field (csrc/sumcheck.cu,
csrc/probe.cu, csrc/convert.cu, csrc/cpu_twin.cpp) or a curve (csrc/curve.cuh's CURVE_*), and
the field's struct in csrc/field.cuh.
"""

from ..curves.specs import BN254_G1, GRUMPKIN_G1, CurveSpec
from ..fields.spec import BN254_FQ, BN254_FR, FieldSpec

FIELDS = {BN254_FR.p: (0, "Fr"), BN254_FQ.p: (1, "Fq")}
CURVES = {BN254_G1.name: 0, GRUMPKIN_G1.name: 1}

LAUNCHES = {
    "msm_bucket_sums": 0,
    "msm_window_sums": 0,
    "sumcheck_round": 0,
    "sumcheck_fold": 0,
    "mont_mul_chain": 0,
    "ipa_base_fold": 0,
    "ipa_fold_affine": 0,
    "fs_round_message": 0,
    "fs_coeff_message": 0,
    "sumcheck_fused": 0,
    "sumcheck_fused_tail": 0,
    "field_convert": 0,
}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def field_id(spec: FieldSpec) -> int:
    """The field id of `spec`: the kernels are built for BN254 Fr (HyperPlonk
    over BN254) and BN254 Fq (over Grumpkin's scalar field)."""
    if spec.p not in FIELDS:
        raise NotImplementedError(f"the kernels are built for BN254 Fr and Fq, not {spec.name}")
    return FIELDS[spec.p][0]


def field_struct(spec: FieldSpec) -> str:
    """The struct of csrc/field.cuh that computes in `spec`."""
    field_id(spec)
    return FIELDS[spec.p][1]


def curve_id(curve: CurveSpec) -> int:
    """The curve id of `curve`: the kernels are built for BN254 G1 (KZG,
    Gemini, Zeromorph) and Grumpkin G1 (IPA, Hyrax)."""
    if curve.name not in CURVES:
        raise NotImplementedError(f"the kernels are built for BN254 G1 and Grumpkin G1, "
                                  f"not {curve.name}")
    return CURVES[curve.name]
