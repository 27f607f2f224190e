# Copied from plonkish_tpu/fields/spec.py; imports resolve inside plonkish_tpu_torch.
"""Field specifications for the TPU-native plonkish framework.

The reference (amit0365/plonkish) takes BN254/Grumpkin/Pasta field and curve
arithmetic from the external `halo2_curves` crate
(plonkish_backend/src/util/arithmetic.rs:13-23).  Here the
field layer is a first-class build item: every prime field is described by a
`FieldSpec` holding the modulus and the Montgomery constants for the limb
layout used on device.

Device layout: a field element is a little-endian vector of NUM_DIGITS = 16
digits, DIGIT_BITS = 16 bits each, stored in uint32 lanes.  This is chosen for
the TPU VPU: a 16x16-bit product fits exactly in a uint32 lane, and column
sums of schoolbook multiplication stay below 2^22, so 254-bit modular
multiplication decomposes into pure u32 vector ops with no 64-bit emulation.
Values are kept in Montgomery form (x*R mod p with R = 2^256) on device.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np

DIGIT_BITS = 16
NUM_DIGITS = 16
DIGIT_MASK = (1 << DIGIT_BITS) - 1
R_BITS = DIGIT_BITS * NUM_DIGITS  # 256
R = 1 << R_BITS


def int_to_digits(x: int, num_digits: int = NUM_DIGITS) -> np.ndarray:
    """Little-endian 16-bit digit decomposition as uint32."""
    return np.array(
        [(x >> (DIGIT_BITS * i)) & DIGIT_MASK for i in range(num_digits)],
        dtype=np.uint32,
    )


def digits_to_int(digits) -> int:
    acc = 0
    for i, d in enumerate(np.asarray(digits, dtype=np.uint64).tolist()):
        acc |= int(d) << (DIGIT_BITS * i)
    return acc


@dataclasses.dataclass(frozen=True)
class FieldSpec:
    """A prime field together with its Montgomery limb constants."""

    name: str
    p: int  # modulus
    # Number of significant bits of p (e.g. 254 for BN254).
    num_bits: int = dataclasses.field(init=False)

    def __post_init__(self):
        object.__setattr__(self, "num_bits", self.p.bit_length())
        assert self.p % 2 == 1 and self.p < R

    # ---- Montgomery constants -------------------------------------------------
    @functools.cached_property
    def r_mod_p(self) -> int:
        return R % self.p

    @functools.cached_property
    def r2_mod_p(self) -> int:
        return (R * R) % self.p

    @functools.cached_property
    def n0_inv(self) -> int:
        """-p^{-1} mod 2^DIGIT_BITS (per-digit Montgomery factor)."""
        return (-pow(self.p, -1, 1 << DIGIT_BITS)) % (1 << DIGIT_BITS)

    @functools.cached_property
    def p_prime(self) -> int:
        """-p^{-1} mod R (full-width Montgomery factor for one-shot REDC)."""
        return (-pow(self.p, -1, R)) % R

    @functools.cached_property
    def p_prime_digits(self) -> np.ndarray:
        return int_to_digits(self.p_prime)

    @functools.cached_property
    def p_digits(self) -> np.ndarray:
        return int_to_digits(self.p)

    @functools.cached_property
    def r_digits(self) -> np.ndarray:
        """Montgomery form of 1 (= R mod p)."""
        return int_to_digits(self.r_mod_p)

    @functools.cached_property
    def r2_digits(self) -> np.ndarray:
        return int_to_digits(self.r2_mod_p)

    # ---- host scalar helpers --------------------------------------------------
    def to_mont(self, x: int) -> int:
        return (x * R) % self.p

    def from_mont(self, x: int) -> int:
        return (x * pow(R, -1, self.p)) % self.p

    def __repr__(self):
        return f"FieldSpec({self.name})"


# BN254 (aka BN256/alt_bn128).  Fr is the scalar field used by all proving
# protocols; Fq is the base field of G1 (used for point coordinates).
BN254_FR = FieldSpec(
    "bn254::Fr",
    21888242871839275222246405745257275088548364400416034343698204186575808495617,
)
BN254_FQ = FieldSpec(
    "bn254::Fq",
    21888242871839275222246405745257275088696311157297823662689037894645226208583,
)

# Grumpkin forms a 2-cycle with BN254: its scalar field is BN254's base field
# and vice versa (reference: util/arithmetic.rs:40-46 TwoChainCurve).
GRUMPKIN_FR = BN254_FQ
GRUMPKIN_FQ = BN254_FR

# BLS12-381 scalar field (255 bits — fits the 16-digit/R=2^256 layout; the
# 381-bit base field would need a 24-digit layout and is out of scope until
# a curve protocol needs BLS G1 coordinates on device).
BLS12_381_FR = FieldSpec(
    "bls12_381::Fr",
    0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001,
)

# Pasta curves (pallas/vesta 2-cycle).
PALLAS_BASE = FieldSpec(
    "pasta::Fp",
    0x40000000000000000000000000000000224698FC094CF91B992D30ED00000001,
)
VESTA_BASE = FieldSpec(
    "pasta::Fq",
    0x40000000000000000000000000000000224698FC0994A8DD8C46EB2100000001,
)
PALLAS_SCALAR = VESTA_BASE
VESTA_SCALAR = PALLAS_BASE
