"""The port's roofline accounting (plonkish_tpu_torch/roofline.py): the tape
count against the reference's, the other counts against hand counts at k = 3,
the shares with a made-up peak, and the rule that a bound takes the larger of
the measured and the assumed multiply-add rate."""

import random

import pytest
import torch

from plonkish_tpu import roofline as ref_roofline
from plonkish_tpu.backend.hyperplonk.preprocessor import compose as ref_compose
from plonkish_tpu.fields.host import Fp as RefFp
from plonkish_tpu.fields.spec import BN254_FR as REF_FR
from plonkish_tpu.models import circuits as ref_circuits
from plonkish_tpu_torch import roofline
from plonkish_tpu_torch.backend.hyperplonk.preprocessor import compose
from plonkish_tpu_torch.curves import device as cdev
from plonkish_tpu_torch.curves.specs import GRUMPKIN_G1
from plonkish_tpu_torch.fields import limb
from plonkish_tpu_torch.fields.host import Fp
from plonkish_tpu_torch.fields.spec import BN254_FR
from plonkish_tpu_torch.kernels import ipa as kipa
from plonkish_tpu_torch.models import circuits
from plonkish_tpu_torch.piop.sum_check import ProverState, VirtualPolynomial
from plonkish_tpu_torch.poly.multilinear import MLPoly

torch.set_num_threads(1)

Q = GRUMPKIN_G1.base.p
CIRCUITS = ["rand_vanilla_plonk_circuit", "rand_vanilla_plonk_with_lookup_circuit"]


def _expression(name, k=4):
    info, _ = getattr(circuits, name)(BN254_FR, k, random.Random(1), random.Random(2))
    num_z, expr = compose(info)
    num_polys = (info.num_poly() + len(info.permutation_polys())
                 + 2 * len(info.lookups) + num_z)
    return expr, num_polys


@pytest.mark.parametrize("name", CIRCUITS)
def test_expression_mul_count_equals_reference(name):
    expr, _ = _expression(name)
    ref_info, _ = getattr(ref_circuits, name)(REF_FR, 4, random.Random(1), random.Random(2))
    _, ref_expr = ref_compose(ref_info)
    vals = [random.Random(5).randrange(BN254_FR.p) for _ in range(3)]
    want = ref_roofline.expression_mul_count(REF_FR, ref_expr, [RefFp(v, REF_FR) for v in vals])
    got = roofline.expression_mul_count(BN254_FR, expr, [Fp(v, BN254_FR) for v in vals])
    assert got == want
    assert got == {CIRCUITS[0]: 22, CIRCUITS[1]: 35}[name]


@pytest.mark.parametrize("name", CIRCUITS)
def test_num_tables_is_the_prover_state(name):
    """sumcheck_num_tables counts what ProverState stacks."""
    k = 3
    expr, num_polys = _expression(name, k)
    challenges = [Fp(7 + i, BN254_FR) for i in range(3)]
    polys = [MLPoly(BN254_FR, limb.zeros((1 << k,))) for _ in range(num_polys)]
    y = [Fp(3 + i, BN254_FR) for i in range(k)]
    state = ProverState(BN254_FR, k, Fp.zero(BN254_FR),
                        VirtualPolynomial(expr, polys, challenges, [y]))
    assert roofline.sumcheck_num_tables(expr, num_polys) == state.stacked.shape[0]


def test_kernel_counts_by_hand():
    # K1: 10 entries in 4 buckets -> 6 mixed additions of 11 products of 256
    assert roofline.bucket_sums_work(8, 10, 4) == (6 * 11 * 256, 8 * 64 + 10 * 8 + 4 * 96)
    # K2: 3 windows of 5 buckets (c = 3) -> 2 full additions (16 products) per
    # bucket beyond bucket 0, then the combine: 3 * 3 doublings (7 products)
    # and 3 full additions; the buckets in, one point out
    k2_ops = (3 * 4 * 2 * 16 + 3 * 3 * 7 + 3 * 16) * 256
    assert roofline.window_sums_work(3, 5, 3) == (k2_ops, (15 + 1) * 96)
    assert roofline.JDBL_MULS == 7  # jac_dbl: 5 squarings, 2 products
    # K3 at k = 3, round 0: 4 pairs, degree 5, 22 products, + the identity leaf
    assert roofline.round_work(16, 4, 5, 22) == (4 * (5 * 22 + 1) * 256, 16 * 8 * 32)
    # K4: one product per output; 2 rows in, 1 out
    assert roofline.fold_work(16, 4) == (16 * 4 * 256, 16 * 4 * 96)
    # K5: chain products per element; a, b in, out out
    assert roofline.chain_work(1 << 22, 16) == ((1 << 22) * 16 * 256, (1 << 22) * 96)
    assert roofline.msm_mul_ops(10, 4, 3, 5, 3) == 6 * 11 * 256 + k2_ops
    assert roofline.msm_hbm_bytes(8, 10, 4, 3, 5, 3) == (8 * 64 + 10 * 8 + 4 * 96) + 16 * 96


def test_base_fold_counts_the_glv_split():
    """The IPA base fold's work in the design csrc/ipa.cu runs: xi's
    GLV halves as a width-2 NAF over the Eisenstein integers (a doubling
    per digit below the top, a mixed addition per nonzero digit below it),
    the table of 16 products unless every digit is +-1, one mixed addition
    for L, a batch inversion and the affine output (7 products a point)."""
    inv = (Q - 2).bit_length() + bin(Q - 2).count("1")  # one Fermat inversion
    out_bytes = 5 * 3 * 2 * 32
    # xi = 0: the fold is L; xi = 1: one digit, L + R and the affine output
    assert roofline.base_fold_work(GRUMPKIN_G1, 5, 0) == (0, out_bytes)
    assert roofline.base_fold_work(GRUMPKIN_G1, 5, 1) == ((5 * (11 + 7) + inv) * 256, out_bytes)
    # 11 = 16 - 4 - 1: digits 1 0 -1 0 -1, 4 doublings, 2 additions after the top
    assert kipa.digits(GRUMPKIN_G1, 11) == [16, 0, 24, 0, 24]
    assert roofline.base_fold_work(GRUMPKIN_G1, 5, 11) == (
        (5 * (4 * 7 + 2 * 11 + 11 + 7) + inv) * 256, out_bytes)
    # a random xi: about 126 digits, 3/7 of them nonzero
    xi = random.Random(6).randrange(GRUMPKIN_G1.scalar.p)
    k1, k2 = (abs(v) for v in cdev._glv_split(GRUMPKIN_G1, xi))
    assert max(k1, k2).bit_length() <= 130
    codes = kipa.digits(GRUMPKIN_G1, xi)
    nonzero = sum(1 for c in codes if c)
    per_point = 16 + 7 * (len(codes) - 1) + 11 * (nonzero - 1) + 11 + 7
    ops, _ = roofline.base_fold_work(GRUMPKIN_G1, 1 << 19, xi)
    assert ops == ((1 << 19) * per_point + inv) * 256
    assert per_point < 1600
    # its two kernels: the ladder (Jacobian out) and the conversion
    ladder_ops, ladder_bytes = roofline.fold_ladder_work(GRUMPKIN_G1, 1 << 19, xi)
    affine_ops, affine_bytes = roofline.fold_affine_work(GRUMPKIN_G1, 1 << 19)
    assert ladder_ops + affine_ops == ops
    assert (ladder_bytes, affine_bytes) == ((1 << 19) * 7 * 32, (1 << 19) * 5 * 32)


def test_round_message_latency_bound():
    """K6's least time is its shortest dependent chain: 24 rounds of 7
    dependent instructions a permutation at 4 cycles each, and the products
    on the chain: one out of Montgomery form, then a balanced tree of a
    Lagrange term's degree + 1 factors (4 at degree 5; 3 in the
    Coefficients round)."""
    assert [roofline.fs_round_latency_products(d) for d in (1, 2, 3, 4, 5, 7, 8, 32)] == [
        2, 3, 3, 4, 4, 4, 5, 7]
    assert roofline.FS_COEFF_LATENCY_PRODUCTS == 3
    assert roofline.fs_permutations(32, 6) == 2 and roofline.fs_permutations(32, 3) == 1
    ms = roofline.fs_latency_ms(2, 6, 1e-7, clock_hz=2e9)
    assert ms == pytest.approx((2 * 24 * 7 * 4 / 2e9 + 6e-7) * 1e3)
    assert roofline.fs_latency_ms(1, 4, 0.0, clock_hz=2e9) < ms


def test_sumcheck_counts_by_hand_at_k3():
    expr, num_polys = _expression(CIRCUITS[0], 3)
    challenges = [Fp(7 + i, BN254_FR) for i in range(3)]
    tables = roofline.sumcheck_num_tables(expr, num_polys)
    assert (tables, expr.degree()) == (16, 5)
    # rounds of 4, 2 and 1 pairs: 7 pairs in all
    per_pair = 5 * 22 + 1 + tables  # K3's products and K4's, per pair
    assert roofline.sumcheck_mul_ops(BN254_FR, expr, 3, tables, challenges) == 7 * per_pair * 256
    # per round: the state read by K3, read again and written halved by K4
    assert roofline.sumcheck_hbm_bytes(3, tables) == tables * 32 * (14 + 14 + 7)
    # the same traffic model as the reference's packed state
    assert roofline.sumcheck_hbm_bytes(3, tables) == ref_roofline.sumcheck_hbm_bytes(3, tables)


def _peaks(measured, assumed=1000.0):
    return {"imad_per_s_measured": measured, "imad_per_s_assumed": assumed,
            "hbm_bytes_per_s": 100.0}


def test_roofline_pct_with_a_fake_peak():
    peaks = _peaks(measured=500.0)
    assert roofline.roofline_pct(250, 1.0, peaks) == pytest.approx(25.0)
    assert roofline.roofline_pct(250, 0.5, peaks) == pytest.approx(50.0)
    assert roofline.roofline_pct(30, 1.0, peaks, kind="hbm_bytes") == pytest.approx(30.0)
    assert roofline.roofline_pct(250, 1.0, None) is None  # no card, no share
    assert roofline.roofline_pct(250, 0.0, peaks) is None


def test_bounds_pick_the_larger_rate():
    low, high = _peaks(measured=500.0), _peaks(measured=2000.0)
    assert roofline.imad_rate(low) == (1000.0, "assumed")
    assert roofline.imad_rate(high) == (2000.0, "measured")
    assert roofline.imad_rate(None) == (132 * 64 * 1.98e9, "assumed")
    # 4000 operations, 100 bytes: by operations at either rate, and the faster
    # rate gives the smaller, the least, time
    assert roofline.bound_ms(4000, 100, low) == (4000.0, "operations", "assumed")
    assert roofline.bound_ms(4000, 100, high) == (2000.0, "operations", "measured")
    assert roofline.bound_ms(10, 400, high) == (4000.0, "bytes", "measured")
    ms, by, source = roofline.bound_ms(*roofline.fold_work(16, 1 << 19))
    assert by == "bytes" and source == "assumed"
    assert ms == pytest.approx(16 * (1 << 19) * 96 / 3.35e12 * 1e3)
    assert roofline.roofline_pct(250, 1.0, high) == pytest.approx(12.5)


def test_peaks_hold_no_tpu_figure():
    assert roofline.PEAKS["hbm_bytes_per_s"] == 3.35e12
    assert roofline.imad_assumed_per_s() == 132 * 64 * 1.98e9
    assert roofline.FE_MUL_IMAD == 256


def test_fused_bound_sums_each_rounds_larger_bound_and_the_chain():
    """K7's bound: per round the larger of K3's and K4's bounds, plus K6's
    chain; by hand over three rounds from 4 pairs with a made-up peak."""
    peaks = _peaks(measured=0.0, assumed=1000.0)
    tables, degree, muls, chain = 16, 5, 22, 0.5
    want = 0.0
    for s in (4, 2, 1):
        k3 = max(s * (degree * muls + 1) * 256 / 1000.0, tables * 2 * s * 32 / 100.0) * 1e3
        k4 = max(tables * s * 256 / 1000.0, tables * s * 96 / 100.0) * 1e3
        want += max(k3, k4) + chain
    ms, by = roofline.fused_bound_ms(tables, 4, 3, degree, muls, chain, peaks)
    assert ms == pytest.approx(want) and by == "operations"
    # by bytes when the state's traffic outweighs the products and the chains
    assert roofline.fused_bound_ms(tables, 4, 3, 1, 0, 0.0, _peaks(0.0, 1e9))[1] == "bytes"
