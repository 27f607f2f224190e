"""The port's struct-of-arrays field arithmetic (fields/soa.py) against the
reference's (plonkish_tpu/fields/soa.py, plain jnp on the CPU), for BN254 Fr
and Fq: the same Montgomery elements, made from a numpy seed plus the edge
rows of the probe kernel's check, go through both.  Exact equality of every
digit (tolerance 0: these are field elements)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plonkish_tpu.fields import soa as ref_soa
from plonkish_tpu.fields.spec import BN254_FQ as REF_FQ, BN254_FR as REF_FR
from plonkish_tpu_torch import convert
from plonkish_tpu_torch.fields import limb, soa
from plonkish_tpu_torch.fields.spec import BN254_FQ, BN254_FR

torch.set_num_threads(1)

SPECS = {"fr": (BN254_FR, REF_FR), "fq": (BN254_FQ, REF_FQ)}
N = 48


def edge_values(p):
    """Montgomery-form edge rows: 0, 1, p - 1, R mod p, R^2 mod p and
    2^255 - 19 reduced."""
    r = (1 << 256) % p
    return [0, 1, p - 1, r, r * r % p, ((1 << 255) - 19) % p]


def _mont_digits(p, seed):
    """uint32[N, 16] digits of N elements below p: the edge rows, then random
    ones; rows 6 and 7 are set equal between the two operands by the caller."""
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 1 << 32, size=(N, 8), dtype=np.uint64)
    vals = [sum(int(w) << (32 * i) for i, w in enumerate(row)) % p for row in words]
    vals[: len(edge_values(p))] = edge_values(p)
    return np.array(
        [[(v >> (16 * i)) & 0xFFFF for i in range(16)] for v in vals], dtype=np.uint32
    )


def _operands(field):
    spec, ref_spec = SPECS[field]
    a, b = _mont_digits(spec.p, 1), _mont_digits(spec.p, 2)[::-1].copy()
    b[6:8] = a[6:8]  # two equal operands
    ref = tuple([jnp.asarray(x[:, i]) for i in range(16)] for x in (a, b))
    ours = tuple(convert.soa_from_reference([x[:, i] for i in range(16)])[0] for x in (a, b))
    return spec, ref_spec, ours, ref


def _ref_mul_u32(sp, x, y):
    """The reference's integer path whatever its environment switch says."""
    return ref_soa._redc(sp, ref_soa._carry_chain(ref_soa._mul_columns(x, y))[:33])


def _ref_sqr_u32(sp, x):
    return ref_soa._redc(sp, ref_soa._carry_chain(ref_soa._sqr_columns(x))[:33])


BINARY = {
    "mont_mul": (soa.mont_mul, _ref_mul_u32),
    "mont_mul_f32": (soa.mont_mul_f32, ref_soa.mont_mul_f32),
    "add": (soa.add, ref_soa.add),
    "sub": (soa.sub, ref_soa.sub),
}
UNARY = {
    "mont_sqr": (soa.mont_sqr, _ref_sqr_u32),
    "mont_sqr_f32": (soa.mont_sqr_f32, ref_soa.mont_sqr_f32),
    "neg": (soa.neg, ref_soa.neg),
}


def _assert_equal(got, want):
    want = [np.asarray(d, dtype=np.uint32) for d in want]
    got = convert.soa_to_reference(got)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert np.array_equal(g, w)


@pytest.mark.parametrize("field", ["fr", "fq"])
@pytest.mark.parametrize("op", sorted(BINARY))
def test_binary_ops_match_reference(field, op):
    spec, ref_spec, (a, b), (ra, rb) = _operands(field)
    ours, theirs = BINARY[op]
    _assert_equal(ours(spec, a, b), theirs(ref_spec, ra, rb))
    _assert_equal(ours(spec, b, a), theirs(ref_spec, rb, ra))


@pytest.mark.parametrize("field", ["fr", "fq"])
@pytest.mark.parametrize("op", sorted(UNARY))
def test_unary_ops_match_reference(field, op):
    spec, ref_spec, (a, _), (ra, _) = _operands(field)
    ours, theirs = UNARY[op]
    _assert_equal(ours(spec, a), theirs(ref_spec, ra))


@pytest.mark.parametrize("field", ["fr", "fq"])
def test_multipliers_agree_with_the_limb_layer(field):
    """The four products are the canonical a * b * R^-1 mod p of limb.mont_mul,
    on host integers too."""
    spec, _, (a, b), _ = _operands(field)
    at, bt = soa.to_tensor(a), soa.to_tensor(b)
    want = limb.mont_mul(spec, at, bt)
    assert torch.equal(soa.to_tensor(soa.mont_mul(spec, a, b)), want)
    assert torch.equal(soa.to_tensor(soa.mont_mul_f32(spec, a, b)), want)
    sq = limb.mont_mul(spec, at, at)
    assert torch.equal(soa.to_tensor(soa.mont_sqr(spec, a)), sq)
    assert torch.equal(soa.to_tensor(soa.mont_sqr_f32(spec, a)), sq)
    r_inv = pow(1 << 256, -1, spec.p)
    xs, ys = limb.to_ints(at), limb.to_ints(bt)
    assert limb.to_ints(want) == [x * y * r_inv % spec.p for x, y in zip(xs, ys)]


@pytest.mark.parametrize("field", ["fr", "fq"])
def test_internal_columns_match_reference(field):
    """The lazy columns and the float32 byte columns are the reference's."""
    spec, ref_spec, (a, b), (ra, rb) = _operands(field)
    _assert_equal(soa._mul_columns(a, b), ref_soa._mul_columns(ra, rb))
    _assert_equal(soa._mul_columns_low(a, b), ref_soa._mul_columns_low(ra, rb))
    _assert_equal(soa._sqr_columns(a), ref_soa._sqr_columns(ra))
    a8, b8 = soa._to_bytes_f32(a), soa._to_bytes_f32(b)
    ra8, rb8 = ref_soa._to_bytes_f32(ra), ref_soa._to_bytes_f32(rb)
    cols, ref_cols = soa._mul_columns_f32(a8, b8), ref_soa._mul_columns_f32(ra8, rb8)
    assert all(c.dtype == torch.float32 for c in cols)
    for c, rc in zip(cols, ref_cols):
        assert np.array_equal(c.numpy(), np.asarray(rc))
        assert float(c.max()) < 2 ** 24
    _assert_equal(soa._pair_bytes_u32(cols), ref_soa._pair_bytes_u32(ref_cols))
    _assert_equal(soa._pair_bytes_u32(soa._sqr_columns_f32(a8)),
                  ref_soa._pair_bytes_u32(ref_soa._sqr_columns_f32(ra8)))
    t = soa._carry_chain(soa._mul_columns(a, b))[:33]
    rt = ref_soa._carry_chain(ref_soa._mul_columns(ra, rb))[:33]
    _assert_equal(soa._redc_f32(spec, t), ref_soa._redc_f32(ref_spec, rt))


def test_layouts_and_helpers():
    spec, ref_spec, (a, b), (ra, _) = _operands("fr")
    t = soa.to_tensor(a)
    assert t.dtype == torch.int32 and t.shape == (N, 8)
    for x, y in zip(soa.from_tensor(t), a):
        assert torch.equal(x, y)
    wide = soa.to_wide(a)
    assert torch.equal(wide, limb.unpack(t))
    for x, y in zip(soa.from_wide(wide), a):
        assert torch.equal(x, y)
    ds, limbs = convert.soa_from_reference(convert.soa_to_reference(t))
    assert torch.equal(limbs, t) and torch.equal(limbs, convert.digits_to_limbs(
        np.stack(convert.soa_to_reference(a), axis=-1)))
    _assert_equal(soa.const(spec, 12345, a), ref_soa.const(ref_spec, 12345, ra))
    assert soa.is_zero(a).tolist() == [True] + [False] * (N - 1)
    same = soa.is_zero(soa.sub(spec, a, b))
    assert same[6] and same[7] and int(same.sum()) == 2
    picked = soa.select(same, a, soa.zeros_like(a))
    assert torch.equal(soa.to_tensor(picked)[6:8], t[6:8])
    assert int(soa.is_zero(picked).sum()) == N - 2
