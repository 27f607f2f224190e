"""The conversion between Montgomery and canonical form (csrc/convert.cu),
built for the host with g++ (csrc/cpu_twin.cpp ``twin_field_convert``) and
launched through the wrapper's own launch logic (kernels/field.py
``convert_launch``), against ``limb.from_mont`` / ``limb.to_mont``'s plain
path and ``FieldSpec.from_mont`` / ``to_mont`` on Python ints, for BN254 Fr
and Fq in both directions."""

import ctypes
import random

import pytest
import torch

from plonkish_tpu_torch import kernels
from plonkish_tpu_torch.fields import limb
from plonkish_tpu_torch.fields.spec import BLS12_381_FR, BN254_FQ, BN254_FR
from plonkish_tpu_torch.kernels import build
from plonkish_tpu_torch.kernels import field as kfield

# Tensors here are tiny: one intra-op thread is faster, and keeps parallel
# test workers from oversubscribing the cores.
torch.set_num_threads(1)

SPECS = {"fr": BN254_FR, "fq": BN254_FQ}
R = 1 << 256


@pytest.fixture(scope="module")
def twin():
    try:
        path = build.build_cpu_twin()
    except FileNotFoundError as e:
        pytest.skip(f"no host C++ compiler: {e}")
    lib = ctypes.CDLL(str(path))
    return build.bind(lib.twin_field_convert, kfield.CONVERT_ARGS)


def _twin(fn, spec, x, direction):
    k = 1 if direction == "from" else spec.r2_mod_p
    return kfield.convert_launch(fn, None, spec, x, k)


def _plain(spec, x, direction):
    return limb.from_mont(spec, x) if direction == "from" else limb.to_mont(spec, x)


def _ints(spec, vals, direction):
    return [spec.from_mont(v) if direction == "from" else spec.to_mont(v) for v in vals]


def _values(spec, n, seed):
    """n values below p: 0, 1, p - 1, R mod p, R^2 mod p, then random ones."""
    rng = random.Random(seed)
    edge = [0, 1, spec.p - 1, spec.r_mod_p, spec.r2_mod_p]
    return (edge + [rng.randrange(spec.p) for _ in range(max(0, n - len(edge)))])[:n]


@pytest.mark.parametrize("n", [0, 1, 3, 4097])
@pytest.mark.parametrize("direction", ["from", "to"])
@pytest.mark.parametrize("field", ["fr", "fq"])
def test_twin_equals_plain_and_ints(twin, field, direction, n):
    spec = SPECS[field]
    vals = _values(spec, n, 11 + n)
    x = limb.from_ints(vals) if n else limb.zeros((0,))
    before = kernels.LAUNCHES["field_convert"]
    got = _twin(twin, spec, x, direction)
    assert kernels.LAUNCHES["field_convert"] == before + (1 if n else 0)
    assert got.shape == x.shape and got.dtype == torch.int32
    assert torch.equal(got, _plain(spec, x, direction))
    assert limb.to_ints(got) == _ints(spec, vals, direction)


@pytest.mark.parametrize("direction", ["from", "to"])
@pytest.mark.parametrize("field", ["fr", "fq"])
def test_twin_on_a_view_that_is_not_contiguous(twin, field, direction):
    spec = SPECS[field]
    rows, cols = 5, 7
    base = limb.from_ints(_values(spec, rows * cols, 3)).reshape(cols, rows, 8)
    x = base.transpose(0, 1)  # [rows, cols, 8], not contiguous
    assert not x.is_contiguous()
    got = _twin(twin, spec, x, direction)
    assert got.shape == (rows, cols, 8)
    assert torch.equal(got, _plain(spec, x, direction))
    assert torch.equal(base, limb.from_ints(_values(spec, rows * cols, 3)).reshape(cols, rows, 8))


@pytest.mark.parametrize("field", ["fr", "fq"])
def test_twin_round_trip(twin, field):
    spec = SPECS[field]
    x = limb.from_ints(_values(spec, 300, 5))
    mont = _twin(twin, spec, x, "to")
    assert torch.equal(_twin(twin, spec, mont, "from"), x)


@pytest.mark.parametrize("field", ["fr", "fq"])
def test_twin_reduces_values_above_p(twin, field):
    """to_mont of a digest below 2^256 but not below p (pcs/ipa.py's hash to
    the curve) comes out reduced, as the plain product gives it."""
    spec = SPECS[field]
    rng = random.Random(9)
    vals = [R - 1, spec.p, 2 * spec.p + 5] + [rng.randrange(R) for _ in range(61)]
    x = limb.from_ints(vals)
    got = _twin(twin, spec, x, "to")
    assert torch.equal(got, limb.to_mont(spec, x))
    assert limb.to_ints(got) == [v * R % spec.p for v in vals]


def test_twin_grid_stride(twin, monkeypatch):
    """One block of threads loops over 4097 elements (five passes of E per
    thread), as a launch capped at MAX_BLOCKS does at 2^20."""
    monkeypatch.setattr(kfield, "MAX_BLOCKS", 1)
    x = limb.from_ints(_values(BN254_FR, 4097, 7))
    assert torch.equal(_twin(twin, BN254_FR, x, "from"), limb.from_mont(BN254_FR, x))


def test_launch_rejects_what_the_kernel_is_not_built_for(twin):
    x = limb.from_ints([1, 2])
    with pytest.raises(NotImplementedError):
        kfield.convert_launch(twin, None, BLS12_381_FR, x, 1)
    with pytest.raises(ValueError):
        kfield.convert_launch(twin, None, BN254_FR, x.to(torch.int64), 1)
    with pytest.raises(ValueError):
        kfield.convert_launch(twin, None, BN254_FR, x[:, :4], 1)
    with pytest.raises(ValueError):
        kfield.convert_launch(twin, None, BN254_FR, x, BN254_FR.p)
    with pytest.raises(ValueError):
        kfield.field_convert_cuda(BN254_FR, x, 1)


def test_cpu_tensors_take_the_plain_path():
    before = kernels.LAUNCHES["field_convert"]
    x = limb.from_ints(_values(BN254_FR, 9, 1))
    assert limb.to_ints(limb.from_mont(BN254_FR, x)) == _ints(BN254_FR, _values(BN254_FR, 9, 1), "from")
    assert kernels.LAUNCHES["field_convert"] == before
