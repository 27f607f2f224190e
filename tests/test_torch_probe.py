"""Kernel K5, the mont_mul chain probe (kernels/probe.py, csrc/probe.cu).

The plain version is held against the body of the reference's chain kernel
(scripts/validate_pallas_tpu.py::_chain_kernel) run through its plain
reference, a Python loop of soa.mont_mul / soa.mont_mul_f32 on jnp arrays
(the script itself configures JAX at import and is not imported), and against
host integers.  The CUDA source's body and fe_mul_f32, built for the host with
g++, are held against the plain version.  Exact equality throughout."""

import ctypes

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plonkish_tpu.fields import soa as ref_soa
from plonkish_tpu.fields.spec import BN254_FQ as REF_FQ, BN254_FR as REF_FR
from plonkish_tpu_torch import convert
from plonkish_tpu_torch.fields import limb
from plonkish_tpu_torch.fields.spec import BN254_FQ, BN254_FR
from plonkish_tpu_torch.kernels import LAUNCHES, build, probe

torch.set_num_threads(1)

SPECS = {"fr": (BN254_FR, REF_FR, 0), "fq": (BN254_FQ, REF_FQ, 1)}
N = 37  # not a multiple of any launch shape


def _inputs(p, seed=11):
    """(a, b) as int32[N, 8] Montgomery limbs from a numpy seed; rows 0..7 are
    0, 1, p - 1, R mod p, R^2 mod p, 2^255 - 19 reduced and two equal
    operands."""
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 1 << 32, size=(2, N, 8), dtype=np.uint64)
    vals = [[sum(int(w) << (32 * i) for i, w in enumerate(row)) % p for row in half]
            for half in words]
    r = (1 << 256) % p
    vals[0][:6] = [0, 1, p - 1, r, r * r % p, ((1 << 255) - 19) % p]
    vals[1][6:8] = vals[0][6:8]
    vals[1][2] = p - 1
    return limb.from_ints(vals[0]), limb.from_ints(vals[1])


def _ref_chain(ref_spec, a, b, chain, variant):
    """_chain_kernel's body: acc = a; chain times acc = fn(acc, b)."""
    def mul_u32(sp, x, y):
        return ref_soa._redc(sp, ref_soa._carry_chain(ref_soa._mul_columns(x, y))[:33])

    fn = mul_u32 if variant == "u32" else ref_soa.mont_mul_f32
    acc = [jnp.asarray(d) for d in convert.soa_to_reference(a)]
    y = [jnp.asarray(d) for d in convert.soa_to_reference(b)]
    for _ in range(chain):
        acc = fn(ref_spec, acc, y)
    return convert.soa_from_reference([np.asarray(d) for d in acc])[1]


@pytest.mark.parametrize("chain", [1, 2, 16])
@pytest.mark.parametrize("variant", ["u32", "f32"])
def test_plain_chain_matches_reference_body(variant, chain):
    spec, ref_spec, _ = SPECS["fr"]
    a, b = _inputs(spec.p)
    got = probe.mont_mul_chain_plain(spec, a, b, chain, variant)
    assert got.dtype == torch.int32 and got.shape == a.shape
    assert torch.equal(got, _ref_chain(ref_spec, a, b, chain, variant))


@pytest.mark.parametrize("field", ["fr", "fq"])
@pytest.mark.parametrize("chain", [0, 1, 2, 16])
def test_plain_chain_matches_host_integers(field, chain):
    spec = SPECS[field][0]
    a, b = _inputs(spec.p)
    r_inv = pow(1 << 256, -1, spec.p)
    want = [x * pow(y, chain, spec.p) * pow(r_inv, chain, spec.p) % spec.p
            for x, y in zip(limb.to_ints(a), limb.to_ints(b))]
    for variant in probe.VARIANTS:
        assert limb.to_ints(probe.mont_mul_chain_plain(spec, a, b, chain, variant)) == want
    # on a CPU tensor the wrapper takes the plain version and launches nothing
    before = LAUNCHES["mont_mul_chain"]
    assert limb.to_ints(probe.mont_mul_chain(spec, a, b, chain, "f32")) == want
    assert LAUNCHES["mont_mul_chain"] == before


@pytest.fixture(scope="module")
def twin():
    try:
        path = build.build_cpu_twin()
    except FileNotFoundError as e:
        pytest.skip(f"no host C++ compiler: {e}")
    lib = ctypes.CDLL(str(path))
    lib.twin_fe_op.argtypes = [ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 3 + [ctypes.c_int64]
    build.bind(lib.twin_mont_mul_chain, probe.CHAIN_ARGS)
    return lib


@pytest.mark.parametrize("field", ["fr", "fq"])
def test_fe_mul_f32_twin(twin, field):
    """csrc/field.cuh::fe_mul_f32 under g++ equals fe_mul and the plain product."""
    spec, _, code = SPECS[field]
    a, b = _inputs(spec.p, seed=12)
    out_f32, out_u32 = torch.empty_like(a), torch.empty_like(a)
    twin.twin_fe_op(code, 4, a.data_ptr(), b.data_ptr(), out_f32.data_ptr(), N)
    twin.twin_fe_op(code, 2, a.data_ptr(), b.data_ptr(), out_u32.data_ptr(), N)
    assert torch.equal(out_f32, out_u32)
    assert torch.equal(out_f32, probe.mont_mul_chain_plain(spec, a, b, 1, "f32"))
    # a * a: the square through both
    twin.twin_fe_op(code, 4, a.data_ptr(), a.data_ptr(), out_f32.data_ptr(), N)
    assert torch.equal(out_f32, limb.mont_mul(spec, a, a))


@pytest.mark.parametrize("field", ["fr", "fq"])
@pytest.mark.parametrize("per_thread", [1, 2, 4])
@pytest.mark.parametrize("variant", ["u32", "f32"])
def test_chain_kernel_body_twin(twin, variant, per_thread, field):
    """The kernel's per-thread pass, run thread after thread on the host
    through the wrapper's launch logic, equals the plain version."""
    spec = SPECS[field][0]
    a, b = _inputs(spec.p, seed=13)
    before = LAUNCHES["mont_mul_chain"]
    for chain, threads in ((1, 4), (16, 8)):
        want = probe.mont_mul_chain_plain(spec, a, b, chain, variant)
        got = probe.chain_launch(twin.twin_mont_mul_chain, None, spec, a, b, chain,
                                 variant, per_thread, threads)
        assert torch.equal(got, want)
    assert LAUNCHES["mont_mul_chain"] == before + 2


def test_wrapper_rejects_what_the_kernel_does_not_take(twin):
    spec = BN254_FR
    a, b = _inputs(spec.p)
    with pytest.raises(ValueError, match="variant"):
        probe.mont_mul_chain_plain(spec, a, b, 1, "f64")
    with pytest.raises(ValueError, match="int32"):
        probe.mont_mul_chain(spec, a.to(torch.int64), b, 1)
    with pytest.raises(ValueError, match="contiguous"):
        probe.mont_mul_chain(spec, a[::2], b[::2], 1)
    with pytest.raises(ValueError, match="per_thread"):
        probe.chain_launch(twin.twin_mont_mul_chain, None, spec, a, b, 1, "u32", 3)
    from plonkish_tpu_torch.fields.spec import PALLAS_BASE

    with pytest.raises(NotImplementedError):
        probe.chain_launch(twin.twin_mont_mul_chain, None, PALLAS_BASE, a, b, 1, "u32")


def test_no_fallback_without_a_card():
    """A request for the kernel raises where there is no card; it never takes
    the plain version on its own."""
    from plonkish_tpu_torch import roofline

    spec = BN254_FR
    a, b = _inputs(spec.p)
    with pytest.raises(ValueError, match="CUDA"):
        probe.mont_mul_chain_cuda(spec, a, b, 1)
    with pytest.raises((ValueError, RuntimeError, NotImplementedError)):
        probe.mont_mul_chain(spec, a.to("meta"), b.to("meta"), 1)
    with pytest.raises(ValueError, match="CUDA"):
        roofline.measure_peaks("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            roofline.measure_peaks()
