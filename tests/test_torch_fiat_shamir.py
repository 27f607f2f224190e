"""The port's device-resident Fiat-Shamir (plonkish_tpu_torch/piop/fiat_shamir.py)
against the JAX package's (plonkish_tpu/piop/fiat_shamir.py) and the host
transcript, and K6's source (csrc/fiat_shamir.cuh) through its g++ twin
against the plain version.

Every comparison is exact: equal lanes, bytes and field elements.  The JAX
programs run with jit disabled (an XLA compile of each round-message
program takes longer than the whole eager run on the CPU); the functions and
their arithmetic are the JAX package's own.
"""

import ctypes
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plonkish_tpu.fields import BN254_FQ as J_FQ
from plonkish_tpu.fields import BN254_FR as J_FR
from plonkish_tpu.fields.spec import int_to_digits
from plonkish_tpu.piop import fiat_shamir as jfs

from plonkish_tpu_torch import convert
from plonkish_tpu_torch.fields import limb
from plonkish_tpu_torch.fields.host import Fp
from plonkish_tpu_torch.fields.spec import BN254_FQ, BN254_FR
from plonkish_tpu_torch.kernels import build
from plonkish_tpu_torch.kernels import fiat_shamir as kfs
from plonkish_tpu_torch.piop import fiat_shamir as fs
from plonkish_tpu_torch.piop.sum_check import Coefficients, Evaluations, identity_stack
from plonkish_tpu_torch.utils import keccak_device
from plonkish_tpu_torch.utils.transcript import Keccak256Transcript
from test_torch_device_fs import k6_round_case

torch.set_num_threads(1)

SPECS = {"fr": (BN254_FR, J_FR), "fq": (BN254_FQ, J_FQ)}


def _mont(spec, values):
    return limb.from_ints([spec.to_mont(v % spec.p) for v in values])


def _jdigits(spec, values, mont=True):
    return jnp.asarray(np.stack([int_to_digits(spec.to_mont(v) if mont else v)
                                 for v in values]))


def _ints(digits):
    return limb.to_ints(convert.digits_to_limbs(np.asarray(digits)))


def _port_sponge(jsp):
    """The JAX package's DeviceSponge as the port's words."""
    parts = (torch.from_numpy(np.asarray(x).astype(np.int64))
             for x in (jsp.lo, jsp.hi, jsp.buf_lo, jsp.buf_hi))
    return fs.DeviceSponge(*parts, jsp.nbytes).words()


def _transcript(spec, writes, rng):
    tr = Keccak256Transcript(spec)
    for _ in range(writes):
        tr.common_field_element(Fp(rng.randrange(spec.p), spec))
    return tr


def test_keccak_f_equals_reference():
    rng = np.random.default_rng(7)
    lanes = rng.integers(0, 1 << 63, size=(25, 3), dtype=np.uint64) * np.uint64(2) + np.uint64(1)
    lo = (lanes & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    hi = (lanes >> np.uint64(32)).astype(np.uint32)
    jlo, jhi = jfs.keccak_f(jnp.asarray(lo), jnp.asarray(hi))
    tlo, thi = keccak_device.keccak_f(torch.from_numpy(lo.astype(np.int64)),
                                      torch.from_numpy(hi.astype(np.int64)))
    assert np.array_equal(tlo.numpy(), np.asarray(jlo).astype(np.int64))
    assert np.array_equal(thi.numpy(), np.asarray(jhi).astype(np.int64))


def test_sponge_matches_host_transcript():
    """Seeded from a host transcript with 80 bytes pending (11 writes), the
    sponge absorbs and squeezes rounds whose absorbs cross the 136-byte rate
    at varying offsets; every challenge equals squeeze_challenge."""
    spec = BN254_FR
    rng = random.Random(0xF5)
    tr = _transcript(spec, 11, rng)
    lanes, pending = tr.export_sponge()
    assert len(pending) == 80
    sp = fs.DeviceSponge.from_host(lanes, pending)
    for m in (4, 3, 7, 1, 5):
        fes = [Fp(rng.randrange(spec.p), spec) for _ in range(m)]
        tr.common_field_elements(fes)
        canon = limb.unpack(limb.from_ints([int(f) for f in fes]))
        sp = sp.absorb_words(fs.digits_to_words(canon))
        sp, digest = sp.squeeze()
        got = limb.to_ints(limb.pack(fs.challenge_digits(spec, digest)))[0]
        assert got == int(tr.squeeze_challenge())
    # the words form round-trips
    again = fs.DeviceSponge.from_words(sp.words())
    assert again.nbytes == sp.nbytes == 32
    assert torch.equal(again.words(), sp.words())


def _round_inputs(spec, degree, writes, seed):
    rng = random.Random(seed)
    tr = _transcript(spec, writes, rng)
    sums = [rng.randrange(spec.p) for _ in range(degree)]
    s, off, r = rng.randrange(spec.p), rng.randrange(spec.p), rng.randrange(4)
    return tr, sums, s, off, r


@pytest.mark.parametrize("field,degree", [("fr", 3), ("fq", 5)])
def test_round_message_equals_reference(field, degree):
    """Degrees 3 and 5 over one field each: each eager run of the JAX
    program takes 5-16 s here."""
    spec, jspec = SPECS[field]
    tr, sums, s, off, r = _round_inputs(spec, degree, 9, 11 + degree)
    lanes, pending = tr.export_sponge()
    fixed = fs.lagrange_constants(spec, degree, "cpu")
    with jax.disable_jit():
        msg, ch, ch_mont, nxt, noff, jsp = jfs.round_message(
            jspec, degree, jfs.DeviceSponge.from_host(lanes, pending),
            _jdigits(spec, sums, mont=False), _jdigits(spec, [s])[0],
            _jdigits(spec, [off])[0], jnp.asarray(convert.limbs_to_digits(fixed[: degree + 1])),
            jnp.asarray(convert.limbs_to_digits(fixed[degree + 1:])),
            _jdigits(spec, [1 << r])[0])
    sponge = fs.DeviceSponge.from_host(lanes, pending).words()
    scal = _mont(spec, [s, off])
    rows = identity_stack(spec, [0] * 4, "cpu")[r: r + 2].contiguous()
    out = torch.zeros((degree + 2, 8), dtype=torch.int32)
    chm = torch.zeros(8, dtype=torch.int32)
    ids = torch.zeros((3, 8), dtype=torch.int32)
    fs.round_message(spec, degree, _mont(spec, sums), scal, sponge, fixed, rows, out, chm, ids)
    assert limb.to_ints(out) == _ints(msg) + _ints(ch[None])
    assert torch.equal(chm, convert.digits_to_limbs(np.asarray(ch_mont)))
    assert torch.equal(scal, convert.digits_to_limbs(np.stack([np.asarray(nxt), np.asarray(noff)])))
    assert torch.equal(sponge, _port_sponge(jsp))
    # and the host protocol: the message, the squeeze, the interpolation
    host = Evaluations([Fp(v, spec) for v in limb.to_ints(out)[: degree + 1]])
    host.write(tr)
    c = tr.squeeze_challenge()
    assert int(c) == limb.to_ints(out)[degree + 1]
    assert limb.to_canonical_ints(spec, scal)[0] == int(
        host.evaluate(Evaluations.auxiliary(degree, spec), c))


@pytest.mark.parametrize("field", ["fr", "fq"])
def test_coeff_message_equals_reference(field):
    spec, jspec = SPECS[field]
    tr, (v0, v2), s, c0_base, _ = _round_inputs(spec, 2, 6, 5)
    lanes, pending = tr.export_sponge()
    with jax.disable_jit():
        msg, ch, ch_mont, nxt, jsp = jfs.coeff_message(
            jspec, jfs.DeviceSponge.from_host(lanes, pending), _jdigits(spec, [v0, v2], mont=False),
            _jdigits(spec, [c0_base])[0], _jdigits(spec, [s])[0])
    sponge = fs.DeviceSponge.from_host(lanes, pending).words()
    scal = _mont(spec, [s])[0]
    out = torch.zeros((4, 8), dtype=torch.int32)
    chm = torch.zeros(8, dtype=torch.int32)
    fs.coeff_message(spec, _mont(spec, [v0, v2]), scal, sponge, _mont(spec, [c0_base])[0], out, chm)
    assert limb.to_ints(out) == _ints(msg) + _ints(ch[None])
    assert torch.equal(chm, convert.digits_to_limbs(np.asarray(ch_mont)))
    assert torch.equal(scal, convert.digits_to_limbs(np.asarray(nxt)))
    assert torch.equal(sponge, _port_sponge(jsp))
    host = Coefficients([Fp(v, spec) for v in limb.to_ints(out)[:3]])
    host.write(tr)
    assert int(tr.squeeze_challenge()) == limb.to_ints(out)[3]


# ---------------------------------------------------------------------------
# K6 through the g++ twin, in the cases chip_smoke.py phase 2 runs on the card
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def twin():
    try:
        path = build.build_cpu_twin()
    except FileNotFoundError as e:
        pytest.skip(f"no host C++ compiler: {e}")
    lib = ctypes.CDLL(str(path))
    build.bind(lib.twin_fs_round, kfs.ROUND_ARGS)
    build.bind(lib.twin_fs_coeff, kfs.COEFF_ARGS)
    return lib


def _run_round(fn, spec, degree, case):
    """One round through `fn` (the twin's entry point or None for the plain
    version) on copies of the case; returns every buffer it writes."""
    bufs = {k: v.clone() for k, v in case.items()}
    out = torch.zeros((degree + 2, 8), dtype=torch.int32)
    chm = torch.zeros(8, dtype=torch.int32)
    ids = torch.zeros((3, 8), dtype=torch.int32)
    args = (bufs["sums"], bufs["scal"], bufs["sponge"], bufs["fixed"], bufs["rows"], out, chm,
            ids)
    if fn is None:
        fs.round_message_plain(spec, degree, *args)
    else:
        kfs.round_launch(fn, None, spec, degree, *args)
    return [bufs["scal"], bufs["sponge"], out, chm, ids]


@pytest.mark.parametrize("field", ["fr", "fq"])
@pytest.mark.parametrize("degree", [1, 2, 3, 5, 9, 32])
def test_k6_round_twin_equals_plain(twin, field, degree):
    """Degree 9 is the widest of the tapes chip_smoke.py builds, 32 the
    widest K6 takes (lane 0 then holds two terms); 128 pending bytes make
    the first absorbed lane fill the block."""
    spec = SPECS[field][0]
    for pending in (0, 32, 80, 120, 128):
        case = k6_round_case(spec, degree, pending, 100 * degree + pending)
        got = _run_round(twin.twin_fs_round, spec, degree, case)
        want = _run_round(None, spec, degree, case)
        for g, w in zip(got, want):
            assert torch.equal(g, w), (field, degree, pending)


@pytest.mark.parametrize("field", ["fr", "fq"])
def test_k6_chained_rounds_twin_equals_plain(twin, field):
    """Ten rounds, each from the last one's sponge, sum and offset (the
    identity rows of the next round included), as the prover chains them;
    then the Coefficients round from 80 pending bytes."""
    spec = SPECS[field][0]
    degree = 3
    case = k6_round_case(spec, degree, 80, 9)
    stack = identity_stack(spec, list(range(10)), "cpu")
    twin_state = {k: v.clone() for k, v in case.items()}
    plain_state = {k: v.clone() for k, v in case.items()}
    rng = random.Random(10)
    for r in range(10):
        sums = _mont(spec, [rng.randrange(spec.p) for _ in range(degree)])
        for fn, st in ((twin.twin_fs_round, twin_state), (None, plain_state)):
            st["sums"], st["rows"] = sums, stack[r: r + 2].contiguous()
            scal, sponge, out, chm, ids = _run_round(fn, spec, degree, st)
            st.update(scal=scal, sponge=sponge, out=out, chm=chm, ids=ids)
        for key in ("scal", "sponge", "out", "chm", "ids"):
            assert torch.equal(twin_state[key], plain_state[key]), (r, key)

    v = _mont(spec, [rng.randrange(spec.p) for _ in range(2)])
    c0 = _mont(spec, [rng.randrange(spec.p)])[0]
    results = []
    for fn in (twin.twin_fs_coeff, None):
        scal = case["scal"][0].clone()
        sponge = case["sponge"].clone()
        out = torch.zeros((4, 8), dtype=torch.int32)
        chm = torch.zeros(8, dtype=torch.int32)
        if fn is None:
            fs.coeff_message_plain(spec, v, scal, sponge, c0, out, chm)
        else:
            kfs.coeff_launch(fn, None, spec, v, scal, sponge, c0, out, chm)
        results.append((scal, sponge, out, chm))
    for g, w in zip(*results):
        assert torch.equal(g, w)


def test_k6_refuses_what_it_is_not_built_for(twin):
    spec = BN254_FR
    case = k6_round_case(spec, 3, 32, 1)
    with pytest.raises(ValueError):
        kfs.round_launch(twin.twin_fs_round, None, spec, 40, *[case[k] for k in
                         ("sums", "scal", "sponge", "fixed", "rows")],
                         torch.zeros((42, 8), dtype=torch.int32),
                         torch.zeros(8, dtype=torch.int32), torch.zeros((3, 8), dtype=torch.int32))
    with pytest.raises(ValueError):  # a sponge of the wrong size
        kfs.coeff_launch(twin.twin_fs_coeff, None, spec, case["sums"][:2], case["scal"][0],
                         case["sponge"][:-1], case["scal"][1], torch.zeros((4, 8), dtype=torch.int32),
                         torch.zeros(8, dtype=torch.int32))
