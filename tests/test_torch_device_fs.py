"""The sum-check with its transcript on the device (piop/sum_check.py
DeviceFsRun) against the host loop, on CPU tensors, where K3, K6 and K4 run
their plain versions.

On the CPU the host loop is the default (``device_fs_selected`` wants the
card), so these tests select the device path by patching that rule to take
every eligible prover.  Every comparison is exact: equal challenges, field
elements and proof bytes.  The file imports the port only, so the ranks of
the gloo case re-import it without JAX.
"""

import pathlib
import random

import pytest
import torch

from plonkish_tpu_torch import parallel
from plonkish_tpu_torch.fields import limb
from plonkish_tpu_torch.fields.host import Fp
from plonkish_tpu_torch.fields.spec import BN254_FR
from plonkish_tpu_torch.models import circuits
from plonkish_tpu_torch.piop import fiat_shamir as fs
from plonkish_tpu_torch.piop import sum_check as sc
from plonkish_tpu_torch.poly.multilinear import MLPoly
from plonkish_tpu_torch.utils import expression as ex
from plonkish_tpu_torch.utils.transcript import Keccak256Transcript

torch.set_num_threads(1)

GOLDEN = pathlib.Path(__file__).parent / "golden"
SPEC = BN254_FR


@pytest.fixture
def device_fs(monkeypatch):
    monkeypatch.setattr(sc, "device_fs_selected",
                        lambda state, prover: sc.device_fs_eligible(prover))


def _rand_polys(k, count, seed):
    rng = random.Random(seed)
    return [MLPoly(SPEC, limb.from_canonical_ints(SPEC, [rng.randrange(SPEC.p)
                                                         for _ in range(1 << k)]))
            for _ in range(count)]


def zero_check_case(k, seed=3):
    """The vanilla-PLONK zero-check's virtual polynomial over random tables."""
    expr = circuits.vanilla_plonk_expression(SPEC, k)
    rng = random.Random(seed)
    polys = _rand_polys(k, 1 + max(q.poly for q in expr.used_query()), seed)
    ch = [Fp(rng.randrange(SPEC.p), SPEC) for _ in range(3)]
    y = [Fp(rng.randrange(SPEC.p), SPEC) for _ in range(k)]
    return sc.VirtualPolynomial(expr, polys, ch, [y]), Fp.zero(SPEC)


def batch_open_case(k, seed=4):
    """The degree-2 batch-open sum-check's shape (pcs/additive.py): sum of
    scalar * eq(x, y_i) * p_i over three points, plus a constant; its true
    claimed sum."""
    rng = random.Random(seed)
    polys = _rand_polys(k, 3, seed)
    points = [[Fp(rng.randrange(SPEC.p), SPEC) for _ in range(k)] for _ in range(3)]
    scalars = [Fp(rng.randrange(SPEC.p), SPEC) for _ in range(3)]
    const = Fp(rng.randrange(SPEC.p), SPEC)
    expr = ex.Constant(const)
    total = const * (1 << k)
    for i, (poly, point, s) in enumerate(zip(polys, points, scalars)):
        expr = expr + ex.eq_xy(i) * ex.Polynomial(ex.Query(i, ex.Rotation(0))) * s
        total = total + s * poly.evaluate(point)
    return sc.VirtualPolynomial(expr, polys, [], points), total


def _prove(check, k, vp, sum_, device_fs):
    """(challenges, final evaluations, proof bytes) of one sum-check after a
    transcript that holds 40 bytes pending; the path chosen by `device_fs`."""
    saved = sc.device_fs_selected
    sc.device_fs_selected = ((lambda state, prover: sc.device_fs_eligible(prover)) if device_fs
                             else (lambda state, prover: False))
    try:
        tr = Keccak256Transcript(SPEC)
        tr.common_field_element(Fp(5, SPEC))
        tr.write_field_element(Fp(6, SPEC))
        tr.state.update(b"\x07" * 8)
        challenges, evals = check.prove(SPEC, k, vp, sum_, tr)
    finally:
        sc.device_fs_selected = saved
    return challenges, evals, tr.into_proof()


@pytest.mark.parametrize("case", ["zero_check", "batch_open"])
def test_device_fs_equals_host_loop(case, monkeypatch):
    """The vanilla zero-check at k = 6 (Evaluations, degree 5) and the
    batch-open sum-check (Coefficients, degree 2), with the sanity checks
    on: the same challenges, final evaluations and transcript bytes."""
    monkeypatch.setenv("PLONKISH_TPU_SANITY", "1")
    k = 6
    if case == "zero_check":
        check, (vp, sum_) = sc.ClassicSumCheck.evaluations(), zero_check_case(k)
    else:
        check, (vp, sum_) = sc.ClassicSumCheck.coefficients(), batch_open_case(k)
    host = _prove(check, k, vp, sum_, False)
    dev = _prove(check, k, vp, sum_, True)
    assert dev[0] == host[0] and dev[1] == host[1] and dev[2] == host[2]


def test_host_loop_stays_the_default_on_the_cpu(monkeypatch):
    monkeypatch.setenv("PLONKISH_TPU_DEVICE_FS", "1")
    vp, _ = zero_check_case(3)
    state = sc.ProverState(SPEC, 3, Fp.zero(SPEC), vp)
    assert sc.device_fs_eligible(sc.EvaluationsProver(state))
    assert not sc.device_fs_selected(state, sc.EvaluationsProver(state))


def test_corrupted_message_raises():
    """A message changed between the rounds and the replay: the host
    transcript's challenge differs from the device's, and the replay raises."""
    k = 5
    vp, sum_ = zero_check_case(k)
    state = sc.ProverState(SPEC, k, sum_, vp)
    prover = sc.EvaluationsProver(state)
    tr = Keccak256Transcript(SPEC)
    run = sc.DeviceFsRun(state, prover, tr)
    run.enqueue()
    run.out[2, 1, 0] ^= 1
    with pytest.raises(ValueError, match="diverged from host transcript at round 2"):
        run.replay(sc.Evaluations.auxiliary(state.degree, SPEC), tr)


@pytest.mark.parametrize("name,pcs_name", [
    ("hyperplonk_kzg_k3", "kzg"),
    ("hyperplonk_ipa_k5", "ipa"),
])
def test_golden_proof_with_device_fs(device_fs, name, pcs_name):
    """HyperPlonk with every sum-check (zero-check and batch open) on the
    device transcript reproduces the golden proof; IPA is the Fq instance."""
    from plonkish_tpu_torch.backend.hyperplonk import HyperPlonk
    from plonkish_tpu_torch.pcs.ipa import MultilinearIpa
    from plonkish_tpu_torch.pcs.kzg import MultilinearKzg

    k = int(name[-1])
    pcs = (MultilinearKzg if pcs_name == "kzg" else MultilinearIpa)(device="cpu")
    spec = pcs.field_spec
    ci, circuit = circuits.rand_vanilla_plonk_circuit(spec, k, random.Random(1),
                                                      random.Random(2))
    backend = HyperPlonk(pcs)
    pp, vp = backend.preprocess(backend.setup(ci, random.Random(0)), ci)
    tr = Keccak256Transcript(spec)
    backend.prove(pp, circuit, tr)
    assert tr.into_proof() == (GOLDEN / f"{name}.bin").read_bytes()


# ---------------------------------------------------------------------------
# K6's cases, shared with tests/test_torch_fiat_shamir.py (the g++ twin) and
# tests/test_torch_gpu.py (the card)
# ---------------------------------------------------------------------------

def _mont(spec, values):
    return limb.from_ints([spec.to_mont(v % spec.p) for v in values])


def _transcript(spec, writes, rng):
    tr = Keccak256Transcript(spec)
    for _ in range(writes):
        tr.common_field_element(Fp(rng.randrange(spec.p), spec))
    return tr


def k6_round_case(spec, degree, pending_bytes, seed):
    """Inputs of one Evaluations round: a sponge with `pending_bytes`
    buffered (the rest of its state from earlier absorbs), random sums,
    claimed sum and offset, round 2's identity rows."""
    rng = random.Random(seed)
    tr = _transcript(spec, 5, rng)  # 160 bytes: a permutation, 24 pending
    tr.squeeze_challenge()  # 32 pending
    blob = bytes(rng.getrandbits(8) for _ in range((pending_bytes - 32) % 136))
    tr.state.update(blob)
    lanes, pending = tr.export_sponge()
    assert len(pending) == pending_bytes
    return {
        "sums": _mont(spec, [rng.randrange(spec.p) for _ in range(degree)]),
        "scal": _mont(spec, [rng.randrange(spec.p), rng.randrange(spec.p)]),
        "sponge": fs.DeviceSponge.from_host(lanes, pending).words(),
        "fixed": fs.lagrange_constants(spec, degree, "cpu"),
        "rows": sc.identity_stack(spec, [3, 1, 0, 0], "cpu")[2:4].contiguous(),
    }


def _sharded_rank(mesh, k):
    """One gloo rank: the zero-check at k on this rank's rows, by the host
    loop and by the device transcript."""
    vp, sum_ = zero_check_case(k)
    check = sc.ClassicSumCheck.evaluations()
    host = _prove(check, k, vp, sum_, False)
    dev = _prove(check, k, vp, sum_, True)
    assert mesh.taken["sum_check"] == 2
    return host, dev


def test_device_fs_under_a_two_rank_mesh():
    """Two gloo ranks (the last round after the rows are gathered): every
    rank's device-transcript sum-check equals its host loop and the
    unsharded one."""
    k = 4
    vp, sum_ = zero_check_case(k)
    want = _prove(sc.ClassicSumCheck.evaluations(), k, vp, sum_, False)
    results = parallel.spawn(_sharded_rank, 2, "gloo", "cpu", args=(k,), threads=1,
                             deadline_s=300)
    for host, dev in results:
        assert host == want and dev == want
