"""Multilinear KZG of the port (commit, open, batch open on the plain MSM)
against the reference on the SRS carried across with ``convert``: equal
commitments and proof bytes, and the port's verifier accepts."""

import random

import numpy as np
import pytest
import torch

from plonkish_tpu.backend.pcs_api import Evaluation as RefEvaluation
from plonkish_tpu.fields import BN254_FR as REF_FR
from plonkish_tpu.pcs.kzg import MultilinearKzg as RefKzg
from plonkish_tpu.poly.multilinear import MLPoly as RefMLPoly
from plonkish_tpu.utils.transcript import Keccak256Transcript as RefTranscript
from plonkish_tpu_torch import convert
from plonkish_tpu_torch.backend.pcs_api import Evaluation
from plonkish_tpu_torch.fields.host import Fp
from plonkish_tpu_torch.fields.spec import BN254_FR
from plonkish_tpu_torch.pcs.kzg import MultilinearKzg
from plonkish_tpu_torch.poly.multilinear import MLPoly
from plonkish_tpu_torch.utils.transcript import Keccak256Transcript

# Tensors here are tiny: one intra-op thread is faster, and keeps parallel
# test workers from oversubscribing the cores.
torch.set_num_threads(1)

P = BN254_FR.p


def _ints(n, seed):
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 1 << 32, size=(n, 8), dtype=np.uint64)
    return [sum(int(w) << (32 * i) for i, w in enumerate(row)) % P for row in words]


def _setup(num_vars, batch):
    ref = RefKzg()
    param = ref.setup(1 << num_vars, batch, random.Random(11))
    ours = MultilinearKzg(device="cpu")
    oparam = convert.kzg_params_from_reference(param)
    return ours, ref, ours.trim(oparam, 1 << num_vars, batch), ref.trim(param, 1 << num_vars, batch)


def _same(a, b):
    if a.is_identity() or b.is_identity():
        return a.is_identity() == b.is_identity()
    return (int(a.x), int(a.y)) == (int(b.x), int(b.y))


def test_setup_gives_the_reference_srs():
    num_vars = 4
    param = RefKzg().setup(1 << num_vars, 1, random.Random(3))
    ours = MultilinearKzg(device="cpu").setup(1 << num_vars, 1, random.Random(3))
    for mine, theirs in zip(ours.eqs, param.eqs):
        assert torch.equal(mine, convert.basis_from_reference(theirs))
    assert [(s.x, s.y) for s in ours.ss] == [(tuple(s.x), tuple(s.y)) for s in param.ss]


@pytest.mark.parametrize("num_vars", [3, 6])
def test_commit_and_open(num_vars):
    ours, ref, (pp, vp), (rpp, rvp) = _setup(num_vars, 1)
    vals = _ints(1 << num_vars, num_vars)
    rpoly = RefMLPoly.from_ints(REF_FR, vals)
    poly = MLPoly(BN254_FR, convert.digits_to_limbs(rpoly.evals))
    t, rt = Keccak256Transcript(BN254_FR), RefTranscript(REF_FR)
    comm = ours.commit_and_write(pp, poly, t)
    rcomm = ref.commit_and_write(rpp, rpoly, rt)
    assert _same(comm, rcomm)
    point = t.squeeze_challenges(num_vars)
    rpoint = rt.squeeze_challenges(num_vars)
    value = poly.evaluate(point)
    assert int(value) == int(rpoly.evaluate(rpoint))
    t.write_field_element(value)
    rt.write_field_element(rpoly.evaluate(rpoint))
    ours.open(pp, poly, comm, point, value, t)
    ref.open(rpp, rpoly, rcomm, rpoint, rpoly.evaluate(rpoint), rt)
    proof = t.into_proof()
    assert proof == rt.into_proof()
    r = Keccak256Transcript.from_proof(BN254_FR, proof)
    c = ours.read_commitments(vp, 1, r)[0]
    x = r.squeeze_challenges(num_vars)
    ours.verify(vp, c, x, r.read_field_element(), r)
    r = Keccak256Transcript.from_proof(BN254_FR, proof)
    c = ours.read_commitments(vp, 1, r)[0]
    x = r.squeeze_challenges(num_vars)
    wrong = r.read_field_element() + 1
    with pytest.raises(ValueError):
        ours.verify(vp, c, x, wrong, r)


def test_batch_open():
    num_vars, num_polys = 5, 4
    ours, ref, (pp, vp), (rpp, rvp) = _setup(num_vars, num_polys)
    rpolys = [RefMLPoly.from_ints(REF_FR, _ints(1 << num_vars, 40 + i)) for i in range(num_polys)]
    polys = [MLPoly(BN254_FR, convert.digits_to_limbs(p.evals)) for p in rpolys]
    t, rt = Keccak256Transcript(BN254_FR), RefTranscript(REF_FR)
    comms = ours.batch_commit_and_write(pp, polys, t)
    rcomms = ref.batch_commit_and_write(rpp, rpolys, rt)
    points = [t.squeeze_challenges(num_vars) for _ in range(3)]
    rpoints = [rt.squeeze_challenges(num_vars) for _ in range(3)]
    pairs = [(0, 0), (1, 0), (1, 1), (2, 2), (3, 0), (3, 2)]
    evals = [Evaluation(i, j, polys[i].evaluate(points[j])) for i, j in pairs]
    revals = [RefEvaluation(i, j, rpolys[i].evaluate(rpoints[j])) for i, j in pairs]
    t.write_field_elements([e.value for e in evals])
    rt.write_field_elements([e.value for e in revals])
    ours.batch_open(pp, polys, comms, points, evals, t)
    ref.batch_open(rpp, rpolys, rcomms, rpoints, revals, rt)
    proof = t.into_proof()
    assert proof == rt.into_proof()
    r = Keccak256Transcript.from_proof(BN254_FR, proof)
    rc = ours.read_commitments(vp, num_polys, r)
    pts = [r.squeeze_challenges(num_vars) for _ in range(3)]
    vals = r.read_field_elements(len(pairs))
    ours.batch_verify(vp, rc, pts, [Evaluation(i, j, v) for (i, j), v in zip(pairs, vals)], r)
