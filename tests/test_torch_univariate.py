"""Univariate polynomials and univariate KZG (the base of Gemini and
Zeromorph) on the CPU against the JAX package on its cpp backend: UniPoly's
host algebra, DUniPoly's tensor algebra and powers_tensor, the SRS, and the
proof bytes of one opening and of the batched opening.  Exact equality."""

import random

import numpy as np
import pytest
import torch

from plonkish_tpu.fields import BN254_FR as REF_FR, Fp as RefFp
from plonkish_tpu.poly import univariate as ref_uni
from plonkish_tpu_torch import convert
from plonkish_tpu_torch.backend.pcs_api import Evaluation
from plonkish_tpu_torch.fields import limb
from plonkish_tpu_torch.fields.host import Fp
from plonkish_tpu_torch.fields.spec import BN254_FR
from plonkish_tpu_torch.poly.univariate import DUniPoly, UniPoly, powers_tensor

torch.set_num_threads(1)

P = BN254_FR.p
S = BN254_FR


def _vals(n, seed):
    rng = random.Random(seed)
    return [rng.randrange(P) for _ in range(n)]


def _pair(n, seed):
    vals = _vals(n, seed)
    return UniPoly(S, [Fp(v, S) for v in vals]), ref_uni.UniPoly(REF_FR, [RefFp(v, REF_FR) for v in vals])


def _ints(poly):
    return [int(c) for c in poly.coeffs]


def test_unipoly_matches_reference():
    f, rf = _pair(13, 1)
    g, rg = _pair(5, 2)
    x = _vals(1, 3)[0]
    assert int(f.evaluate(Fp(x, S))) == int(rf.evaluate(RefFp(x, REF_FR)))
    assert _ints(f * g) == _ints(rf * rg)
    assert _ints(f + g) == _ints(rf + rg) and _ints(f - g) == _ints(rf - rg)
    q, r = f.div_rem(g)
    rq, rr = rf.div_rem(rg)
    assert (_ints(q), _ints(r)) == (_ints(rq), _ints(rr))
    roots = [Fp(v, S) for v in _vals(3, 4)]
    assert _ints(f.div_by_roots(roots)) == _ints(rf.div_by_roots([RefFp(int(v), REF_FR) for v in roots]))
    assert _ints(UniPoly.basis(S, roots, Fp(7, S))) == _ints(
        ref_uni.UniPoly.basis(REF_FR, [RefFp(int(v), REF_FR) for v in roots], RefFp(7, REF_FR)))


@pytest.mark.parametrize("n", [1, 2, 33, 64])
def test_powers_tensor_matches_reference(n):
    x = _vals(1, n)[0]
    got = powers_tensor(S, Fp(x, S), n)
    want = ref_uni.powers_tensor(REF_FR, RefFp(x, REF_FR), n)
    assert torch.equal(got, convert.digits_to_limbs(np.asarray(want)))


def test_duni_poly_matches_unipoly():
    """DUniPoly on tensors: the same coefficients as the host algebra,
    whatever the zero tail."""
    f, _ = _pair(40, 5)
    g, _ = _pair(17, 6)
    df, dg = DUniPoly.from_unipoly(f), DUniPoly.from_unipoly(g)
    x = Fp(_vals(1, 7)[0], S)
    assert df.evaluate(x) == f.evaluate(x)
    assert _ints((df + dg).to_unipoly()) == _ints(f + g)
    assert _ints(df.scale(x).to_unipoly()) == _ints(f.scale(x))
    roots = [x, Fp(0, S), Fp(3, S)]
    assert _ints(df.div_by_roots(roots).to_unipoly()) == _ints(f.div_by_roots(roots))
    padded = DUniPoly(S, torch.cat([df.coeffs, limb.zeros((5,))]))
    assert _ints(padded.div_by_roots(roots[:1]).to_unipoly()) == _ints(f.div_by_roots(roots[:1]))
    assert DUniPoly(S, limb.zeros((0,))).evaluate(x) == Fp.zero(S)


def _kzg_pair(n):
    from plonkish_tpu.pcs.univariate_kzg import UnivariateKzg as RefKzg
    from plonkish_tpu_torch.pcs.univariate_kzg import UnivariateKzg

    kzg, ref = UnivariateKzg(device="cpu"), RefKzg()
    param, rparam = kzg.setup(n, 1, random.Random(0)), ref.setup(n, 1, random.Random(0))
    return kzg, ref, kzg.trim(param, n, 1), ref.trim(rparam, n, 1), param, rparam


def test_srs_matches_reference():
    from plonkish_tpu.curves.device import to_affine_host
    from plonkish_tpu_torch.curves import device as cdev
    from plonkish_tpu_torch.curves.specs import BN254_G1

    n = 16
    kzg, ref, _, _, param, rparam = _kzg_pair(n)
    got = [(int(p.x), int(p.y)) for p in cdev.affine_to_host(BN254_G1, param.powers_of_s_g1)]
    want = [(int(p.x), int(p.y)) for p in to_affine_host(ref.curve, rparam.powers_of_s_g1)]
    assert got == want
    assert sorted(param.offset_g2) == sorted(rparam.offset_g2)
    assert param.s_g2.x.a == rparam.s_g2.x.a


def test_open_and_batch_open_match_reference():
    """One opening, then the fflonk-style batched opening of three
    polynomials at overlapping point sets: equal proof bytes, and both
    verifiers accept."""
    from plonkish_tpu.backend.pcs_api import Evaluation as RefEvaluation
    from plonkish_tpu.utils.transcript import Keccak256Transcript as RefTranscript
    from plonkish_tpu_torch.utils.transcript import Keccak256Transcript

    n = 16
    kzg, ref, (pp, vp), (rpp, rvp), _, _ = _kzg_pair(n)
    polys = [_pair(m, 10 + m) for m in (16, 9, 12)]
    tr, rtr = Keccak256Transcript(S), RefTranscript(REF_FR)
    comms = [kzg.commit_and_write(pp, DUniPoly.from_unipoly(f), tr) for f, _ in polys]
    rcomms = [ref.commit_and_write(rpp, rf, rtr) for _, rf in polys]
    z = tr.squeeze_challenge()
    rtr.squeeze_challenge()
    f0, rf0 = polys[0]
    kzg.open(pp, DUniPoly.from_unipoly(f0), None, z, None, tr)
    ref.open(rpp, rf0, None, RefFp(int(z), REF_FR), None, rtr)
    points = [Fp(v, S) for v in _vals(3, 20)]
    pairs = [(0, 0), (0, 1), (1, 1), (1, 2), (2, 0)]
    evals = [Evaluation(i, j, polys[i][0].evaluate(points[j])) for i, j in pairs]
    kzg.batch_open(pp, [DUniPoly.from_unipoly(f) for f, _ in polys], comms, points, evals, tr)
    ref.batch_open(rpp, [rf for _, rf in polys], rcomms, [RefFp(int(v), REF_FR) for v in points],
                   [RefEvaluation(e.poly, e.point, RefFp(int(e.value), REF_FR)) for e in evals], rtr)
    proof = tr.into_proof()
    assert proof == rtr.into_proof()

    r = Keccak256Transcript.from_proof(S, proof)
    read = kzg.read_commitments(vp, 3, r)
    assert read == comms
    z_r = r.squeeze_challenge()
    kzg.verify(vp, read[0], z_r, f0.evaluate(z_r), r)
    kzg.batch_verify(vp, read, points, evals, r)
