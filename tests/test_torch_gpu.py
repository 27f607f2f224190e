"""Kernels K1-K4 on a CUDA card against their plain versions, and a golden
proof produced on the card.  Marked ``gpu``: without a card each test skips
(decided inside the test, never at import).  On the card run them with

    python -m pytest -p no:cacheprovider --noconftest -m gpu tests/test_torch_gpu.py

(``--noconftest``: the repository's conftest imports JAX, which the card's
machine does not have).  chip_smoke.py runs the same checks at larger sizes.
"""

import pathlib
import random

import pytest
import torch

GOLDEN = pathlib.Path(__file__).parent / "golden"


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _affine(curve, jac):
    from plonkish_tpu_torch.curves import device as cdev

    return cdev.jac_to_affine(curve, cdev.unpack_jac(jac))


@pytest.mark.gpu
def test_msm_kernels_match_plain(cuda):
    from plonkish_tpu_torch.curves import msm as tmsm
    from plonkish_tpu_torch.curves.host import AffinePoint
    from plonkish_tpu_torch.curves.specs import BN254_G1 as C
    from plonkish_tpu_torch.fields import limb
    from plonkish_tpu_torch.kernels import msm as kmsm

    rng = random.Random(5)
    n = 1000
    s = [rng.randrange(C.scalar.p) for _ in range(n)]
    bases = tmsm.fixed_base_msm(C, AffinePoint.generator(C), limb.from_canonical_ints(C.scalar, s, cuda))
    bases[1] = bases[0]
    bases[2:6] = 0
    scalars = limb.from_ints([rng.randrange(C.scalar.p) for _ in range(n)], cuda)
    scalars[6:20] = 0
    c = tmsm.window_size(n)
    w = tmsm.num_windows(C, c)
    keys, src, nb = tmsm.msm_entries(scalars, c, w)
    k1 = kmsm.msm_bucket_sums_cuda(C, bases, keys, src, w * nb)
    assert torch.equal(_affine(C, k1), _affine(C, kmsm.msm_bucket_sums_plain(C, bases, keys, src, w * nb)))
    buckets = k1.reshape(w, nb, 3, 8)
    k2 = kmsm.msm_window_sums_cuda(C, buckets)
    assert torch.equal(_affine(C, k2), _affine(C, kmsm.msm_window_sums_plain(C, buckets)))


@pytest.mark.gpu
def test_sumcheck_kernels_match_plain(cuda):
    from plonkish_tpu_torch.fields import limb
    from plonkish_tpu_torch.fields.host import Fp
    from plonkish_tpu_torch.fields.spec import BN254_FR as S
    from plonkish_tpu_torch.kernels import sumcheck as ksc
    from plonkish_tpu_torch.models.circuits import vanilla_plonk_expression
    from plonkish_tpu_torch.piop import sum_check as sc
    from plonkish_tpu_torch.poly.multilinear import MLPoly

    rng = random.Random(6)
    k = 10
    expr = vanilla_plonk_expression(S, k)
    polys = [MLPoly.from_ints(S, [rng.randrange(S.p) for _ in range(1 << k)], cuda) for _ in range(13)]
    vp = sc.VirtualPolynomial(expr, polys, [Fp(rng.randrange(S.p), S) for _ in range(3)],
                              [[Fp(rng.randrange(S.p), S) for _ in range(k)]])
    state = sc.ProverState(S, k, Fp.zero(S), vp)
    prover = sc.EvaluationsProver(state)
    ids = sc.identity_params(S, 0, state.identity_offset, cuda)
    args = (state.stacked, prover.instrs, prover.consts, prover.tape.num_regs,
            prover.tape.out_reg, state.degree, ids)
    assert torch.equal(ksc.sumcheck_round_cuda(S, *args), ksc.sumcheck_round_plain(S, *args))
    ch = limb.const(S, 99, cuda)
    assert torch.equal(ksc.fold_cuda(S, state.stacked, ch), ksc.fold_plain(S, state.stacked, ch))


@pytest.mark.gpu
def test_golden_k3_on_the_card(cuda):
    from plonkish_tpu_torch.backend.hyperplonk import HyperPlonk
    from plonkish_tpu_torch.fields.spec import BN254_FR
    from plonkish_tpu_torch.kernels import LAUNCHES, reset_launches
    from plonkish_tpu_torch.models.circuits import rand_vanilla_plonk_circuit
    from plonkish_tpu_torch.pcs.kzg import MultilinearKzg
    from plonkish_tpu_torch.utils.transcript import Keccak256Transcript

    ci, circuit = rand_vanilla_plonk_circuit(BN254_FR, 3, random.Random(1), random.Random(2))
    backend = HyperPlonk(MultilinearKzg())
    pp, vp = backend.preprocess(backend.setup(ci, random.Random(0)), ci)
    reset_launches()
    tr = Keccak256Transcript(BN254_FR)
    backend.prove(pp, circuit, tr)
    assert all(v > 0 for v in LAUNCHES.values()), LAUNCHES
    proof = tr.into_proof()
    assert proof == (GOLDEN / "hyperplonk_kzg_k3.bin").read_bytes()
    backend.verify(vp, circuit.instances(), Keccak256Transcript.from_proof(BN254_FR, proof))
