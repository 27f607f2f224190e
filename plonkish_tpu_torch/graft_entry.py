"""Entry points of the port's flagship step and of its multi-rank dry run
(port of the root ``__graft_entry__.py``).

- ``entry()``: the single-card forward step on the flagship compute, the
  vanilla-PLONK constraint evaluation and its round sum over the hypercube,
  and the fold of every column (the sum-check inner loop, SURVEY §3.1 hot
  loop #2), at k = 8.
- ``dryrun_multichip(n)``: n ranks over ``torch.distributed`` (the backend
  ``parallel.backend_for`` picks for n ranks on the device), each checking, on tiny shapes, the sharded round step
  against the unsharded one, the real sum-check under the mesh, a
  rotation-bearing sum-check whose transcript must equal the single-rank
  one byte for byte, and a small ``sharded_msm`` against the host
  Pippenger.  A rank that finds a mismatch raises, and the dry run with it.

    python -m plonkish_tpu_torch.graft_entry [--device cpu] [--ranks N]
"""

from __future__ import annotations

import argparse
import random

import torch

from . import parallel, resolve_device


def _example_polys(spec, k: int, device, seed: int = 7) -> torch.Tensor:
    """9 random columns of 2^k rows, Montgomery int32[9, 2^k, 8]."""
    from .fields import limb

    rng = random.Random(seed)
    n = 1 << k
    vals = [rng.randrange(spec.p) for _ in range(9 * n)]
    return limb.from_canonical_ints(spec, vals, device).reshape(9, n, limb.L)


def entry(device=None):
    """Returns (fn, example_args): fn(polys, challenge) -> (round sum [8],
    every column folded at the challenge [9, 2^7, 8]) at k = 8, on the card
    unless `device` says otherwise."""
    from .fields import limb
    from .fields.spec import BN254_FR as spec
    from .kernels import sumcheck as ksc
    from .parallel.sharded import vanilla_gate_eval

    dev = resolve_device(device)

    def forward(polys, challenge):
        round_sum = limb.sum_reduce(spec, vanilla_gate_eval(spec, polys))
        return round_sum, ksc.fold(spec, polys, challenge)

    polys = _example_polys(spec, 8, dev)
    return forward, (polys, limb.const(spec, 123456789, dev))


def _dryrun_rank(mesh) -> dict:
    """What each rank of ``dryrun_multichip`` checks; raises on a mismatch."""
    from .curves import device as cdev
    from .curves.host import AffinePoint, msm_host
    from .curves.msm import variable_base_msm
    from .curves.specs import BN254_G1
    from .fields import limb
    from .fields.host import Fp
    from .fields.spec import BN254_FR as spec
    from .kernels import sumcheck as ksc
    from .parallel.sharded import sharded_round_step, vanilla_gate_eval
    from .piop.sum_check import ClassicSumCheck, VirtualPolynomial, evaluate
    from .poly.multilinear import MLPoly
    from .utils import expression as ex
    from .utils.bh import BooleanHypercube
    from .utils.transcript import Keccak256Transcript

    dev = mesh.device
    w = mesh.world
    p = spec.p

    # 1. the sharded round step against the unsharded one
    k = max(4, (w - 1).bit_length() + 2)
    polys = _example_polys(spec, k, dev)
    challenge = limb.const(spec, 987654321, dev)
    total, folded = sharded_round_step(spec, mesh, polys, challenge)
    want_total = limb.sum_reduce(spec, vanilla_gate_eval(spec, polys))
    whole = ksc.fold(spec, polys, challenge)
    want_folded = parallel.row_block(whole.shape[1], mesh).take(whole, 1)
    assert torch.equal(total, want_total), "sharded round sum != single-rank step"
    assert torch.equal(folded, want_folded), "sharded fold != single-rank fold"

    # 2. the real sum-check under the mesh: verified, final evaluation checked
    rng = random.Random(5)
    kk = max(4, (w - 1).bit_length() + 1)
    nn = 1 << kk
    ints = [[rng.randrange(p) for _ in range(nn)] for _ in range(3)]
    mls = [MLPoly.from_ints(spec, v, dev) for v in ints]
    w0, w1, w2 = (ex.Polynomial(ex.Query(i, ex.Rotation(0))) for i in range(3))
    e = ex.CommonPoly(ex.EqXY(0)) * (w0 * w1 * w2 + w0)
    ys = [[Fp(rng.randrange(p), spec) for _ in range(kk)]]

    def eq_host(y, b):
        acc = 1
        for i in range(kk):
            yi = int(y[i])
            acc = acc * (yi if (b >> i) & 1 else (1 - yi) % p) % p
        return acc

    sum_i = sum(eq_host(ys[0], b) * ((ints[0][b] * ints[1][b] % p * ints[2][b] + ints[0][b]) % p)
                for b in range(nn)) % p
    before = mesh.taken["sum_check"]
    tr = Keccak256Transcript(spec)
    challenges, _ = ClassicSumCheck.evaluations().prove(
        spec, kk, VirtualPolynomial(e, mls, [], ys), Fp(sum_i, spec), tr)
    assert mesh.taken["sum_check"] == before + 1, "the sum-check was not sharded"
    final, ch2 = ClassicSumCheck.evaluations().verify(
        spec, kk, e.degree(), Fp(sum_i, spec), Keccak256Transcript.from_proof(spec, tr.into_proof()))
    assert [int(c) for c in ch2] == [int(c) for c in challenges]

    def ml_eval_host(vals, point):
        for x in point:
            xi = int(x)
            vals = [(v0 + (v1 - v0) * xi) % p for v0, v1 in zip(vals[0::2], vals[1::2])]
        return vals[0]

    evals = {q: Fp(ml_eval_host(list(ints[q.poly]), challenges), spec) for q in e.used_query()}
    assert int(evaluate(e, kk, evals, [], ys, list(challenges))) == int(final), \
        "sharded sum-check final evaluation mismatch"

    # 3. a rotation: a global permutation of the rows, gathered across blocks
    rot = BooleanHypercube(kk).rotation_map(1)
    e_rot = ex.CommonPoly(ex.EqXY(0)) * (w0 * ex.Polynomial(ex.Query(1, ex.Rotation(1))) + w2)
    sum_rot = sum(eq_host(ys[0], b) * ((ints[0][b] * ints[1][rot[b]] + ints[2][b]) % p)
                  for b in range(nn)) % p

    def prove_rot():
        t = Keccak256Transcript(spec)
        ClassicSumCheck.evaluations().prove(
            spec, kk, VirtualPolynomial(e_rot, mls, [], ys), Fp(sum_rot, spec), t)
        return t.into_proof()

    sharded_proof = prove_rot()
    with parallel.use_mesh(None):
        single_proof = prove_rot()
    assert sharded_proof == single_proof, "rotation-bearing sharded prove diverged"

    # 4. a small sharded MSM against the host Pippenger
    curve = BN254_G1
    g = AffinePoint.generator(curve)
    n_pts = 4 * w
    pts = [g.scalar_mul(rng.randrange(1, curve.scalar.p)) for _ in range(n_pts)]
    scalars = [rng.randrange(1 << 16) for _ in range(n_pts)]
    before = mesh.taken["msm"]
    got = variable_base_msm(curve, limb.from_ints(scalars, dev), cdev.affine_from_host(curve, pts, dev))
    assert mesh.taken["msm"] == before + 1 or w == 1, "the MSM did not take sharded_msm"
    assert got == msm_host([Fp(s, curve.scalar) for s in scalars], pts), "sharded MSM != host Pippenger"
    return {"rank": mesh.rank, "collectives": mesh.collectives, "bytes": mesh.bytes,
            "taken": dict(mesh.taken)}


def dryrun_multichip(n_ranks: int, device=None, deadline_s: float = 600.0) -> list:
    """Run the dry run on `n_ranks` new processes (on the cards unless
    `device` says otherwise), over NCCL with a card a rank, else over gloo.
    Returns each rank's collective counts; raises if a rank fails."""
    dev = resolve_device(device)
    return parallel.spawn(_dryrun_rank, n_ranks, parallel.backend_for(n_ranks, dev), dev,
                          deadline_s=deadline_s, threads=1 if dev.type == "cpu" else None)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--ranks", type=int, default=2)
    args = ap.parse_args(argv)
    device = None if args.device == "cuda" else args.device
    fn, example = entry(device)
    round_sum, folded = fn(*example)
    print(f"entry OK: round sum {tuple(round_sum.shape)}, folded {tuple(folded.shape)}", flush=True)
    stats = dryrun_multichip(args.ranks, device)
    print(f"dryrun_multichip({args.ranks}) OK: {stats}", flush=True)


if __name__ == "__main__":
    main()
