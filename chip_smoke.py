#!/usr/bin/env python3
"""Run the PyTorch/CUDA port (plonkish_tpu_torch) end to end on one CUDA card.

    python3 chip_smoke.py

Phases, each printed on its own line; any failure exits non-zero:

1. build the CUDA kernels from plonkish_tpu_torch/csrc (registers, shared
   memory and spills as ptxas reports them) and print the card;
2. every kernel against its plain PyTorch version on the card, on the same
   inputs, exact equality required (MSM K1+K2 at 2^12 points with edge cases
   and at 2^16 random points, sum-check round K3 at 2^16 pairs for the
   vanilla-PLONK expression and a degree-1 single-leaf one, fold K4);
3. the three frozen KZG proofs of tests/golden produced on the card, byte for
   byte, and accepted by the port's verifier;
4. HyperPlonk over BN254 with multilinear KZG on a random vanilla-PLONK
   circuit at k = 20: setup, preprocess, a warm-up prove, a timed prove with
   its span breakdown and kernel launch counts, verify, and a flipped byte
   rejected;
5. each kernel timed with CUDA events at the shapes of the k = 20 prove,
   beside its plain version and the least time the card could take.

The last three lines of standard output are the kernels JSON line, the card
as nvidia-smi reports it, and the result line.  The script imports no JAX
and nothing of the JAX package.
"""

import json
import os
import random
import subprocess
import sys
import time

K_FULL = 20
IMAD_PER_S = 132 * 64 * 1.98e9  # H100 SXM: 64 INT32 IMAD per SM and clock
BYTES_PER_S = 3.35e12  # H100 SXM HBM3
FE_MUL_IMAD = 256  # 128 32x32->64-bit partial products, 2 IMAD each
MADD_MULS = 11  # mixed Jacobian addition: 7M + 4S
JADD_MULS = 16  # full Jacobian addition: 11M + 5S


def log(msg):
    print(msg, flush=True)


def fail(msg):
    log(f"FAIL: {msg}")
    sys.exit(1)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card is available", file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, "plonkish_tpu_torch")):
        print("chip_smoke: the plonkish_tpu_torch package is missing", file=sys.stderr)
        return 2
    sys.path.insert(0, here)
    t_start = time.time()

    from plonkish_tpu_torch.kernels import LAUNCHES, build, reset_launches

    # ---------------------------------------------------------------- 1 build
    t0 = time.time()
    path = build.build_cuda()
    log(f"[build] {path.name} in {time.time() - t0:.1f}s")
    for line in build.ptxas_log.splitlines():
        if "Compiling entry" in line or "registers" in line or "spill" in line:
            log(f"[build] {line.strip()}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"[card] {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    phase2_kernels(torch)
    phase3_golden(torch, here)
    main_path, shapes = phase4_full(torch, K_FULL, LAUNCHES, reset_launches)
    kernels = phase5_timing(torch, shapes, main_path)
    log(f"[done] {time.time() - t_start:.1f}s")

    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


# --------------------------------------------------------------------- helpers

def rand_field(torch, spec, n, gen, device="cuda"):
    """n uniform-ish canonical field elements as raw limbs (top limb kept
    below p's), from a seeded torch generator."""
    from plonkish_tpu_torch.fields import limb

    raw = torch.randint(0, 1 << 32, (n, 8), generator=gen, dtype=torch.int64)
    raw[:, 7] %= spec.p >> 224
    raw = torch.where(raw >= 1 << 31, raw - (1 << 32), raw).to(torch.int32)
    return raw.to(device)


def cuda_ms(torch, fn, reps):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def affine_equal(torch, curve, a, b):
    from plonkish_tpu_torch.curves import device as cdev

    return torch.equal(cdev.jac_to_affine(curve, cdev.unpack_jac(a)),
                       cdev.jac_to_affine(curve, cdev.unpack_jac(b)))


def vanilla_state(torch, num_vars, gen, device="cuda"):
    """A zero-check prover state of the vanilla-PLONK expression with random
    tables of the main path's count and size."""
    from plonkish_tpu_torch.fields.host import Fp
    from plonkish_tpu_torch.fields.spec import BN254_FR
    from plonkish_tpu_torch.fields import limb
    from plonkish_tpu_torch.models.circuits import vanilla_plonk_expression
    from plonkish_tpu_torch.piop.sum_check import (
        EvaluationsProver, ProverState, VirtualPolynomial,
    )
    from plonkish_tpu_torch.poly.multilinear import MLPoly

    spec = BN254_FR
    expr = vanilla_plonk_expression(spec, num_vars)
    num_polys = 1 + max(q.poly for q in expr.used_query())
    rng = random.Random(7)
    polys = [
        MLPoly(spec, limb.to_mont(spec, rand_field(torch, spec, 1 << num_vars, gen, device)))
        for _ in range(num_polys)
    ]
    challenges = [Fp(rng.randrange(spec.p), spec) for _ in range(3)]
    y = [Fp(rng.randrange(spec.p), spec) for _ in range(num_vars)]
    state = ProverState(spec, num_vars, Fp.zero(spec), VirtualPolynomial(expr, polys, challenges, [y]))
    return state, EvaluationsProver(state)


def msm_inputs(torch, n, gen, edge):
    """(bases, scalars) of n points: multiples of G by random scalars, with
    repeated points, opposite points, identities and zero scalars when edge."""
    from plonkish_tpu_torch.curves import msm as tmsm
    from plonkish_tpu_torch.curves.host import AffinePoint
    from plonkish_tpu_torch.curves.specs import BN254_G1
    from plonkish_tpu_torch.fields import limb

    curve = BN254_G1
    s = limb.to_mont(curve.scalar, rand_field(torch, curve.scalar, n, gen))
    bases = tmsm.fixed_base_msm(curve, AffinePoint.generator(curve), s)
    scalars = rand_field(torch, curve.scalar, n, gen)
    if edge:
        bases[1] = bases[0]  # a repeated point
        bases[2, 0] = bases[0, 0]  # the opposite point
        bases[2, 1] = limb.neg(curve.base, bases[0, 1][None])[0]
        bases[3:8] = 0  # identities
        scalars[1:3] = scalars[0]  # P + P + (-P) in the same buckets
        scalars[8:16] = 0  # zero scalars
        scalars[16:24] = scalars[24]  # one bucket per window takes 9 points
        scalars[40:48, 1:] = 0  # small scalars
    return curve, bases, scalars


# ------------------------------------------------------ 2 kernels vs plain

def phase2_kernels(torch):
    from plonkish_tpu_torch.curves import msm as tmsm
    from plonkish_tpu_torch.fields import limb
    from plonkish_tpu_torch.fields.spec import BN254_FR
    from plonkish_tpu_torch.kernels import msm as kmsm
    from plonkish_tpu_torch.kernels import sumcheck as ksc
    from plonkish_tpu_torch.piop.sum_check import identity_params
    from plonkish_tpu_torch.piop.tape import compile_tape
    from plonkish_tpu_torch.utils import expression as ex
    from plonkish_tpu_torch.utils.expression import Query, Rotation

    gen = torch.Generator().manual_seed(1)
    for n, edge in ((1 << 12, True), (1 << 16, False)):
        t0 = time.time()
        curve, bases, scalars = msm_inputs(torch, n, gen, edge)
        c = tmsm.window_size(n)
        w = tmsm.num_windows(curve, c)
        keys, src, nb = tmsm.msm_entries(scalars, c, w)
        k1 = kmsm.msm_bucket_sums_cuda(curve, bases, keys, src, w * nb)
        k1_plain = kmsm.msm_bucket_sums_plain(curve, bases, keys, src, w * nb)
        if not affine_equal(torch, curve, k1, k1_plain):
            fail(f"K1 msm_bucket_sums differs from its plain version at n={n}")
        buckets = k1.reshape(w, nb, 3, 8)
        k2 = kmsm.msm_window_sums_cuda(curve, buckets)
        k2_plain = kmsm.msm_window_sums_plain(curve, buckets)
        if not affine_equal(torch, curve, k2, k2_plain):
            fail(f"K2 msm_window_sums differs from its plain version at n={n}")
        if tmsm.combine_windows(curve, k2, c) != tmsm.combine_windows(curve, k2_plain, c):
            fail(f"MSM result differs at n={n}")
        log(f"[kernels] K1+K2 MSM n={n} edge={edge}: {w * nb} buckets, 0 mismatches "
            f"({time.time() - t0:.1f}s)")

    state, prover = vanilla_state(torch, 17, gen)
    ids = identity_params(BN254_FR, 0, state.identity_offset, "cuda")
    args = (state.stacked, prover.instrs, prover.consts, prover.tape.num_regs,
            prover.tape.out_reg, state.degree, ids)
    k3 = ksc.sumcheck_round_cuda(BN254_FR, *args)
    k3_plain = ksc.sumcheck_round_plain(BN254_FR, *args)
    if not torch.equal(k3, k3_plain):
        fail("K3 sumcheck_round differs from its plain version (vanilla expression)")
    log(f"[kernels] K3 round, vanilla expression, {state.stacked.shape[1] // 2} pairs, "
        f"{state.stacked.shape[0]} tables, degree {state.degree}: 0 mismatches")
    leaf = ex.Polynomial(Query(0, Rotation(0)))
    tape = compile_tape(leaf, BN254_FR)
    single = state.stacked[:1].contiguous()
    args1 = (single, tape.instrs, tape.const_rows(BN254_FR, "cuda"), tape.num_regs,
             tape.out_reg, 1, ids)
    if not torch.equal(ksc.sumcheck_round_cuda(BN254_FR, *args1),
                       ksc.sumcheck_round_plain(BN254_FR, *args1)):
        fail("K3 sumcheck_round differs from its plain version (degree-1 single leaf)")
    log("[kernels] K3 round, degree-1 single leaf: 0 mismatches")
    ch = limb.const(BN254_FR, 0x1234567890ABCDEF, "cuda")
    if not torch.equal(ksc.fold_cuda(BN254_FR, state.stacked, ch),
                       ksc.fold_plain(BN254_FR, state.stacked, ch)):
        fail("K4 sumcheck_fold differs from its plain version")
    log(f"[kernels] K4 fold, {state.stacked.shape[0]} tables x {state.stacked.shape[1]} rows: "
        "0 mismatches")


# ------------------------------------------------------ 3 golden proofs

def phase3_golden(torch, here):
    from plonkish_tpu_torch.backend.hyperplonk import HyperPlonk
    from plonkish_tpu_torch.fields.spec import BN254_FR
    from plonkish_tpu_torch.models.circuits import (
        rand_vanilla_plonk_circuit, rand_vanilla_plonk_with_lookup_circuit,
    )
    from plonkish_tpu_torch.pcs.kzg import MultilinearKzg
    from plonkish_tpu_torch.utils.transcript import Keccak256Transcript

    for name, k, fn in (
        ("hyperplonk_kzg_k3", 3, rand_vanilla_plonk_circuit),
        ("hyperplonk_kzg_k5", 5, rand_vanilla_plonk_circuit),
        ("hyperplonk_kzg_lookup_k5", 5, rand_vanilla_plonk_with_lookup_circuit),
    ):
        t0 = time.time()
        ci, circuit = fn(BN254_FR, k, random.Random(1), random.Random(2))
        backend = HyperPlonk(MultilinearKzg())
        param = backend.setup(ci, random.Random(0))
        pp, vp = backend.preprocess(param, ci)
        tr = Keccak256Transcript(BN254_FR)
        backend.prove(pp, circuit, tr)
        proof = tr.into_proof()
        with open(os.path.join(here, "tests", "golden", f"{name}.bin"), "rb") as fh:
            want = fh.read()
        if proof != want:
            fail(f"golden proof {name} differs on the card")
        backend.verify(vp, circuit.instances(), Keccak256Transcript.from_proof(BN254_FR, proof))
        log(f"[golden] {name}: {len(proof)} bytes equal, verified ({time.time() - t0:.1f}s)")


# ------------------------------------------------------ 4 full size

def phase4_full(torch, k, launches, reset_launches):
    from plonkish_tpu_torch.backend.hyperplonk import HyperPlonk
    from plonkish_tpu_torch.fields.spec import BN254_FR
    from plonkish_tpu_torch.models.circuits import rand_vanilla_plonk_circuit
    from plonkish_tpu_torch.pcs.kzg import MultilinearKzg
    from plonkish_tpu_torch.utils import timer
    from plonkish_tpu_torch.utils.transcript import Keccak256Transcript

    times = {}
    t0 = time.time()
    ci, circuit = rand_vanilla_plonk_circuit(BN254_FR, k, random.Random(1), random.Random(2))
    times["circuit"] = time.time() - t0
    backend = HyperPlonk(MultilinearKzg())
    torch.cuda.synchronize()
    t0 = time.time()
    param = backend.setup(ci, random.Random(0))
    torch.cuda.synchronize()
    times["setup"] = time.time() - t0
    t0 = time.time()
    pp, vp = backend.preprocess(param, ci)
    torch.cuda.synchronize()
    times["preprocess"] = time.time() - t0
    log(f"[k={k}] circuit {times['circuit']:.2f}s, setup {times['setup']:.2f}s, "
        f"preprocess {times['preprocess']:.2f}s")

    t0 = time.time()
    backend.prove(pp, circuit, Keccak256Transcript(BN254_FR))
    torch.cuda.synchronize()
    log(f"[k={k}] warm-up prove {time.time() - t0:.2f}s")

    timer.set_sync(torch.cuda.synchronize)
    timer.set_enabled(True)
    timer.reset_trace()
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    tr = Keccak256Transcript(BN254_FR)
    torch.cuda.synchronize()
    t0 = time.time()
    backend.prove(pp, circuit, tr)
    torch.cuda.synchronize()
    times["prove"] = time.time() - t0
    main_path = dict(launches)
    timer.set_enabled(False)
    peak = torch.cuda.max_memory_allocated()
    proof = tr.into_proof()
    log(f"[k={k}] prove {times['prove']:.3f}s, {len(proof)} bytes, "
        f"peak device memory {peak / 2**30:.2f} GiB")
    spans = [(n, d, s) for n, d, s in timer.trace() if d <= 1]
    for name, depth, sec in spans:
        log(f"[k={k}] span {'  ' * depth}{name}: {sec * 1e3:.1f} ms")
    top = sum(s for _, d, s in spans if d == 0)
    log(f"[k={k}] outside top-level spans: {(times['prove'] - top) * 1e3:.1f} ms")
    log(f"[k={k}] kernel launches in the timed prove: {json.dumps(main_path)}")
    for name, count in main_path.items():
        if count <= 0:
            fail(f"kernel {name} was not launched in the k={k} prove")

    t0 = time.time()
    backend.verify(vp, circuit.instances(), Keccak256Transcript.from_proof(BN254_FR, proof))
    times["verify"] = time.time() - t0
    bad = bytearray(proof)
    bad[len(bad) // 2] ^= 1
    try:
        backend.verify(vp, circuit.instances(), Keccak256Transcript.from_proof(BN254_FR, bytes(bad)))
    except (ValueError, EOFError):
        pass
    else:
        fail("a proof with a flipped byte was accepted")
    log(f"[k={k}] verify {times['verify']:.2f}s; flipped byte rejected")
    log(f"[k={k}] times {json.dumps({n: round(v, 4) for n, v in times.items()})}")
    return main_path, {"pp": pp, "k": k}


# ------------------------------------------------------ 5 kernel timing

def phase5_timing(torch, shapes, main_path):
    from plonkish_tpu_torch.curves import msm as tmsm
    from plonkish_tpu_torch.curves.specs import BN254_G1
    from plonkish_tpu_torch.fields.spec import BN254_FR
    from plonkish_tpu_torch.kernels import msm as kmsm
    from plonkish_tpu_torch.kernels import sumcheck as ksc
    from plonkish_tpu_torch.fields import limb
    from plonkish_tpu_torch.piop.sum_check import identity_params
    from plonkish_tpu_torch.piop.tape import OP_MUL

    k = shapes["k"]
    gen = torch.Generator().manual_seed(2)
    curve = BN254_G1
    n = 1 << k
    bases = shapes["pp"].pcs.eq(k)
    scalars = rand_field(torch, curve.scalar, n, gen)
    c = tmsm.window_size(n)
    w = tmsm.num_windows(curve, c)
    keys, src, nb = tmsm.msm_entries(scalars, c, w)
    m = keys.numel()
    unique = int((keys[1:] != keys[:-1]).sum().item()) + 1
    k1_ms = cuda_ms(torch, lambda: kmsm.msm_bucket_sums_cuda(curve, bases, keys, src, w * nb), 3)
    k1_plain_ms = cuda_ms(torch, lambda: kmsm.msm_bucket_sums_plain(curve, bases, keys, src, w * nb), 1)
    buckets = kmsm.msm_bucket_sums_cuda(curve, bases, keys, src, w * nb)
    k1_err = 0 if affine_equal(torch, curve, buckets, kmsm.msm_bucket_sums_plain(
        curve, bases, keys, src, w * nb)) else 1
    buckets = buckets.reshape(w, nb, 3, 8)
    k2_ms = cuda_ms(torch, lambda: kmsm.msm_window_sums_cuda(curve, buckets), 3)
    k2_plain_ms = cuda_ms(torch, lambda: kmsm.msm_window_sums_plain(curve, buckets), 1)
    k2_err = 0 if affine_equal(torch, curve, kmsm.msm_window_sums_cuda(curve, buckets),
                               kmsm.msm_window_sums_plain(curve, buckets)) else 1
    log(f"[timing] MSM 2^{k}: c={c}, {w} windows, {m} entries, {unique} buckets used")

    state, prover = vanilla_state(torch, k, gen)
    ids = identity_params(BN254_FR, 0, state.identity_offset, "cuda")
    args = (state.stacked, prover.instrs, prover.consts, prover.tape.num_regs,
            prover.tape.out_reg, state.degree, ids)
    k3_ms = cuda_ms(torch, lambda: ksc.sumcheck_round_cuda(BN254_FR, *args), 3)
    k3_plain_ms = cuda_ms(torch, lambda: ksc.sumcheck_round_plain(BN254_FR, *args), 1)
    k3_err = 0 if torch.equal(ksc.sumcheck_round_cuda(BN254_FR, *args),
                              ksc.sumcheck_round_plain(BN254_FR, *args)) else 1
    ch = limb.const(BN254_FR, 0x1234567890ABCDEF, "cuda")
    k4_ms = cuda_ms(torch, lambda: ksc.fold_cuda(BN254_FR, state.stacked, ch), 10)
    k4_plain_ms = cuda_ms(torch, lambda: ksc.fold_plain(BN254_FR, state.stacked, ch), 1)
    k4_err = 0 if torch.equal(ksc.fold_cuda(BN254_FR, state.stacked, ch),
                              ksc.fold_plain(BN254_FR, state.stacked, ch)) else 1
    t_count, rows, _ = state.stacked.shape
    pairs = rows // 2
    n_mul = int((prover.instrs[:, 0] == OP_MUL).sum())
    log(f"[timing] round 0 state: {t_count} tables x 2^{k} rows, tape "
        f"{len(prover.instrs)} instructions ({n_mul} products), degree {state.degree}")

    def bound(ops, nbytes):
        t_ops, t_bytes = ops / IMAD_PER_S, nbytes / BYTES_PER_S
        return (max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes")

    rows_out = []
    for name, source, replaces, ms, plain_ms, err, ops, nbytes in (
        ("msm_bucket_sums", "plonkish_tpu_torch/csrc/msm.cu",
         "plonkish_tpu/pallas/msm.py:46", k1_ms, k1_plain_ms, k1_err,
         (m - unique) * MADD_MULS * FE_MUL_IMAD, n * 64 + m * 8 + unique * 96),
        ("msm_window_sums", "plonkish_tpu_torch/csrc/msm.cu",
         "plonkish_tpu/pallas/msm.py:119", k2_ms, k2_plain_ms, k2_err,
         w * (nb - 1) * 2 * JADD_MULS * FE_MUL_IMAD, w * nb * 96 + w * 96),
        ("sumcheck_round", "plonkish_tpu_torch/csrc/sumcheck.cu",
         "plonkish_tpu/pallas/sumcheck.py:159", k3_ms, k3_plain_ms, k3_err,
         pairs * (state.degree * n_mul + 1) * FE_MUL_IMAD, t_count * rows * 32),
        ("sumcheck_fold", "plonkish_tpu_torch/csrc/sumcheck.cu",
         "plonkish_tpu/pallas/sumcheck.py:225", k4_ms, k4_plain_ms, k4_err,
         t_count * pairs * FE_MUL_IMAD, t_count * rows * 32 + t_count * pairs * 32),
    ):
        if err:
            fail(f"{name} differs from its plain version at the k={k} shapes")
        b_ms, b_by = bound(ops, nbytes)
        rows_out.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": main_path[name], "max_abs_err": 0, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None,
        })
        log(f"[timing] {name}: {ms:.3f} ms (plain {plain_ms:.1f} ms, bound {b_ms:.3f} ms "
            f"by {b_by}), {main_path[name]} launches in the prove")
    return rows_out


if __name__ == "__main__":
    sys.exit(main())
