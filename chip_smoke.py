#!/usr/bin/env python3
"""Run the PyTorch/CUDA port (plonkish_tpu_torch) end to end on one CUDA card.

    python3 chip_smoke.py

Phases, each printed on its own line; any failure exits non-zero:

1. build the CUDA kernels from plonkish_tpu_torch/csrc (registers, shared
   memory and spills as ptxas reports them; K1 and K2 for BN254 G1 and
   Grumpkin G1, K4 over Fr and Fq, the IPA base fold) and, in parallel with
   them, the sum-check round kernels K3 that kernels/sumcheck_gen.py
   generates for the expressions this script runs (over Fr: vanilla PLONK,
   vanilla PLONK with lookups, a degree-1 single leaf, a wide degree-9
   expression of 41 tables, the zero-checks of the harness's aggregation
   circuit and of sha256 at each k phase 10 runs it at (its tape depends on
   k; 185 registers, kept in a local array), and the deciders of Protostar and Sangria over each
   of the two vanilla circuits; over Fq: vanilla PLONK, vanilla PLONK with
   lookups and Protostar's vanilla decider, the IPA path's), with each one's
   ptxas line and build seconds; the vanilla and lookup kernels must have a
   0-byte stack frame and no spills; print the card.  The two sha256 tapes
   take about two minutes each: they build in a thread of their own through
   phases 2 and 3, and are printed and held against their plain version
   (as phase 2 holds the others) once they are built, before phase 4;
2. every kernel against its plain PyTorch version on the card, on the same
   inputs, exact equality required (MSM K1+K2 on BN254 at 2^12 points with
   edge cases, at 2^16 random points and at 2^16 selector-like scalars in
   {0, 1, 2, p - 1}, and on Grumpkin at 2^12 with edge cases and 2^16 at
   random; one variable_base_msm at 2^16 enqueued under
   torch.cuda.set_sync_debug_mode("error") up to its one-point read;
   sum-check round K3 for every expression of phase 1 at 2^16 pairs and at
   one pair, fold K4 over Fr and Fq, the IPA base fold at
   2^12 points with identities for xi in {0, 1, q - 1, random}, the
   mont_mul chain probe K5 with both multipliers at 2^16 elements);
3. the nine frozen HyperPlonk proofs of tests/golden (KZG k3, k5 and lookup
   k5; Gemini, Zeromorph, IPA and Hyrax k5; Brakedown k3 and k5) and the
   Protostar decider proof (KZG, k3, after two folds) produced on the card,
   byte for byte, and accepted by the port's verifier;
4. HyperPlonk over BN254 with multilinear KZG on a random vanilla-PLONK
   circuit at k = 20: setup, preprocess, a warm-up prove, a timed prove with
   its span breakdown and kernel launch counts, verify, and a flipped byte
   rejected; the timed prove must build no K3 kernel (the count of
   generated kernels is printed);
5. each kernel timed with CUDA events at the shapes of the k = 20 proves (K5
   at 2^22 elements, 16 products deep, both multipliers), beside its plain
   version and the least time the card could take; the operation and byte
   counts are those of plonkish_tpu_torch/roofline.py, and the [peaks] line
   says which multiply-add rate, measured by K5 or assumed, the bounds used;
   also K1 on selector-like scalars at 2^20, the whole variable_base_msm at
   2^20 and at 2^10 (its fixed cost), and K3 summed over the 20 rounds of
   the k = 20 zero-check with K4 between rounds; then the Grumpkin K1 and K2
   at 2^20 points of the IPA basis, K3 and K4 over Fq at the k = 20 shapes
   and the IPA base fold at 2^19 points;
6. the bench harness in process (plonkish_tpu_torch.benchmark): the
   zero_check system at k = 18 (20 until phase 11 came) and the pcs kzg
   system at k = 20, whose rows are read back from
   target/bench_torch/, with the launch counts of the five kernels of that
   path;
7. HyperPlonk over BN254 Fq with the multilinear IPA on Grumpkin on a random
   vanilla-PLONK circuit at k = 20: setup (the basis of 2^20 points hashed
   to the curve on the card), preprocess, a warm-up prove, a timed prove
   with its span breakdown and launch counts (K1 and K2 on Grumpkin, K3 and
   K4 over Fq, the IPA base fold), verify, and a flipped byte rejected; then
   the harness's pcs system at k = 16 for gemini, zeromorph, hyrax,
   brakedown and ipa, with the rows read back (k = 20 until phase 8 came,
   18 until the script ran past its time on a slower host: PERF.md keeps
   those rows);
8. folding at full size: Protostar over BN254 with multilinear KZG on the
   random vanilla-PLONK circuit of phase 4 at k = 20: setup, preprocess, then
   timed, two folds (the circuit of phase 4 and one with another witness)
   and the decider with the NARK of phase 4's circuit again, each fold's and the
   decider's ms, the span breakdown, the peak device memory and the launches
   of K1-K4 in that region (each must launch, and no K3 may be built there);
   the decider verified and a flipped byte rejected; then the harness's
   sangria system at k = 16 in process (20 until phase 11 came, then 18),
   its fold and decider rows read back;
9. univariate (halo2-style) PLONK over BN254 with the univariate KZG on the
   circuit of phase 4 at k = 20: setup (4 * 2^20 powers), preprocess with its
   spans, a warm-up prove, a timed prove with its spans, peak device memory
   and launches (K1 and K2 must launch, K3 and K4 must not), verify, and a
   flipped byte rejected; one forward NTT of 2^22 points timed; then the
   harness's univariate_plonk row at k = 16;
10. HyperPlonk over BN254 with multilinear KZG on the harness's benchmark
   circuits: the aggregation ladder at k = 20 (the reference's default
   workload; phase 4's SRS) and sha256 at k = 16 (468 blocks: its Python
   synthesis takes about 30 ms a block, so k = 20's 7,489 blocks would take
   about 220 s before any prove), each synthesised, preprocessed, proved
   (warm-up, then timed with spans, peak and K1-K4 launches, no K3 built),
   verified and a flipped byte rejected; then the harness's hyperplonk rows
   of aggregation at k = 18 and sha256 at k = 14.  Phase 11 (b)'s ranks
   start with this phase and set up beside the aggregation synthesis;
   nothing here touches the card again before they are set up;
11. the sharded prover (plonkish_tpu_torch.parallel) on phase 4's circuit at
   k = 20: (a) in this process under a one-rank NCCL mesh, a warm-up prove
   and a timed prove with its spans, launches and collectives, whose proof
   must equal phase 4's byte for byte; (b) two ranks sharing the card over
   gloo, each its own process that reads phase 4's SRS back from
   target/srs_cache_torch/, synthesises the circuit, preprocesses and
   proves a warm-up (all while phase 10 runs), then waits for (a) to end
   before its timed prove: each rank's proof must equal phase 4's,
   each must launch K1-K4 on its rows and take sharded_msm; each rank's
   prove time, collectives, bytes and peak device memory are printed (one
   card, so no scaling is claimed: the two ranks share it).

The last three lines of standard output are the kernels JSON line, the card
as nvidia-smi reports it, and the result line.  The script imports no JAX
and nothing of the JAX package.
"""

import json
import os
import random
import re
import subprocess
import sys
import threading
import time

K_FULL = 20
# harness rows cut so that the script fits its time on a slow host: phase 7's
# pcs rows from 20 to 18 (for phase 8), then to 16, phase 8's sangria row from
# 20 to 18 (for phase 11), then to 16
K_PCS_ROWS = 16
K_SANGRIA_ROW = 16
K_ZERO_CHECK_ROW = 18  # phase 6's zero_check row, cut from 20 for the same reason
PROVER_KERNELS = ("msm_bucket_sums", "msm_window_sums", "sumcheck_round", "sumcheck_fold")
# the decider tapes of phase 8, the harness's sangria and the IPA path:
# (name, scheme, circuit of models.circuits)
DECIDERS = (
    ("protostar_vanilla", "protostar", "rand_vanilla_plonk_circuit"),
    ("protostar_lookup", "protostar", "rand_vanilla_plonk_with_lookup_circuit"),
    ("sangria_vanilla", "sangria", "rand_vanilla_plonk_circuit"),
    ("sangria_lookup", "sangria", "rand_vanilla_plonk_with_lookup_circuit"),
)
IPA_KERNELS = PROVER_KERNELS + ("ipa_base_fold",)
K_SHA256 = 16  # phase 10's sha256 circuit: 468 blocks (k = 20 would be 7,489)
# harness rows of 9 and 10
K_UNIVARIATE_ROW, K_AGGREGATION_ROW, K_SHA256_ROW = 16, 18, 14
# phase 10's zero-check tapes: (circuit, k).  The sha256 expression holds the
# permutation's identity offsets i * 2^k, and where one equals a bit weight
# 2^j of the gates the two constants share a row of the tape's constant
# table, so its structure, and its kernel, depends on k.
BENCH_TAPES = {
    "aggregation": ("aggregation", K_FULL),
    f"sha256_k{K_SHA256}": ("sha256", K_SHA256),
    f"sha256_k{K_SHA256_ROW}": ("sha256", K_SHA256_ROW),
}
# the sha256 tapes take about two minutes each to build: they build in the
# background through phases 2 and 3, and are checked before phase 4
LATE_TAPES = tuple(name for name, (circuit, _) in BENCH_TAPES.items() if circuit == "sha256")
NEW_PCS = ("gemini", "zeromorph", "hyrax", "brakedown", "ipa")


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
    os.chdir(here)  # the harness writes its rows under ./target
    t_start = time.time()

    from plonkish_tpu_torch.kernels import LAUNCHES, build, reset_launches

    # ---------------------------------------------------------------- 1 build
    t0 = time.time()
    built = {}
    main_lib = threading.Thread(target=lambda: built.update(
        path=build.build_cuda(), seconds=time.time() - t0))
    main_lib.start()
    structures, late = phase1_round_kernels(torch)
    main_lib.join()
    if "path" not in built:
        fail("the kernel library did not build")
    log(f"[build] {built['path'].name} in {built['seconds']:.1f}s; phase 1 done in "
        f"{time.time() - t0:.1f}s, the sha256 tapes still building")
    for line in build.ptxas_log.splitlines():
        if "Compiling entry" in line or "registers" in line or "spill" in line:
            log(f"[build] {line.strip()}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"[card] {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    def at(phase):
        log(f"[phase {phase}] starts {time.time() - t_start:.1f}s into the script")

    at(2)
    phase2_kernels(torch, structures)
    at(3)
    phase3_golden(torch, here)
    late_round_kernels(torch, late, structures)
    at(4)
    main_path, shapes = phase4_full(torch, K_FULL, LAUNCHES, reset_launches)
    at(5)
    kernels = phase5_timing(torch, shapes, main_path)
    at(6)
    harness_path = phase6_harness(K_FULL, LAUNCHES, reset_launches)
    at(7)
    ipa_path = phase7_ipa(torch, K_FULL, LAUNCHES, reset_launches)
    phase7_harness(K_PCS_ROWS, LAUNCHES, reset_launches)
    at(8)
    phase8_folding(torch, K_FULL, LAUNCHES, reset_launches, shapes)
    at(9)
    phase9_univariate(torch, K_FULL, LAUNCHES, reset_launches, shapes)
    at(10)
    ranks = SharedCardRanks(K_FULL, shapes["srs_path"])
    try:
        phase10_circuits(torch, K_FULL, LAUNCHES, reset_launches, shapes, ranks)
        at(11)
        phase11_sharded(torch, K_FULL, LAUNCHES, reset_launches, shapes, ranks)
    finally:
        ranks.close()
    for row in kernels:  # each kernel's launches on the path that runs it
        if row["name"] == "mont_mul_chain":
            row["launches"] = harness_path["mont_mul_chain"]
        elif row["path"] == "ipa":
            row["launches"] = ipa_path[row["counter"]]
        del row["path"], row["counter"]
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


def probe_inputs(torch, spec, n, gen):
    """(a, b) for K5: random Montgomery elements with rows 0..7 set to 0, 1,
    p - 1, R mod p, R^2 mod p, 2^255 - 19 reduced and two equal operands."""
    from plonkish_tpu_torch.fields import limb

    a, b = rand_field(torch, spec, n, gen), rand_field(torch, spec, n, gen)
    r = (1 << 256) % spec.p
    edge = [0, 1, spec.p - 1, r, r * r % spec.p, ((1 << 255) - 19) % spec.p]
    a[: len(edge)] = limb.from_ints(edge, "cuda")
    b[2] = a[2]
    b[6:8] = a[6:8]
    return a.contiguous(), b.contiguous()


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


def zero_check_state(torch, num_vars, gen, device="cuda", name="vanilla_plonk_expression",
                     spec=None):
    """A zero-check prover state of a models.circuits expression (vanilla
    PLONK unless named) or of a harness circuit's (BENCH_TAPES) over
    `spec` (BN254 Fr unless given) with random tables of the main path's
    count and size."""
    from plonkish_tpu_torch.fields.host import Fp
    from plonkish_tpu_torch.fields.spec import BN254_FR
    from plonkish_tpu_torch.fields import limb
    from plonkish_tpu_torch.models import circuits
    from plonkish_tpu_torch.piop.sum_check import (
        EvaluationsProver, ProverState, VirtualPolynomial,
    )
    from plonkish_tpu_torch.poly.multilinear import MLPoly

    spec = spec or BN254_FR
    expr = (benchmark_expression(name) if name in BENCH_TAPES
            else getattr(circuits, name)(spec, num_vars))
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


def benchmark_expression(name):
    """The zero-check expression (compose) of a tape of BENCH_TAPES over BN254
    Fr.  It depends on the circuit's structure and k, not on the witness: one
    sha256 block at the tape's k gives it, and the aggregation ladder's is
    the same at every k from 2 on (its constants 2 and 3 meet no offset)."""
    from plonkish_tpu_torch.backend.hyperplonk.preprocessor import compose
    from plonkish_tpu_torch.fields.spec import BN254_FR
    from plonkish_tpu_torch.models.aggregation import rand_aggregation_circuit
    from plonkish_tpu_torch.models.sha256 import sha256_circuit

    circuit, k = BENCH_TAPES[name]
    if circuit == "aggregation":
        info, _ = rand_aggregation_circuit(BN254_FR, 4, random.Random(1), random.Random(2))
    else:
        info, _, _ = sha256_circuit(b"abc", k=k)
    return compose(info)[1]


def decider_state(torch, num_vars, gen, device, scheme, circuit, spec):
    """(state, EvaluationsProver) of the decider's sum-check of `scheme`
    ("protostar" or "sangria") over the structure of `circuit` (a function
    of models.circuits), on random tables, challenges, y and sum."""
    from plonkish_tpu_torch.accumulation.protostar import (
        ProtostarStrategy, protostar_expressions,
    )
    from plonkish_tpu_torch.fields.host import Fp
    from plonkish_tpu_torch.fields import limb
    from plonkish_tpu_torch.models import circuits
    from plonkish_tpu_torch.piop.sum_check import (
        EvaluationsProver, ProverState, VirtualPolynomial,
    )
    from plonkish_tpu_torch.poly.multilinear import MLPoly

    info, _ = getattr(circuits, circuit)(spec, 4, random.Random(42), random.Random(0))
    strategy = (ProtostarStrategy.Compressing if scheme == "protostar"
                else ProtostarStrategy.NoCompressing)
    exprs = protostar_expressions(info, strategy)
    expr = exprs.expression
    polys = [
        MLPoly(spec, limb.to_mont(spec, rand_field(torch, spec, 1 << num_vars, gen, device)))
        for _ in range(1 + max(q.poly for q in expr.used_query()))
    ]
    rng = random.Random(8)
    # the folded challenges and u, then beta, gamma and alpha
    challenges = [Fp(rng.randrange(spec.p), spec) for _ in range(exprs.num_folding_challenges + 4)]
    y = [Fp(rng.randrange(spec.p), spec) for _ in range(num_vars)]
    state = ProverState(spec, num_vars, Fp(rng.randrange(spec.p), spec),
                        VirtualPolynomial(expr, polys, challenges, [y]))
    return state, EvaluationsProver(state)


def k3_cases(torch, num_vars, gen, device="cuda", bench=tuple(BENCH_TAPES)):
    """K3's arguments (state, instrs, consts, num_regs, out_reg, degree) with
    the field, keyed (field name, expression), at 2^(num_vars - 1) pairs: the
    four Fr expressions, the zero-checks of the BENCH_TAPES named in `bench`
    (the aggregation circuit and sha256 at the two k it runs at), the four
    folding deciders over Fr, and the vanilla and lookup ones and
    Protostar's vanilla decider over Fq; with them the vanilla prover state
    over Fr."""
    from plonkish_tpu_torch.fields import limb
    from plonkish_tpu_torch.fields.spec import BN254_FQ, BN254_FR
    from plonkish_tpu_torch.kernels import sumcheck_gen
    from plonkish_tpu_torch.piop.tape import compile_tape
    from plonkish_tpu_torch.utils import expression as ex

    def remapped(expr, tables):
        tape = compile_tape(expr, BN254_FR)
        return tape.remapped([("poly", i, 0) for i in range(tables)]), tape

    cases = {}
    for spec in (BN254_FR, BN254_FQ):
        for name, fn in (("vanilla", "vanilla_plonk_expression"),
                         ("lookup", "vanilla_plonk_with_lookup_expression")):
            state, prover = zero_check_state(torch, num_vars, gen, device, fn, spec)
            cases[(spec.name, name)] = (state.stacked, prover.instrs, prover.consts,
                                        prover.tape.num_regs, prover.tape.out_reg, state.degree,
                                        spec)
            if (spec, name) == (BN254_FR, "vanilla"):
                vanilla = (state, prover)
    cases.update(k3_bench_cases(torch, num_vars, gen, bench, device))
    for spec, deciders in ((BN254_FR, DECIDERS), (BN254_FQ, DECIDERS[:1])):
        for name, scheme, circuit in deciders:
            state, prover = decider_state(torch, num_vars, gen, device, scheme, circuit, spec)
            cases[(spec.name, name)] = (state.stacked, prover.instrs, prover.consts,
                                        prover.tape.num_regs, prover.tape.out_reg, state.degree,
                                        spec)
    fr = BN254_FR.name
    single = cases[(fr, "vanilla")][0][:1].contiguous()
    instrs, tape = remapped(ex.Polynomial(ex.Query(0, ex.Rotation(0))), 1)
    cases[(fr, "single_leaf")] = (single, instrs, tape.const_rows(BN254_FR, device),
                                  tape.num_regs, tape.out_reg, 1, BN254_FR)
    expr, n = sumcheck_gen.wide_expression()
    instrs, tape = remapped(expr, n)
    wide = limb.to_mont(BN254_FR, rand_field(torch, BN254_FR, n << num_vars, gen, device))
    cases[(fr, "wide")] = (wide.reshape(n, 1 << num_vars, 8).contiguous(), instrs,
                           tape.const_rows(BN254_FR, device), tape.num_regs, tape.out_reg,
                           expr.degree(), BN254_FR)
    return cases, vanilla


def k3_bench_cases(torch, num_vars, gen, names, device="cuda"):
    """The cases of k3_cases for the BENCH_TAPES in `names`."""
    from plonkish_tpu_torch.fields.spec import BN254_FR

    cases = {}
    for name in names:
        state, prover = zero_check_state(torch, num_vars, gen, device, name)
        cases[(BN254_FR.name, name)] = (state.stacked, prover.instrs, prover.consts,
                                        prover.tape.num_regs, prover.tape.out_reg, state.degree,
                                        BN254_FR)
        del state, prover
    return cases


def tape_of(case):
    """The generator's arguments (instrs, num_regs, out_reg, tables, degree,
    spec)."""
    stacked, instrs, _, num_regs, out_reg, degree, spec = case
    return instrs, num_regs, out_reg, stacked.shape[0], degree, spec


def selector_scalars(torch, spec, n, gen, device="cuda"):
    """n canonical scalars drawn from {0, 1, 2, p - 1}, like a selector
    column: a few buckets per window hold most entries."""
    from plonkish_tpu_torch.fields import limb

    table = limb.from_ints([0, 1, 2, spec.p - 1], device)
    return table[torch.randint(0, 4, (n,), generator=gen).to(device)].contiguous()


def msm_inputs(torch, n, gen, kind, curve=None):
    """(curve, bases, scalars) of n points on `curve` (BN254 G1 unless
    given): multiples of G by random scalars.  kind "edge": repeated points,
    opposite points, identities and zero scalars; "selector": selector-like
    scalars; "random": nothing more."""
    from plonkish_tpu_torch.curves import msm as tmsm
    from plonkish_tpu_torch.curves.host import AffinePoint
    from plonkish_tpu_torch.curves.specs import BN254_G1
    from plonkish_tpu_torch.fields import limb

    curve = curve or BN254_G1
    s = limb.to_mont(curve.scalar, rand_field(torch, curve.scalar, n, gen))
    bases = tmsm.fixed_base_msm(curve, AffinePoint.generator(curve), s)
    scalars = rand_field(torch, curve.scalar, n, gen)
    if kind == "selector":
        scalars = selector_scalars(torch, curve.scalar, n, gen)
    if kind == "edge":
        bases[1] = bases[0]  # a repeated point
        bases[2, 0] = bases[0, 0]  # the opposite point
        bases[2, 1] = limb.neg(curve.base, bases[0, 1][None])[0]
        bases[3:8] = 0  # identities
        scalars[1:3] = scalars[0]  # P + P + (-P) in the same buckets
        scalars[8:16] = 0  # zero scalars
        scalars[16:24] = scalars[24]  # one bucket per window takes 9 points
        scalars[40:48, 1:] = 0  # small scalars
    return curve, bases, scalars


def timed_once(torch, fn):
    """(ms of one call by CUDA events, its result): for plain versions that
    take seconds at full size."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end), out


def msm_without_sync(torch, curve, scalars, bases):
    """variable_base_msm's device part under set_sync_debug_mode("error"):
    fails if anything reads the device before the one result point."""
    from plonkish_tpu_torch.curves import msm as tmsm

    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        point = tmsm.msm_jacobian(curve, scalars, bases)
    except RuntimeError as e:
        fail(f"variable_base_msm synchronised before its result read: {e}")
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return point


# ------------------------------------------------------ 1 K3 builds

def phase1_round_kernels(torch):
    """K3 generated and built for every expression this script runs, one nvcc
    each, all started together (and beside the library's own builds); the
    LATE_TAPES are started once the others are built and go on building in
    a thread of their own.  The tapes come from small states on the CPU: a
    kernel depends on the tape's structure, not on the size or the
    constants' values.  Returns each tape's structure, keyed as k3_cases,
    and the late builds' (thread, cases, result)."""
    from plonkish_tpu_torch.kernels import sumcheck_gen

    cases, _ = k3_cases(torch, 4, torch.Generator().manual_seed(3), "cpu")
    structures = {key: sumcheck_gen.structure(*tape_of(case)) for key, case in cases.items()}
    early = {key: case for key, case in cases.items() if key[1] not in LATE_TAPES}
    log_round_builds(early, sumcheck_gen.prebuild([tape_of(case) for case in early.values()]))
    late = {key: case for key, case in cases.items() if key[1] in LATE_TAPES}
    result = {}

    def build_late():
        try:
            result["kernels"] = sumcheck_gen.prebuild([tape_of(case) for case in late.values()])
        except Exception as e:  # noqa: BLE001 - reported where the script waits for it
            result["error"] = e

    thread = threading.Thread(target=build_late, name="late K3 builds")
    thread.start()
    return structures, (thread, late, result)


def late_round_kernels(torch, late, structures):
    """Wait for the LATE_TAPES' builds, print them as phase 1 prints its own,
    and hold each against its plain version as phase 2 holds the others."""
    thread, cases, result = late
    t0 = time.time()
    thread.join()
    if "error" in result:
        fail(f"a K3 kernel of the sha256 tapes did not build: {result['error']}")
    log(f"[build] waited {time.time() - t0:.1f}s for the sha256 tapes")
    log_round_builds(cases, result["kernels"])
    gen = torch.Generator().manual_seed(4)
    check_round_kernels(torch, k3_bench_cases(torch, 17, gen, LATE_TAPES), structures)


def log_round_builds(cases, kernels):
    """Each K3 build's line; the vanilla and lookup kernels must keep every
    register in a register."""
    from plonkish_tpu_torch.piop.tape import OP_MUL

    for (field, name), kern in zip(cases, kernels):
        instrs, num_regs, _, tables, degree, _ = tape_of(cases[(field, name)])
        log(f"[build] K3 {name} over {field}: {len(instrs)} instructions, "
            f"{int((instrs[:, 0] == OP_MUL).sum())} products, {num_regs} tape registers, "
            f"{tables} tables, degree {degree}: built in {kern.build_seconds:.1f}s; "
            f"{kern.warps} warps a block, {kern.resident} blocks resident; {kern.ptxas}")
        frame = re.search(r"sc_round_kernel: (\d+) bytes stack frame, (\d+) bytes spill stores, "
                          r"(\d+) bytes spill loads", kern.ptxas)
        if (name in ("vanilla", "lookup")
                and (frame is None or frame.groups() != ("0", "0", "0") or kern.stack)):
            fail(f"K3 {name} over {field}: ptxas reports a stack frame or spills: {kern.ptxas}")


def check_round_kernels(torch, cases, structures):
    """K3 against its plain version for each case of k3_cases, at all its
    pairs and at one pair; each tape must be the one phase 1 built for the
    same expression's small state on the CPU."""
    from plonkish_tpu_torch.fields.host import Fp
    from plonkish_tpu_torch.kernels import sumcheck as ksc
    from plonkish_tpu_torch.kernels import sumcheck_gen
    from plonkish_tpu_torch.piop.sum_check import identity_params

    for (field, name), case in cases.items():
        if sumcheck_gen.structure(*tape_of(case)) != structures[(field, name)]:
            fail(f"K3: the {name} state on the card over {field} needs another kernel than the "
                 "same expression's small state on the CPU")
        stacked, instrs, consts, num_regs, out_reg, degree, spec = case
        ids = identity_params(spec, 0, Fp.zero(spec), "cuda")  # round 0's offset is zero
        for part in (stacked, stacked[:, :2].contiguous()):
            args = (part, instrs, consts, num_regs, out_reg, degree, ids)
            if not torch.equal(ksc.sumcheck_round_cuda(spec, *args),
                               ksc.sumcheck_round_plain(spec, *args)):
                fail(f"K3 sumcheck_round differs from its plain version ({name} expression "
                     f"over {field}, {part.shape[1] // 2} pairs)")
        log(f"[kernels] K3 round, {name} expression over {field}, {stacked.shape[0]} tables, "
            f"degree {degree}, {len(instrs)} instructions: 0 mismatches at "
            f"{stacked.shape[1] // 2} pairs and at 1 pair")


# ------------------------------------------------------ 2 kernels vs plain

def phase2_kernels(torch, structures):
    from plonkish_tpu_torch.curves import device as cdev
    from plonkish_tpu_torch.curves import msm as tmsm
    from plonkish_tpu_torch.curves.specs import BN254_G1, GRUMPKIN_G1
    from plonkish_tpu_torch.fields import limb
    from plonkish_tpu_torch.fields.spec import BN254_FQ, BN254_FR
    from plonkish_tpu_torch.kernels import ipa as kipa
    from plonkish_tpu_torch.kernels import msm as kmsm
    from plonkish_tpu_torch.kernels import probe as kprobe
    from plonkish_tpu_torch.kernels import sumcheck as ksc

    gen = torch.Generator().manual_seed(1)
    for n, kind, msm_curve in ((1 << 12, "edge", BN254_G1), (1 << 16, "random", BN254_G1),
                               (1 << 16, "selector", BN254_G1), (1 << 12, "edge", GRUMPKIN_G1),
                               (1 << 16, "random", GRUMPKIN_G1)):
        t0 = time.time()
        curve, bases, scalars = msm_inputs(torch, n, gen, kind, msm_curve)
        c = tmsm.window_size(n)
        w = tmsm.num_windows(curve, c)
        keys, src, nb = tmsm.msm_entries(scalars, c, w)
        k1 = kmsm.msm_bucket_sums_cuda(curve, bases, keys, src, w * nb)
        k1_plain = kmsm.msm_bucket_sums_plain(curve, bases, keys, src, w * nb)
        if not affine_equal(torch, curve, k1, k1_plain):
            fail(f"K1 msm_bucket_sums differs from its plain version on {curve.name} at n={n} "
                 f"({kind})")
        buckets = k1.reshape(w, nb, 3, 8)
        k2 = kmsm.msm_window_sums_cuda(curve, buckets, c)
        k2_plain = kmsm.msm_window_sums_plain(curve, buckets, c)
        if not affine_equal(torch, curve, k2[None], k2_plain[None]):
            fail(f"K2 msm_window_sums differs from its plain version on {curve.name} at n={n} "
                 f"({kind})")
        want = cdev.jac_to_host(curve, k2_plain[None].cpu())[0]
        if tmsm.variable_base_msm(curve, scalars, bases) != want:
            fail(f"variable_base_msm differs from the plain K1 + K2 on {curve.name} at n={n} "
                 f"({kind})")
        note = ""
        if kind == "selector":
            point = msm_without_sync(torch, curve, scalars, bases)
            if cdev.jac_to_host(curve, point[None].cpu())[0] != want:
                fail(f"variable_base_msm under the sync check differs at n={n}")
            note = "; enqueued with no synchronisation before its one-point read"
        log(f"[kernels] K1+K2 MSM {curve.name} n={n} {kind}: {w * nb} buckets, "
            f"{keys.numel()} entries, "
            f"{len(kmsm.bucket_level_sizes(keys.numel()))} K1 levels, 0 mismatches{note} "
            f"({time.time() - t0:.1f}s)")

    cases, (state, _) = k3_cases(torch, 17, gen,
                                 bench=[n for n in BENCH_TAPES if n not in LATE_TAPES])
    check_round_kernels(torch, cases, structures)
    for spec, stacked in ((BN254_FR, state.stacked),
                          (BN254_FQ, cases[(BN254_FQ.name, "vanilla")][0])):
        ch = limb.const(spec, 0x1234567890ABCDEF, "cuda")
        if not torch.equal(ksc.fold_cuda(spec, stacked, ch), ksc.fold_plain(spec, stacked, ch)):
            fail(f"K4 sumcheck_fold differs from its plain version over {spec.name}")
        log(f"[kernels] K4 fold over {spec.name}, {stacked.shape[0]} tables x {stacked.shape[1]} "
            "rows: 0 mismatches")

    # the IPA base fold: identities among L and R, xi at its edges
    t0 = time.time()
    gc = GRUMPKIN_G1
    _, pts, _ = msm_inputs(torch, 1 << 13, gen, "random", gc)
    pts[5:9] = 0
    pts[(1 << 12) + 7: (1 << 12) + 11] = 0
    left, right = pts[: 1 << 12].contiguous(), pts[1 << 12:].contiguous()
    right[20] = left[20]  # L + R with L = R
    xis = (0, 1, gc.scalar.p - 1, random.Random(5).randrange(gc.scalar.p))
    for xi in xis:
        if not torch.equal(kipa.base_fold_cuda(gc, left, right, xi),
                           kipa.base_fold_plain(gc, left, right, xi)):
            fail(f"the IPA base fold differs from its plain version for xi of "
                 f"{xi.bit_length()} bits")
    log(f"[kernels] IPA base fold, {left.shape[0]} points with identities, xi in 0, 1, q - 1 "
        f"and at random: 0 mismatches ({time.time() - t0:.1f}s)")

    a, b = probe_inputs(torch, BN254_FR, 1 << 16, gen)
    want = kprobe.mont_mul_chain_plain(BN254_FR, a, b, 16, "u32")
    if not torch.equal(want, kprobe.mont_mul_chain_plain(BN254_FR, a, b, 16, "f32")):
        fail("K5: the two plain multipliers disagree")
    got = {v: kprobe.mont_mul_chain_cuda(BN254_FR, a, b, 16, v) for v in kprobe.VARIANTS}
    torch.cuda.synchronize()
    if not torch.equal(got["u32"], got["f32"]):
        fail("K5 mont_mul_chain: variant u32 differs from variant f32")
    for v in kprobe.VARIANTS:
        if not torch.equal(got[v], want):
            fail(f"K5 mont_mul_chain variant {v} differs from its plain version")
    log(f"[kernels] K5 mont_mul chain, {a.shape[0]} elements with edge rows, 16 deep, "
        "u32 and f32: 0 mismatches")


# ------------------------------------------------------ 3 golden proofs

def phase3_golden(torch, here):
    from plonkish_tpu_torch.backend.hyperplonk import HyperPlonk
    from plonkish_tpu_torch.fields.spec import BN254_FR
    from plonkish_tpu_torch.models.circuits import (
        rand_vanilla_plonk_circuit, rand_vanilla_plonk_with_lookup_circuit,
    )
    from plonkish_tpu_torch.pcs.brakedown import MultilinearBrakedown
    from plonkish_tpu_torch.pcs.brakedown_code import BRAKEDOWN_SPEC_TEST
    from plonkish_tpu_torch.pcs.gemini import Gemini
    from plonkish_tpu_torch.pcs.hyrax import MultilinearHyrax
    from plonkish_tpu_torch.pcs.ipa import MultilinearIpa
    from plonkish_tpu_torch.pcs.kzg import MultilinearKzg
    from plonkish_tpu_torch.pcs.zeromorph import Zeromorph
    from plonkish_tpu_torch.utils.transcript import Keccak256Transcript

    brakedown = lambda: MultilinearBrakedown(BN254_FR, BRAKEDOWN_SPEC_TEST)  # noqa: E731
    for name, k, fn, make_pcs in (
        ("hyperplonk_kzg_k3", 3, rand_vanilla_plonk_circuit, MultilinearKzg),
        ("hyperplonk_kzg_k5", 5, rand_vanilla_plonk_circuit, MultilinearKzg),
        ("hyperplonk_kzg_lookup_k5", 5, rand_vanilla_plonk_with_lookup_circuit, MultilinearKzg),
        ("hyperplonk_gemini_k5", 5, rand_vanilla_plonk_circuit, Gemini),
        ("hyperplonk_zeromorph_k5", 5, rand_vanilla_plonk_circuit, Zeromorph),
        ("hyperplonk_ipa_k5", 5, rand_vanilla_plonk_circuit, MultilinearIpa),
        ("hyperplonk_hyrax_k5", 5, rand_vanilla_plonk_circuit, MultilinearHyrax),
        ("hyperplonk_brakedown_k3", 3, rand_vanilla_plonk_circuit, brakedown),
        ("hyperplonk_brakedown_k5", 5, rand_vanilla_plonk_circuit, brakedown),
    ):
        t0 = time.time()
        pcs = make_pcs()
        spec = pcs.field_spec
        ci, circuit = fn(spec, k, random.Random(1), random.Random(2))
        backend = HyperPlonk(pcs)
        param = backend.setup(ci, random.Random(0))
        pp, vp = backend.preprocess(param, ci)
        tr = Keccak256Transcript(spec)
        backend.prove(pp, circuit, tr)
        proof = tr.into_proof()
        with open(os.path.join(here, "tests", "golden", f"{name}.bin"), "rb") as fh:
            want = fh.read()
        if proof != want:
            fail(f"golden proof {name} differs on the card")
        backend.verify(vp, circuit.instances(), Keccak256Transcript.from_proof(spec, proof))
        log(f"[golden] {name}: {len(proof)} bytes equal, verified ({time.time() - t0:.1f}s)")

    # the Protostar decider after two folds (tests/test_golden_proofs.py)
    from plonkish_tpu_torch.accumulation.protostar import Protostar

    t0 = time.time()
    name = "protostar_kzg_decider_k3"
    circuits = [rand_vanilla_plonk_circuit(BN254_FR, 3, random.Random(42), random.Random(seed))
                for seed in (0, 100, 101, 102)]
    scheme = Protostar(MultilinearKzg())
    pp, vp = scheme.preprocess(scheme.setup(circuits[0][0], random.Random(0)), circuits[0][0])
    acc = scheme.init_accumulator(pp)
    for _, circuit in circuits[1:3]:
        scheme.prove_accumulation_from_nark(pp, acc, circuit, Keccak256Transcript(BN254_FR))
    before = acc.instance.clone()
    tr = Keccak256Transcript(BN254_FR)
    scheme.prove_decider_with_last_nark(pp, acc, circuits[3][1], tr)
    proof = tr.into_proof()
    with open(os.path.join(here, "tests", "golden", f"{name}.bin"), "rb") as fh:
        if proof != fh.read():
            fail(f"golden proof {name} differs on the card")
    scheme.verify_decider_with_last_nark(vp, before, circuits[3][1].instances(),
                                         Keccak256Transcript.from_proof(BN254_FR, proof))
    log(f"[golden] {name}: {len(proof)} bytes equal, verified ({time.time() - t0:.1f}s)")


# ------------------------------------------------------ 4 full size

def phase4_full(torch, k, launches, reset_launches):
    from plonkish_tpu_torch import benchmark
    from plonkish_tpu_torch.backend.hyperplonk import HyperPlonk
    from plonkish_tpu_torch.fields.spec import BN254_FR
    from plonkish_tpu_torch.models.circuits import rand_vanilla_plonk_circuit
    from plonkish_tpu_torch.pcs.kzg import MultilinearKzg

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
    t0 = time.time()
    srs_path = benchmark.srs_cache_path(k, 0)
    benchmark.save_srs(srs_path, param)  # phase 11's ranks read it back
    times["srs_write"] = time.time() - t0
    log(f"[k={k}] circuit {times['circuit']:.2f}s, setup {times['setup']:.2f}s, "
        f"preprocess {times['preprocess']:.2f}s, SRS written to {srs_path} in "
        f"{times['srs_write']:.2f}s")

    times["prove"], main_path, proof = prove_and_check(
        torch, f"k={k}", backend, pp, vp, circuit, BN254_FR, launches, reset_launches,
        must=PROVER_KERNELS)
    log(f"[k={k}] times {json.dumps({n: round(v, 4) for n, v in times.items()})}")
    return main_path, {"pp": pp, "vp": vp, "k": k, "circuit": (ci, circuit), "param": param,
                       "proof": proof, "prove_s": times["prove"], "srs_path": srs_path}


# ------------------------------------------------------ 5 kernel timing

def phase5_timing(torch, shapes, main_path):
    from plonkish_tpu_torch.curves import msm as tmsm
    from plonkish_tpu_torch.curves.specs import BN254_G1
    from plonkish_tpu_torch.fields.spec import BN254_FR
    from plonkish_tpu_torch import roofline
    from plonkish_tpu_torch.kernels import msm as kmsm
    from plonkish_tpu_torch.kernels import probe as kprobe
    from plonkish_tpu_torch.kernels import sumcheck as ksc
    from plonkish_tpu_torch.kernels import sumcheck_gen
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
    m = int((keys < w * nb).sum())  # live entries: the sentinel run sorts last
    live = keys[:m]
    unique = int((live[1:] != live[:-1]).sum()) + 1 if m else 0
    k1_ms = cuda_ms(torch, lambda: kmsm.msm_bucket_sums_cuda(curve, bases, keys, src, w * nb), 3)
    buckets = kmsm.msm_bucket_sums_cuda(curve, bases, keys, src, w * nb)
    # each plain version runs once, timed, and its result is the one compared
    k1_plain_ms, k1_plain = timed_once(
        torch, lambda: kmsm.msm_bucket_sums_plain(curve, bases, keys, src, w * nb))
    k1_err = 0 if affine_equal(torch, curve, buckets, k1_plain) else 1
    del k1_plain
    buckets = buckets.reshape(w, nb, 3, 8)
    k2_ms = cuda_ms(torch, lambda: kmsm.msm_window_sums_cuda(curve, buckets, c), 3)
    k2_plain_ms, k2_plain = timed_once(
        torch, lambda: kmsm.msm_window_sums_plain(curve, buckets, c))
    k2_err = 0 if affine_equal(torch, curve, kmsm.msm_window_sums_cuda(curve, buckets, c)[None],
                               k2_plain[None]) else 1
    log(f"[timing] MSM 2^{k}: c={c}, {w} windows, {keys.numel()} entries of which {m} "
        f"live, {unique} buckets used, K1 levels {kmsm.bucket_level_sizes(keys.numel())}")
    sel = selector_scalars(torch, curve.scalar, n, gen)
    sel_keys, sel_src, _ = tmsm.msm_entries(sel, c, w)
    k1_sel_ms = cuda_ms(
        torch, lambda: kmsm.msm_bucket_sums_cuda(curve, bases, sel_keys, sel_src, w * nb), 3)
    log(f"[timing] K1 on selector-like scalars at 2^{k}: {k1_sel_ms:.3f} ms "
        f"({int((sel_keys < w * nb).sum())} live entries; random scalars {k1_ms:.3f} ms)")
    msm_ms = cuda_ms(torch, lambda: tmsm.variable_base_msm(curve, scalars, bases), 3)
    log(f"[timing] variable_base_msm at 2^{k}: {msm_ms:.3f} ms (recode, sort, K1, K2, "
        "one-point read)")
    small = 10
    small_bases = shapes["pp"].pcs.eq(small)
    small_scalars = scalars[: 1 << small].contiguous()
    msm_small_ms = cuda_ms(
        torch, lambda: tmsm.variable_base_msm(curve, small_scalars, small_bases), 20)
    log(f"[timing] variable_base_msm at 2^{small}: {msm_small_ms:.3f} ms (the fixed cost "
        "of one MSM)")

    state, prover = zero_check_state(torch, k, gen)
    ids = identity_params(BN254_FR, 0, state.identity_offset, "cuda")
    args = (state.stacked, prover.instrs, prover.consts, prover.tape.num_regs,
            prover.tape.out_reg, state.degree, ids)
    k3_ms = cuda_ms(torch, lambda: ksc.sumcheck_round_cuda(BN254_FR, *args), 3)
    k3_plain_ms, k3_plain = timed_once(torch, lambda: ksc.sumcheck_round_plain(BN254_FR, *args))
    k3_err = 0 if torch.equal(ksc.sumcheck_round_cuda(BN254_FR, *args), k3_plain) else 1
    ch = limb.const(BN254_FR, 0x1234567890ABCDEF, "cuda")
    k4_ms = cuda_ms(torch, lambda: ksc.fold_cuda(BN254_FR, state.stacked, ch), 10)
    k4_plain_ms, k4_plain = timed_once(torch, lambda: ksc.fold_plain(BN254_FR, state.stacked, ch))
    k4_err = 0 if torch.equal(ksc.fold_cuda(BN254_FR, state.stacked, ch), k4_plain) else 1
    del k4_plain
    t_count, rows, _ = state.stacked.shape
    pairs = rows // 2
    n_mul = int((prover.instrs[:, 0] == OP_MUL).sum())
    log(f"[timing] round 0 state: {t_count} tables x 2^{k} rows, tape "
        f"{len(prover.instrs)} instructions ({n_mul} products), degree {state.degree}")
    kern = sumcheck_gen.kernel(*tape_of((*args[:6], BN254_FR)))
    log(f"[timing] K3 vanilla round 0: {k3_ms:.3f} ms; {kern.regs} registers, {kern.stack} "
        f"bytes of stack, {kern.warps} warps a block, {kern.resident} blocks resident")
    # K5: both multipliers over every launch shape at 2^22 elements, 16 deep.
    # The sweep is the one the harness runs once per process; it is taken
    # here outside that cache, so that phase 6 launches the probe itself.
    sweep = roofline.probe_sweep("cuda")
    peaks = roofline.peaks_from_sweep(sweep, "cuda")
    for variant, per_thread, threads, ms in sweep:
        log(f"[timing] mont_mul_chain {variant}, {per_thread} per thread, blocks of "
            f"{threads}: {ms:.3f} ms")
    pn, pchain = roofline.PROBE_N, roofline.PROBE_CHAIN
    pa, pb = probe_inputs(torch, BN254_FR, pn, gen)
    best = peaks["best"]["u32"]
    k5_out = kprobe.mont_mul_chain_cuda(BN254_FR, pa, pb, pchain, "u32",
                                        best["per_thread"], best["threads"])
    k5_f32 = kprobe.mont_mul_chain_cuda(BN254_FR, pa, pb, pchain, "f32")
    k5_plain_ms, k5_plain = timed_once(
        torch, lambda: kprobe.mont_mul_chain_plain(BN254_FR, pa, pb, pchain, "u32"))
    k5_err = 0 if torch.equal(k5_out, k5_plain) and torch.equal(k5_f32, k5_plain) else 1
    k5_ms, k5_f32_ms = best["ms"], peaks["best"]["f32"]["ms"]
    rate, source = roofline.imad_rate(peaks)
    log(f"[peaks] {peaks['card']}: fe_mul {peaks['fe_mul_per_s'] / 1e9:.3f} G/s "
        f"({best['per_thread']} per thread, blocks of {best['threads']}), fe_mul_f32 "
        f"{peaks['fe_mul_f32_per_s'] / 1e9:.3f} G/s; multiply-adds measured "
        f"{peaks['imad_per_s_measured'] / 1e12:.3f} T/s, assumed "
        f"{peaks['imad_per_s_assumed'] / 1e12:.3f} T/s; bounds use the {source} rate "
        f"({rate / 1e12:.3f} T/s) and {peaks['hbm_bytes_per_s'] / 1e12:.2f} TB/s; "
        "K5's own bound uses the assumed rate; K5 is a compute rate (about 8x over "
        "its byte bound)")

    lookup_state, lookup_prover = zero_check_state(
        torch, k, gen, name="vanilla_plonk_with_lookup_expression")
    lookup_args = (lookup_state.stacked, lookup_prover.instrs, lookup_prover.consts,
                   lookup_prover.tape.num_regs, lookup_prover.tape.out_reg,
                   lookup_state.degree, ids)
    lookup_ms = cuda_ms(torch, lambda: ksc.sumcheck_round_cuda(BN254_FR, *lookup_args), 3)
    lookup_kern = sumcheck_gen.kernel(*tape_of((*lookup_args[:6], BN254_FR)))
    lookup_muls = int((lookup_prover.instrs[:, 0] == OP_MUL).sum())
    log(f"[timing] K3 lookup round 0 at 2^{k}: {lookup_ms:.3f} ms ({lookup_state.stacked.shape[0]} "
        f"tables, {lookup_muls} products; {lookup_kern.warps} warps a block, "
        f"{lookup_kern.resident} blocks resident; bound "
        f"{roofline.bound_ms(*roofline.round_work(lookup_state.stacked.shape[0], pairs, lookup_state.degree, lookup_muls), peaks)[0]:.3f} ms)")
    del lookup_state, lookup_prover, lookup_args

    # K3 over every round of the k = 20 zero-check, K4 between rounds
    per_round, round_bounds = [], []
    stacked = state.stacked
    for r in range(k):
        ids_r = identity_params(BN254_FR, r, state.identity_offset, "cuda")
        args_r = (stacked, *args[1:6], ids_r)
        per_round.append(cuda_ms(torch, lambda: ksc.sumcheck_round_cuda(BN254_FR, *args_r), 3))
        round_bounds.append(roofline.bound_ms(
            *roofline.round_work(t_count, stacked.shape[1] // 2, state.degree, n_mul), peaks)[0])
        if stacked.shape[1] // 2 <= 1 << 12 and not torch.equal(
                ksc.sumcheck_round_cuda(BN254_FR, *args_r), ksc.sumcheck_round_plain(BN254_FR, *args_r)):
            fail(f"K3 differs from its plain version at round {r} of the k={k} zero-check")
        stacked = ksc.fold_cuda(BN254_FR, stacked, ch)
    log(f"[timing] K3 summed over the {k} rounds of the k={k} zero-check: {sum(per_round):.3f} ms "
        f"(bound {sum(round_bounds):.3f} ms); round 0 {per_round[0]:.3f} ms (bound "
        f"{round_bounds[0]:.3f} ms); per round {[round(v, 4) for v in per_round]}")

    new_rows = timing_new_instantiations(torch, k, gen, peaks)

    rows_out = []
    for name, source_file, replaces, ms, plain_ms, err, work in (
        ("msm_bucket_sums", "plonkish_tpu_torch/csrc/msm.cu",
         "plonkish_tpu/pallas/msm.py:46", k1_ms, k1_plain_ms, k1_err,
         roofline.bucket_sums_work(n, m, unique)),
        ("msm_window_sums", "plonkish_tpu_torch/csrc/msm.cu",
         "plonkish_tpu/pallas/msm.py:119", k2_ms, k2_plain_ms, k2_err,
         roofline.window_sums_work(w, nb, c)),
        ("sumcheck_round", "plonkish_tpu_torch/csrc/sumcheck.cuh",
         "plonkish_tpu/pallas/sumcheck.py:159", k3_ms, k3_plain_ms, k3_err,
         roofline.round_work(t_count, pairs, state.degree, n_mul)),
        ("sumcheck_fold", "plonkish_tpu_torch/csrc/sumcheck.cu",
         "plonkish_tpu/pallas/sumcheck.py:225", k4_ms, k4_plain_ms, k4_err,
         roofline.fold_work(t_count, pairs)),
        ("mont_mul_chain", "plonkish_tpu_torch/csrc/probe.cu",
         "scripts/validate_pallas_tpu.py:253", k5_ms, k5_plain_ms, k5_err,
         roofline.chain_work(pn, pchain)),
    ):
        if err:
            fail(f"{name} differs from its plain version at the k={k} shapes")
        # the probe cannot be its own bound: K5 is held to the assumed rate
        own = name == "mont_mul_chain"
        b_ms, b_by, b_src = roofline.bound_ms(*work, None if own else peaks)
        rows_out.append({
            "name": name, "route": "cuda", "source": source_file, "replaces": replaces,
            "launches": main_path[name], "max_abs_err": 0, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None, "path": "kzg", "counter": name,
        })
        extra = f", f32 variant {k5_f32_ms:.3f} ms" if own else ""
        log(f"[timing] {name}: {ms:.3f} ms{extra} (plain {plain_ms:.1f} ms, bound "
            f"{b_ms:.3f} ms by {b_by} at the {b_src} rate), {main_path[name]} launches "
            "in the prove")
    return rows_out + new_rows


def timing_new_instantiations(torch, k, gen, peaks):
    """K1 and K2 on Grumpkin at 2^k points of the IPA basis, K3 and K4 over
    Fq at the k-variable zero-check's shapes, and the IPA base fold at
    2^(k-1) points: each against its plain version, with its bound.  Rows of
    the kernels line; their launches are read on the IPA path (phase 7)."""
    from plonkish_tpu_torch import roofline
    from plonkish_tpu_torch.curves import msm as tmsm
    from plonkish_tpu_torch.curves.specs import GRUMPKIN_G1
    from plonkish_tpu_torch.fields import limb
    from plonkish_tpu_torch.fields.spec import BN254_FQ
    from plonkish_tpu_torch.kernels import ipa as kipa
    from plonkish_tpu_torch.kernels import msm as kmsm
    from plonkish_tpu_torch.kernels import sumcheck as ksc
    from plonkish_tpu_torch.pcs.ipa import MultilinearIpa
    from plonkish_tpu_torch.piop.sum_check import identity_params
    from plonkish_tpu_torch.piop.tape import OP_MUL

    curve = GRUMPKIN_G1
    n = 1 << k
    t0 = time.time()
    bases = MultilinearIpa().setup(n, 0).g  # the setup of phase 7, kept by the process
    torch.cuda.synchronize()
    log(f"[timing] IPA setup: {n} points hashed to Grumpkin in {time.time() - t0:.1f}s")
    scalars = rand_field(torch, curve.scalar, n, gen)
    c = tmsm.window_size(n)
    w = tmsm.num_windows(curve, c)
    keys, src, nb = tmsm.msm_entries(scalars, c, w)
    m = int((keys < w * nb).sum())
    live = keys[:m]
    unique = int((live[1:] != live[:-1]).sum()) + 1 if m else 0
    k1_ms = cuda_ms(torch, lambda: kmsm.msm_bucket_sums_cuda(curve, bases, keys, src, w * nb), 3)
    buckets = kmsm.msm_bucket_sums_cuda(curve, bases, keys, src, w * nb)
    k1_plain_ms, k1_plain = timed_once(
        torch, lambda: kmsm.msm_bucket_sums_plain(curve, bases, keys, src, w * nb))
    k1_err = 0 if affine_equal(torch, curve, buckets, k1_plain) else 1
    buckets = buckets.reshape(w, nb, 3, 8)
    k2_ms = cuda_ms(torch, lambda: kmsm.msm_window_sums_cuda(curve, buckets, c), 3)
    k2_plain_ms, k2_plain = timed_once(
        torch, lambda: kmsm.msm_window_sums_plain(curve, buckets, c))
    k2_err = 0 if affine_equal(torch, curve, kmsm.msm_window_sums_cuda(curve, buckets, c)[None],
                               k2_plain[None]) else 1

    spec = BN254_FQ
    state, prover = zero_check_state(torch, k, gen, spec=spec)
    ids = identity_params(spec, 0, state.identity_offset, "cuda")
    args = (state.stacked, prover.instrs, prover.consts, prover.tape.num_regs,
            prover.tape.out_reg, state.degree, ids)
    k3_ms = cuda_ms(torch, lambda: ksc.sumcheck_round_cuda(spec, *args), 3)
    k3_plain_ms, k3_plain = timed_once(torch, lambda: ksc.sumcheck_round_plain(spec, *args))
    k3_err = 0 if torch.equal(ksc.sumcheck_round_cuda(spec, *args), k3_plain) else 1
    ch = limb.const(spec, 0x1234567890ABCDEF, "cuda")
    k4_ms = cuda_ms(torch, lambda: ksc.fold_cuda(spec, state.stacked, ch), 10)
    k4_plain_ms, k4_plain = timed_once(torch, lambda: ksc.fold_plain(spec, state.stacked, ch))
    k4_err = 0 if torch.equal(ksc.fold_cuda(spec, state.stacked, ch), k4_plain) else 1
    t_count, rows, _ = state.stacked.shape
    degree = state.degree
    n_mul = int((prover.instrs[:, 0] == OP_MUL).sum())
    del state, prover, args

    half = n // 2
    left, right = bases[:half], bases[half:]
    xi = random.Random(6).randrange(curve.scalar.p)
    fold_ms = cuda_ms(torch, lambda: kipa.base_fold_cuda(curve, left, right, xi), 3)
    fold_plain_ms, fold_plain = timed_once(
        torch, lambda: kipa.base_fold_plain(curve, left, right, xi))
    fold_err = 0 if torch.equal(kipa.base_fold_cuda(curve, left, right, xi), fold_plain) else 1
    del fold_plain

    rows_out = []
    for name, counter, source_file, replaces, ms, plain_ms, err, work in (
        ("msm_bucket_sums_grumpkin", "msm_bucket_sums", "plonkish_tpu_torch/csrc/msm.cu",
         "plonkish_tpu/pallas/msm.py:46", k1_ms, k1_plain_ms, k1_err,
         roofline.bucket_sums_work(n, m, unique)),
        ("msm_window_sums_grumpkin", "msm_window_sums", "plonkish_tpu_torch/csrc/msm.cu",
         "plonkish_tpu/pallas/msm.py:119", k2_ms, k2_plain_ms, k2_err,
         roofline.window_sums_work(w, nb, c)),
        ("sumcheck_round_fq", "sumcheck_round", "plonkish_tpu_torch/csrc/sumcheck.cuh",
         "plonkish_tpu/pallas/sumcheck.py:159", k3_ms, k3_plain_ms, k3_err,
         roofline.round_work(t_count, rows // 2, degree, n_mul)),
        ("sumcheck_fold_fq", "sumcheck_fold", "plonkish_tpu_torch/csrc/sumcheck.cu",
         "plonkish_tpu/pallas/sumcheck.py:225", k4_ms, k4_plain_ms, k4_err,
         roofline.fold_work(t_count, rows // 2)),
        ("ipa_base_fold", "ipa_base_fold", "plonkish_tpu_torch/csrc/ipa.cu",
         "plonkish_tpu/pcs/ipa.py:157", fold_ms, fold_plain_ms, fold_err,
         roofline.base_fold_work(curve, half, xi)),
    ):
        if err:
            fail(f"{name} differs from its plain version at the k={k} shapes")
        b_ms, b_by, b_src = roofline.bound_ms(*work, peaks)
        rows_out.append({
            "name": name, "route": "cuda", "source": source_file, "replaces": replaces,
            "launches": 0, "max_abs_err": 0, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "path": "ipa", "counter": counter,
        })
        log(f"[timing] {name}: {ms:.3f} ms (plain {plain_ms:.1f} ms, bound {b_ms:.3f} ms by "
            f"{b_by} at the {b_src} rate)")
    return rows_out


# ------------------------------------------------------ 6 bench harness

def phase6_harness(k, launches, reset_launches):
    """The harness path in process: the zero_check system at
    K_ZERO_CHECK_ROW and the pcs system at k, one timed sample each after the
    harness's own warm-up."""
    from plonkish_tpu_torch import benchmark

    runs = (
        ("zero_check", ["--system", "zero_check"], 2, K_ZERO_CHECK_ROW),
        ("pcs_kzg", ["--system", "pcs", "--pcs", "kzg"], 3, k),
    )
    sizes = {}
    for name, _, _, _ in runs:
        path = os.path.join(benchmark.BENCH_DIR, name)
        sizes[name] = os.path.getsize(path) if os.path.exists(path) else 0
    reset_launches()
    for name, argv, _, kk in runs:
        t0 = time.time()
        benchmark.main([*argv, "--k", f"{kk}..{kk + 1}", "--samples", "1"])
        log(f"[harness] {name} k={kk}: {time.time() - t0:.1f}s")
    harness_path = dict(launches)
    log(f"[harness] kernel launches on the harness path: {json.dumps(harness_path)}")
    for name, _, columns, kk in runs:
        with open(os.path.join(benchmark.BENCH_DIR, name)) as fh:
            fh.seek(sizes[name])
            added = fh.read().splitlines()
        if any(line.startswith("# FAILED") for line in added):
            fail(f"the harness wrote a FAILED row to {name}: {added}")
        rows = [line.split(",") for line in added if not line.startswith("#")]
        if len(rows) != 1 or len(rows[0]) != columns or int(rows[0][0]) != kk:
            fail(f"the harness row of {name} at k={kk} is missing: {added}")
        if not all(float(v) > 0 for v in rows[0][1:]):
            fail(f"the harness row of {name} holds no time: {added}")
        log(f"[harness] {name} row: {','.join(rows[0])} ms")
    for name in PROVER_KERNELS + ("mont_mul_chain",):
        if harness_path[name] <= 0:
            fail(f"kernel {name} was not launched on the harness path")
    return harness_path


# ------------------------------------------------------ 7 IPA at full size

def phase7_ipa(torch, k, launches, reset_launches):
    """HyperPlonk over BN254 Fq with the multilinear IPA on Grumpkin at k:
    the path of the Grumpkin K1 and K2, K3 and K4 over Fq and the IPA base
    fold."""
    from plonkish_tpu_torch.backend.hyperplonk import HyperPlonk
    from plonkish_tpu_torch.fields.spec import BN254_FQ
    from plonkish_tpu_torch.models.circuits import rand_vanilla_plonk_circuit
    from plonkish_tpu_torch.pcs.ipa import MultilinearIpa

    spec = BN254_FQ
    times = {}
    t0 = time.time()
    ci, circuit = rand_vanilla_plonk_circuit(spec, k, random.Random(1), random.Random(2))
    times["circuit"] = time.time() - t0
    backend = HyperPlonk(MultilinearIpa())
    torch.cuda.synchronize()
    t0 = time.time()
    param = backend.setup(ci, random.Random(0))
    torch.cuda.synchronize()
    times["setup"] = time.time() - t0
    t0 = time.time()
    pp, vp = backend.preprocess(param, ci)
    torch.cuda.synchronize()
    times["preprocess"] = time.time() - t0
    log(f"[ipa k={k}] circuit {times['circuit']:.2f}s, setup {times['setup']:.2f}s (the "
        f"basis kept from phase 5), preprocess {times['preprocess']:.2f}s")

    times["prove"], ipa_path, _ = prove_and_check(
        torch, f"ipa k={k}", backend, pp, vp, circuit, spec, launches, reset_launches,
        must=IPA_KERNELS)
    log(f"[ipa k={k}] times {json.dumps({n: round(v, 4) for n, v in times.items()})}")
    return ipa_path


def phase7_harness(k, launches, reset_launches):
    """The harness's pcs system at k for the five PCS besides KZG, in
    process, one timed sample each after the harness's own warm-up."""
    for pcs in NEW_PCS:
        harness_row(["--system", "pcs", "--pcs", pcs], f"pcs_{pcs}", k, 3, launches,
                    reset_launches)


# ------------------------------------------------------ 8 folding at full size

def phase8_folding(torch, k, launches, reset_launches, shapes):
    """Protostar with multilinear KZG at k on phase 4's circuit structure: two
    timed folds and the decider with the last NARK, then the harness's
    sangria system at K_SANGRIA_ROW."""
    from plonkish_tpu_torch import benchmark
    from plonkish_tpu_torch.accumulation.protostar import Protostar
    from plonkish_tpu_torch.fields.spec import BN254_FR
    from plonkish_tpu_torch.kernels import sumcheck_gen
    from plonkish_tpu_torch.models.circuits import rand_vanilla_plonk_circuit
    from plonkish_tpu_torch.pcs.kzg import MultilinearKzg
    from plonkish_tpu_torch.utils import timer
    from plonkish_tpu_torch.utils.transcript import Keccak256Transcript

    spec = BN254_FR
    times = {}
    ci, first = shapes["circuit"]
    t0 = time.time()
    # the same structure (preprocess seed 1) with another witness; the last
    # NARK is phase 4's circuit again (a synthesis at k = 20 takes 30 s)
    other = rand_vanilla_plonk_circuit(spec, k, random.Random(1), random.Random(101))[1]
    circuits = [first, other, first]
    times["circuits"] = time.time() - t0
    scheme = Protostar(MultilinearKzg())
    torch.cuda.synchronize()
    t0 = time.time()
    param = scheme.setup(ci, random.Random(0))
    torch.cuda.synchronize()
    times["setup"] = time.time() - t0
    t0 = time.time()
    pp, vp = scheme.preprocess(param, ci)
    acc = scheme.init_accumulator(pp)
    torch.cuda.synchronize()
    times["preprocess"] = time.time() - t0
    log(f"[fold k={k}] one more circuit {times['circuits']:.2f}s, setup {times['setup']:.2f}s, "
        f"preprocess {times['preprocess']:.2f}s")

    kernels_before = len(sumcheck_gen.BUILDS)
    timer.set_sync(torch.cuda.synchronize)
    timer.set_enabled(True)
    timer.reset_trace()
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    fold_ms = []
    for circuit in circuits[:2]:
        torch.cuda.synchronize()
        t0 = time.time()
        scheme.prove_accumulation_from_nark(pp, acc, circuit, Keccak256Transcript(spec))
        torch.cuda.synchronize()
        fold_ms.append((time.time() - t0) * 1e3)
    before = acc.instance.clone()
    tr = Keccak256Transcript(spec)
    t0 = time.time()
    scheme.prove_decider_with_last_nark(pp, acc, circuits[2], tr)
    torch.cuda.synchronize()
    decider_ms = (time.time() - t0) * 1e3
    fold_path = dict(launches)
    timer.set_enabled(False)
    peak = torch.cuda.max_memory_allocated()
    proof = tr.into_proof()
    built = len(sumcheck_gen.BUILDS) - kernels_before
    log(f"[fold k={k}] folds {[round(v, 3) for v in fold_ms]} ms; decider with the last NARK "
        f"{decider_ms:.3f} ms, {len(proof)} bytes; peak device memory {peak / 2**30:.2f} GiB")
    spans = [(n, d, s) for n, d, s in timer.trace() if d <= 1]
    for name, depth, sec in spans:
        log(f"[fold k={k}] span {'  ' * depth}{name}: {sec * 1e3:.1f} ms")
    top = sum(s for _, d, s in spans if d == 0)
    log(f"[fold k={k}] outside top-level spans: {sum(fold_ms) + decider_ms - top * 1e3:.1f} ms")
    log(f"[fold k={k}] kernel launches in the timed folds and decider: {json.dumps(fold_path)}; "
        f"K3 kernels built or loaded in them: {built}")
    if built:
        fail("the timed folds or decider built a K3 kernel: phase 1 missed its tape")
    for name in PROVER_KERNELS:
        if fold_path[name] <= 0:
            fail(f"kernel {name} was not launched in the k={k} folds and decider")

    t0 = time.time()
    scheme.verify_decider_with_last_nark(vp, before.clone(), circuits[2].instances(),
                                         Keccak256Transcript.from_proof(spec, proof))
    verify_s = time.time() - t0
    bad = bytearray(proof)
    bad[len(bad) // 2] ^= 1
    try:
        scheme.verify_decider_with_last_nark(vp, before.clone(), circuits[2].instances(),
                                             Keccak256Transcript.from_proof(spec, bytes(bad)))
    except (ValueError, EOFError):
        pass
    else:
        fail("a decider proof with a flipped byte was accepted")
    log(f"[fold k={k}] decider verified in {verify_s:.2f}s; flipped byte rejected")
    del scheme, pp, vp, acc, param, circuits, first, other, ci
    torch.cuda.empty_cache()

    # the harness's sangria system, in process
    name = "sangria"
    path = os.path.join(benchmark.BENCH_DIR, name)
    size = os.path.getsize(path) if os.path.exists(path) else 0
    kernels_before = len(sumcheck_gen.BUILDS)
    reset_launches()
    t0 = time.time()
    k = K_SANGRIA_ROW
    benchmark.main(["--system", name, "--k", f"{k}..{k + 1}", "--samples", "1"])
    built = len(sumcheck_gen.BUILDS) - kernels_before
    log(f"[harness] {name} k={k}: {time.time() - t0:.1f}s; kernel launches "
        f"{json.dumps(dict(launches))}; K3 kernels built or loaded: {built}")
    if built:
        fail("the harness's sangria decider built a K3 kernel: phase 1 missed its tape")
    with open(path) as fh:
        fh.seek(size)
        added = fh.read().splitlines()
    if any(line.startswith("# FAILED") for line in added):
        fail(f"the harness wrote a FAILED row to {name}: {added}")
    rows = [line.split(",") for line in added if not line.startswith("#")]
    decider = [line for line in added if line.startswith(f"# decider k={k}: ")]
    if len(rows) != 1 or len(rows[0]) != 2 or int(rows[0][0]) != k or float(rows[0][1]) <= 0:
        fail(f"the harness's fold row of {name} at k={k} is missing: {added}")
    if len(decider) != 1:
        fail(f"the harness's decider row of {name} at k={k} is missing: {added}")
    log(f"[harness] {name} rows: fold {','.join(rows[0])} ms; {decider[0][2:]}")


# ------------------------------------------------------ shared by 9 and 10

def prove_and_check(torch, tag, backend, pp, vp, circuit, spec, launches, reset_launches,
                    must, must_not=(), mesh=None):
    """A warm-up prove, then a timed prove with its spans, peak device memory
    and kernel launches (each of `must` launched, none of `must_not`, no K3
    built or loaded in the timed prove), and, under `mesh`, the collectives
    of the timed prove; the verifier accepting and a flipped byte rejected.
    Returns (prove seconds, launches, proof)."""
    from plonkish_tpu_torch.kernels import sumcheck_gen
    from plonkish_tpu_torch.utils import timer
    from plonkish_tpu_torch.utils.transcript import Keccak256Transcript

    t0 = time.time()
    kernels_before = len(sumcheck_gen.BUILDS)
    backend.prove(pp, circuit, Keccak256Transcript(spec))
    torch.cuda.synchronize()
    kernels_warm = len(sumcheck_gen.BUILDS)
    log(f"[{tag}] warm-up prove {time.time() - t0:.2f}s; K3 kernels loaded in this process "
        f"{kernels_before} before it, {kernels_warm} after it")

    timer.set_sync(torch.cuda.synchronize)
    timer.set_enabled(True)
    timer.reset_trace()
    reset_launches()
    if mesh is not None:
        mesh.reset_stats()
    torch.cuda.reset_peak_memory_stats()
    tr = Keccak256Transcript(spec)
    torch.cuda.synchronize()
    t0 = time.time()
    backend.prove(pp, circuit, tr)
    torch.cuda.synchronize()
    prove_s = time.time() - t0
    path = dict(launches)
    if mesh is not None:
        log(f"[{tag}] rank {mesh.rank} of {mesh.world} over {mesh.backend}: {mesh.collectives} "
            f"collectives, {mesh.bytes} bytes put in, sharded sites {json.dumps(dict(mesh.taken))}")
    timer.set_enabled(False)
    peak = torch.cuda.max_memory_allocated()
    proof = tr.into_proof()
    log(f"[{tag}] prove {prove_s:.3f}s, {len(proof)} bytes, peak device memory "
        f"{peak / 2**30:.2f} GiB")
    spans = [(n, d, sec) for n, d, sec in timer.trace() if d <= 2]
    for name, depth, sec in spans:
        log(f"[{tag}] span {'  ' * depth}{name}: {sec * 1e3:.1f} ms")
    top = sum(sec for _, d, sec in spans if d == 0)
    log(f"[{tag}] outside top-level spans: {(prove_s - top) * 1e3:.1f} ms")
    log(f"[{tag}] kernel launches in the timed prove: {json.dumps(path)}; K3 kernels built or "
        f"loaded in it: {len(sumcheck_gen.BUILDS) - kernels_warm}")
    if len(sumcheck_gen.BUILDS) != kernels_warm:
        fail(f"[{tag}] the timed prove built a K3 kernel")
    for name in must:
        if path[name] <= 0:
            fail(f"[{tag}] kernel {name} was not launched in the timed prove")
    for name in must_not:
        if path[name] != 0:
            fail(f"[{tag}] kernel {name} was launched where the path has none")

    t0 = time.time()
    backend.verify(vp, circuit.instances(), Keccak256Transcript.from_proof(spec, proof))
    verify_s = time.time() - t0
    bad = bytearray(proof)
    bad[len(bad) // 2] ^= 1
    try:
        backend.verify(vp, circuit.instances(), Keccak256Transcript.from_proof(spec, bytes(bad)))
    except (ValueError, EOFError):
        pass
    else:
        fail(f"[{tag}] a proof with a flipped byte was accepted")
    log(f"[{tag}] verify {verify_s:.2f}s; flipped byte rejected")
    return prove_s, path, proof


def harness_row(argv, name, k, columns, launches, reset_launches):
    """benchmark.main(argv) in process at k, one sample after the harness's
    own warm-up; the row it appended to target/bench_torch/<name> is read
    back (no FAILED row, `columns` positive values at k) and returned."""
    from plonkish_tpu_torch import benchmark

    path = os.path.join(benchmark.BENCH_DIR, name)
    size = os.path.getsize(path) if os.path.exists(path) else 0
    reset_launches()
    t0 = time.time()
    benchmark.main([*argv, "--k", f"{k}..{k + 1}", "--samples", "1"])
    log(f"[harness] {name} {' '.join(argv)} k={k}: {time.time() - t0:.1f}s; kernel launches "
        f"{json.dumps(dict(launches))}")
    with open(path) as fh:
        fh.seek(size)
        added = fh.read().splitlines()
    if any(line.startswith("# FAILED") for line in added):
        fail(f"the harness wrote a FAILED row to {name}: {added}")
    rows = [line.split(",") for line in added if not line.startswith("#")]
    if len(rows) != 1 or len(rows[0]) != columns or int(rows[0][0]) != k:
        fail(f"the harness row of {name} at k={k} is missing: {added}")
    if not all(float(v) > 0 for v in rows[0][1:]):
        fail(f"the harness row of {name} holds no time: {added}")
    log(f"[harness] {name} row: {','.join(rows[0])} ms")
    return rows[0]


# ------------------------------------------------------ 9 univariate PLONK

def phase9_univariate(torch, k, launches, reset_launches, shapes):
    """Univariate (halo2-style) PLONK over BN254 with the univariate KZG at k
    on phase 4's circuit: setup (4·2^k powers), preprocess with its spans, a
    warm-up and a timed prove (K1 and K2 only), verify and a flipped byte;
    then one forward NTT of 4·2^k points timed; then the harness's
    univariate_plonk row at k = 16."""
    from plonkish_tpu_torch.backend.univariate import UnivariatePlonk
    from plonkish_tpu_torch.fields import limb
    from plonkish_tpu_torch.fields.spec import BN254_FR
    from plonkish_tpu_torch.pcs.univariate_kzg import UnivariateKzg
    from plonkish_tpu_torch.poly import ntt
    from plonkish_tpu_torch.utils import timer

    spec = BN254_FR
    tag = f"univariate k={k}"
    ci, circuit = shapes["circuit"]  # phase 11 proves it again
    backend = UnivariatePlonk(UnivariateKzg())
    torch.cuda.synchronize()
    t0 = time.time()
    param = backend.setup(ci, random.Random(0))
    torch.cuda.synchronize()
    setup_s = time.time() - t0
    timer.set_sync(torch.cuda.synchronize)
    timer.set_enabled(True)
    timer.reset_trace()
    t0 = time.time()
    pp, vp = backend.preprocess(param, ci)
    torch.cuda.synchronize()
    pre_s = time.time() - t0
    timer.set_enabled(False)
    spans = ", ".join(f"{n} {sec * 1e3:.1f} ms" for n, d, sec in timer.trace() if d == 0)
    log(f"[{tag}] setup {setup_s:.2f}s ({param.powers_of_s_g1.shape[0]} powers), preprocess "
        f"{pre_s:.2f}s ({spans})")
    del param
    prove_and_check(torch, tag, backend, pp, vp, circuit, spec, launches, reset_launches,
                    must=("msm_bucket_sums", "msm_window_sums"),
                    must_not=("sumcheck_round", "sumcheck_fold"))
    del backend, pp, vp, ci, circuit
    torch.cuda.empty_cache()

    n = 4 << k
    gen = torch.Generator().manual_seed(9)
    x = limb.to_mont(spec, rand_field(torch, spec, n, gen))
    ntt_ms = cuda_ms(torch, lambda: ntt.ntt(spec, x), 3)
    log(f"[{tag}] NTT forward of 2^{n.bit_length() - 1} points: {ntt_ms:.3f} ms")
    del x
    torch.cuda.empty_cache()
    harness_row(["--system", "univariate_plonk"], "univariate_plonk", K_UNIVARIATE_ROW, 2,
                launches, reset_launches)


# ------------------------------------------------------ 10 benchmark circuits

def phase10_circuits(torch, k, launches, reset_launches, shapes, ranks):
    """HyperPlonk over BN254 with multilinear KZG on the harness's circuits:
    the aggregation ladder at k (phase 4's SRS) and sha256 at K_SHA256, each
    synthesised, preprocessed, proved (warm-up, then timed with spans, peak
    and K1-K4 launches), verified and a flipped byte rejected; then the
    harness's hyperplonk rows of both circuits at smaller k.  The first
    synthesis runs beside the set-up of phase 11's ranks (`ranks`), which
    are waited for before anything here touches the card again."""
    from plonkish_tpu_torch import benchmark
    from plonkish_tpu_torch.backend.hyperplonk import HyperPlonk
    from plonkish_tpu_torch.fields.spec import BN254_FR
    from plonkish_tpu_torch.pcs.kzg import MultilinearKzg

    spec = BN254_FR
    for name, kk in (("aggregation", k), ("sha256", K_SHA256)):
        tag = f"{name} k={kk}"
        t0 = time.time()
        info, circuit = benchmark._circuit_fn(name)(spec, kk, random.Random(42),
                                                    random.Random(4242))
        synth_s = time.time() - t0
        if not ranks.is_ready():
            log(f"[{tag}] waited {ranks.wait_ready():.1f}s for phase 11's ranks to be set up")
        backend = HyperPlonk(MultilinearKzg())
        torch.cuda.synchronize()
        t0 = time.time()
        param = shapes.pop("param") if kk == shapes["k"] else backend.setup(info, random.Random(0))
        torch.cuda.synchronize()
        setup_s = time.time() - t0
        t0 = time.time()
        pp, vp = backend.preprocess(param, info)
        torch.cuda.synchronize()
        pre_s = time.time() - t0
        log(f"[{tag}] synthesis {synth_s:.2f}s ({info.num_poly()} polynomials, "
            f"{len(info.constraints)} constraints, {len(circuit.instances()[0])} instances), "
            f"setup {setup_s:.2f}s{' (phase 4 SRS)' if kk == shapes['k'] else ''}, "
            f"preprocess {pre_s:.2f}s")
        prove_and_check(torch, tag, backend, pp, vp, circuit, spec, launches, reset_launches,
                        must=PROVER_KERNELS)
        del backend, pp, vp, param, info, circuit
        torch.cuda.empty_cache()
    for name, kk in (("aggregation", K_AGGREGATION_ROW), ("sha256", K_SHA256_ROW)):
        harness_row(["--system", "hyperplonk", "--circuit", name], "hyperplonk", kk, 2,
                    launches, reset_launches)



# ------------------------------------------------------ 11 sharded prover

class SharedCardRanks:
    """Phase 11 (b)'s two gloo ranks, started when phase 10 starts, so that
    their set-up (circuit, SRS read, preprocess, warm-up prove) runs beside
    phase 10's first synthesis.  Each rank then waits for `go` before its
    timed prove: no timed region of phase 10 or of phase 11 (a) shares the
    card with them.  `close` stops ranks still waiting (the script failed)."""

    def __init__(self, k, srs_path):
        import torch.multiprocessing as mp

        from plonkish_tpu_torch import parallel

        ctx = mp.get_context("spawn")
        self.ready = [ctx.Event() for _ in range(2)]
        self.go, self.stop = ctx.Event(), ctx.Event()
        self.result = {}

        def run():
            try:
                self.result["ranks"] = parallel.spawn(
                    _phase11_rank, 2, "gloo", "cuda",
                    args=(k, srs_path, self.ready, self.go, self.stop), deadline_s=900)
            except Exception as e:  # noqa: BLE001 - a rank's failure fails the phase
                self.result["error"] = e

        self.thread = threading.Thread(target=run, name="phase 11 ranks")
        self.thread.start()

    def _failed(self):
        e = self.result["error"]
        fail(f"[mesh2 gloo] a rank failed: {type(e).__name__}: {e}")

    def is_ready(self):
        return all(e.is_set() for e in self.ready)

    def wait_ready(self):
        """Seconds waited until both ranks are set up; a rank's failure fails."""
        t0 = time.time()
        while not self.is_ready():
            if not self.thread.is_alive():
                self._failed()
            time.sleep(0.1)
        return time.time() - t0

    def finish(self):
        """Let the ranks prove; their results in rank order."""
        self.go.set()
        self.thread.join()
        if "error" in self.result:
            self._failed()
        return self.result["ranks"]

    def close(self):
        self.stop.set()
        self.thread.join()


def phase11_sharded(torch, k, launches, reset_launches, shapes, ranks):
    """The sharded prover at k on phase 4's circuit: (a) one NCCL rank in
    this process, (b) two gloo ranks sharing the card (`ranks`, set up
    since phase 10); every proof must equal phase 4's."""
    from plonkish_tpu_torch import parallel
    from plonkish_tpu_torch.backend.hyperplonk import HyperPlonk
    from plonkish_tpu_torch.fields import limb
    from plonkish_tpu_torch.fields.spec import BN254_FR
    from plonkish_tpu_torch.parallel import sharded
    from plonkish_tpu_torch.pcs.kzg import MultilinearKzg

    want = shapes["proof"]
    ci, circuit = shapes["circuit"]
    # (a) one rank over NCCL: the collectives run, the MSM stays whole (the
    # reference's rule splits it only over more than one rank)
    t0 = time.time()
    mesh = sharded.make_mesh("nccl")
    try:
        with parallel.use_mesh(mesh):
            sharded.all_reduce_field(BN254_FR, mesh, limb.zeros((1,), mesh.device))
            log(f"[mesh1 nccl] group of one rank on {mesh.device} up in {time.time() - t0:.2f}s")
            prove_s, path, proof = prove_and_check(
                torch, f"mesh1 nccl k={k}", HyperPlonk(MultilinearKzg()), shapes["pp"],
                shapes["vp"], circuit, BN254_FR, launches, reset_launches,
                must=PROVER_KERNELS, mesh=mesh)
            if mesh.collectives <= 0 or mesh.taken["sum_check"] != 2:
                fail(f"[mesh1 nccl] the prove did not go through the mesh: {dict(mesh.taken)}")
    finally:
        mesh.close()
    if proof != want:
        fail("[mesh1 nccl] the proof under a one-rank mesh differs from phase 4's")
    log(f"[mesh1 nccl k={k}] proof equals phase 4's ({len(proof)} bytes); prove {prove_s:.3f}s "
        f"against phase 4's {shapes['prove_s']:.3f}s unsharded")

    # (b) two ranks on one card: gloo (NCCL refuses two ranks on one card)
    t0 = time.time()
    ranks.wait_ready()
    results = ranks.finish()
    log(f"[mesh2 gloo k={k}] two ranks' timed proves done in {time.time() - t0:.1f}s, card "
        "shared (their set-up ran beside phase 10)")
    for r in results:
        tag = f"mesh2 gloo k={k} rank {r['rank']}"
        log(f"[{tag}] circuit {r['circuit_s']:.2f}s, SRS read {r['srs_s']:.2f}s, preprocess "
            f"{r['preprocess_s']:.2f}s, warm-up prove {r['warm_s']:.2f}s; prove {r['prove_s']:.3f}s "
            f"(phase 4 unsharded {shapes['prove_s']:.3f}s; the other rank shares the card), "
            f"peak device memory {r['peak'] / 2**30:.2f} GiB, {r['collectives']} collectives, "
            f"{r['bytes']} bytes put in, sharded sites {json.dumps(r['taken'])}, kernel launches "
            f"{json.dumps(r['launches'])}, K3 kernels built or loaded in the timed prove "
            f"{r['k3_built']}")
        if r["proof"] != want:
            fail(f"[{tag}] the proof differs from phase 4's unsharded proof")
        for name in PROVER_KERNELS:
            if r["launches"][name] <= 0:
                fail(f"[{tag}] kernel {name} was not launched on the rank's rows")
        if r["taken"].get("msm", 0) <= 0 or r["taken"].get("sum_check") != 2:
            fail(f"[{tag}] sharded_msm or the sharded sum-checks were not taken: {r['taken']}")
    log(f"[mesh2 gloo k={k}] both ranks' proofs equal phase 4's ({len(want)} bytes)")


def _phase11_rank(mesh, k, srs_path, ready, go, stop):
    """One rank of phase 11 (b): phase 4's circuit and SRS, a warm-up prove,
    then (`ready` set, `go` awaited; `stop` ends the rank) a timed one under
    the mesh, with launches, collectives and peak."""
    import torch

    from plonkish_tpu_torch import benchmark
    from plonkish_tpu_torch.backend.hyperplonk import HyperPlonk
    from plonkish_tpu_torch.fields.spec import BN254_FR
    from plonkish_tpu_torch.kernels import LAUNCHES, reset_launches, sumcheck_gen
    from plonkish_tpu_torch.models.circuits import rand_vanilla_plonk_circuit
    from plonkish_tpu_torch.pcs.kzg import MultilinearKzg
    from plonkish_tpu_torch.utils.transcript import Keccak256Transcript

    out = {"rank": mesh.rank}
    t0 = time.time()
    ci, circuit = rand_vanilla_plonk_circuit(BN254_FR, k, random.Random(1), random.Random(2))
    out["circuit_s"] = time.time() - t0
    t0 = time.time()
    param = benchmark.load_srs(srs_path, mesh.device)
    out["srs_s"] = time.time() - t0
    backend = HyperPlonk(MultilinearKzg(device=mesh.device))
    t0 = time.time()
    pp, _ = backend.preprocess(param, ci)
    torch.cuda.synchronize()
    out["preprocess_s"] = time.time() - t0
    del param
    t0 = time.time()
    backend.prove(pp, circuit, Keccak256Transcript(BN254_FR))
    torch.cuda.synchronize()
    out["warm_s"] = time.time() - t0
    ready[mesh.rank].set()
    while not go.wait(0.5):
        if stop.is_set():
            raise RuntimeError("stopped before the timed prove: the script failed")
    built = len(sumcheck_gen.BUILDS)
    reset_launches()
    mesh.reset_stats()
    torch.cuda.reset_peak_memory_stats()
    tr = Keccak256Transcript(BN254_FR)
    torch.cuda.synchronize()
    t0 = time.time()
    backend.prove(pp, circuit, tr)
    torch.cuda.synchronize()
    out["prove_s"] = time.time() - t0
    out.update(proof=tr.into_proof(), launches=dict(LAUNCHES), collectives=mesh.collectives,
               bytes=mesh.bytes, taken=dict(mesh.taken), peak=torch.cuda.max_memory_allocated(),
               k3_built=len(sumcheck_gen.BUILDS) - built)
    return out


if __name__ == "__main__":
    sys.exit(main())
