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
   ptxas line and build seconds beside those before K7 joined the tape's
   source; each tape's library also holds K7, the fused sum-check rounds
   (csrc/sumcheck_fused.cuh: its grid rounds and its cluster tail), whose
   launch shapes, registers and ptxas lines are printed too; the vanilla
   and lookup tapes' K3 and K7's two kernels must have a 0-byte stack frame
   and no spills;
   print the card.  The sha256 tape takes about four minutes to build: it
   builds in a thread of its own through phases 2-9, and is printed and
   held against its plain version (as phase 2 holds the others, K3 and
   K7) once it is built, after phase 9 and before phase 10 runs it.  The
   library holds K6, the device transcript's round message
   (csrc/fiat_shamir.cu), whose four kernels must have a 0-byte stack frame
   and no spills, and the IPA fold's ladder and affine conversion, each
   printed with its registers; the native host runtime of the bench's
   baseline (csrc/field_native.cpp, g++) builds in a thread until phase 12;
2. every kernel against its plain PyTorch version on the card, on the same
   inputs, exact equality required (MSM K1+K2 on BN254 at 2^12 points with
   edge cases, at 2^16 random points and at 2^16 selector-like scalars in
   {0, 1, 2, p - 1}, and on Grumpkin at 2^12 with edge cases and 2^16 at
   random; one variable_base_msm at 2^16 enqueued under
   torch.cuda.set_sync_debug_mode("error") up to its one-point read;
   sum-check round K3 for every expression of phase 1 at 2^16 pairs and at
   one pair, fold K4 over Fr and Fq, the IPA base fold (ladder and affine
   conversion) at 2^12 + 3 points with identities for xi in {0, 1, q - 1,
   random, lambda, -lambda} and on a chunk of the batch inversion whose sums
   are all the identity, and for four xi with GLV halves of each pair of
   signs on 35 points against the host's arithmetic,
   the mont_mul chain probe K5 with its three multipliers at 2^16 elements,
   and the PTX product (csrc/field_ptx.cuh, the tape's products in K3 and
   K7) against fe_mul over Fr and Fq on 2^20 random pairs, the edge pairs
   and pairs that need the final subtraction, the Montgomery conversion
   (csrc/convert.cu, limb.from_mont and limb.to_mont) in both directions
   over Fr and Fq at 2^20, timed beside its byte bound; Brakedown's commit
   at k = 20, Spec 6, on its main path (MultilinearBrakedown.commit) with
   its launches of the encode and hash kernels (csrc/brakedown.cu,
   csrc/merkle.cu) and of the conversion counted, its rows and every node
   of its Merkle tree against the plain versions, each kernel timed beside
   its bound, and whole commits at k = 3, 5 and 8 against the CPU's; K6
   over Fr and Fq at degrees 1, 2, 3, 5, 9 and 32 from sponges with 0, 32,
   80, 120 and 128 bytes pending (0 and 128 at degree 32), and ten chained
   rounds with the Coefficients round beside each); K7 over every round of
   a sum-check of every phase-1 tape over Fr and Fq at k = 13 (one table's
   at k = 17, sha256's at k = 12) and of vanilla at k = 17, from sponges
   with 0, 32, 80 and 120 bytes pending: messages, challenges, sponge words
   and final tables exactly, each case through the grid rounds, the
   cluster's tail rounds and block 0's last rounds (a case that does not
   launch both kernels fails);
3. the nine frozen HyperPlonk proofs of tests/golden (KZG k3, k5 and lookup
   k5; Gemini, Zeromorph, IPA and Hyrax k5; Brakedown k3 and k5) and the
   Protostar decider proof (KZG, k3, after two folds) produced on the card,
   byte for byte, and accepted by the port's verifier;
4. HyperPlonk over BN254 with multilinear KZG on a random vanilla-PLONK
   circuit at k = 20: setup, preprocess, a warm-up prove, a timed prove with
   its span breakdown and kernel launch counts, verify, and a flipped byte
   rejected; the timed prove must build no K3 kernel (the count of
   generated kernels is printed) and must launch K7 once (the zero-check)
   and, with the handover at every round, no K3 and no K6 Evaluations
   round; then the prove again with PLONKISH_TPU_FUSED_ROUNDS=0 (K3, K6
   and K4 once a round, no K7) and with PLONKISH_TPU_DEVICE_FS=0 (the host
   transcript, no K6 and no K7), each timed, each proof equal to the
   default prove's byte for byte;
5. each kernel timed with CUDA events at the shapes of the k = 20 proves (K5
   at 2^22 elements, 16 products deep, both multipliers), beside its plain
   version and the least time the card could take; the operation and byte
   counts are those of plonkish_tpu_torch/roofline.py, and the [peaks] line
   says which multiply-add rate, measured by K5 or assumed, the bounds used;
   also K1 on selector-like scalars at 2^20, the whole variable_base_msm at
   2^20 and at 2^10 (its fixed cost), and K3 summed over the 20 rounds of
   the k = 20 zero-check with K4 between rounds; then the Grumpkin K1 and K2
   at 2^20 points of the IPA basis, K3 and K4 over Fq at the k = 20 shapes
   and the IPA base fold's two kernels at 2^19 points (beside the whole
   fold's bound); K5 at one element, 16 deep and with no product (one
   product's latency, the launch floor); K6 a launch, both rounds, beside
   its latency bound; K7 over the k = 20 zero-check's 20 rounds beside the
   same rounds launched one by one and its bound, each round alone against
   K3 + K6 + K4 at its size (the handover rule), the tail from 2^12 pairs;
6. the bench harness in process (plonkish_tpu_torch.benchmark): the
   zero_check system at k = 16 (20 until phase 11 came, 18 until K7) and the pcs kzg
   system at k = 20, whose rows are read back from
   target/bench_torch/, with the launch counts of the five kernels of that
   path;
7. HyperPlonk over BN254 Fq with the multilinear IPA on Grumpkin on a random
   vanilla-PLONK circuit at k = 20: setup (the basis of 2^20 points hashed
   to the curve on the card), preprocess, a warm-up prove, a timed prove
   with its span breakdown and launch counts (K1 and K2 on Grumpkin, K3 and
   K4 over Fq, the IPA base fold), verify, and a flipped byte rejected; then
   the harness's pcs system at k = 14 for gemini, zeromorph, hyrax,
   brakedown and ipa, with the rows read back (k = 20 until phase 8 came,
   18 until the script ran past its time on a slower host, 16 until K7:
   PERF.md keeps those rows);
8. folding at full size: Protostar over BN254 with multilinear KZG on the
   random vanilla-PLONK circuit of phase 4 at k = 20: setup, preprocess, then
   timed, two folds (the circuit of phase 4 and one with another witness)
   and the decider with the NARK of phase 4's circuit again, each fold's and the
   decider's ms, the span breakdown, the peak device memory and the launches
   of K1-K4 in that region (each must launch, and no K3 may be built there);
   the decider verified and a flipped byte rejected; then the harness's
   sangria system at k = 14 in process (20 until phase 11 came, then 18,
   16 until K7),
   its fold and decider rows read back;
9. univariate (halo2-style) PLONK over BN254 with the univariate KZG on a
   random vanilla-PLONK circuit at k = 18 (phase 4's at k = 20 until K7):
   setup (4 * 2^18 powers), preprocess with its spans, a warm-up prove, a
   timed prove with its spans, peak device memory and launches (K1 and K2
   must launch, K3, K4 and K7 must not), verify, and a flipped byte
   rejected; one forward NTT of 2^20 points timed; then the harness's
   univariate_plonk row at k = 16;
10. HyperPlonk over BN254 with multilinear KZG on the harness's benchmark
   circuits: the aggregation ladder at k = 20 (the reference's default
   workload; phase 4's SRS) and sha256 at k = 12 (29 blocks: its Python
   synthesis takes about 30 ms a block, so k = 20's 7,489 blocks would take
   about 220 s before any prove; 16 until K7), each synthesised,
   preprocessed, proved (warm-up, then timed with spans, peak and kernel
   launches, no K3 built), verified and a flipped byte rejected; then the
   harness's hyperplonk rows of aggregation at k = 16 (18 until K7) and
   sha256 at k = 12 (14 until K7).  Phase 11 (b)'s ranks
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
   card, so no scaling is claimed: the two ranks share it);
12. the device transcript on phase 4's circuit and params at k = 20: the
   zero-check's per-round split with the host transcript, the device one a
   round at a time and the fused one (plonkish_tpu_torch.profile_zero_check),
   the device rounds of both enqueued under
   torch.cuda.set_sync_debug_mode("error") up to their one transfer; then
   the MSM bench (plonkish_tpu_torch.bench) at 2^20 in process, its device
   point equal to the native one.

Phases 3-11 run with the device transcript and the fused rounds on
(PLONKISH_TPU_DEVICE_FS's and PLONKISH_TPU_FUSED_ROUNDS's defaults): each
Evaluations sum-check on the card is one launch of K7 (K3's sums, K6's
message and K4's fold a round), and each batch open's round enqueues its
sums, K6 and K4, with no host read, so each of their equality checks holds
K6 and K7 too; a prove must launch K7 once for each Evaluations sum-check
and K6's Coefficients round as it launches K1, K2 and K4 (PROVER_KERNELS).
Where the rows are sharded over a mesh (phase 11) the rounds launch K3, K6
and K4 one by one until the rows are gathered.

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
K_PCS_ROWS = 14  # 16 until phase 2 came to hold K7 against its plain version for every tape
K_SANGRIA_ROW = 14  # 16 until then
# phase 9's univariate PLONK: phase 4's k until phase 2 came to hold K7 against
# its plain version for every tape, then its own circuit at 18
K_UNIVARIATE = 18
# phase 6's zero_check row, cut from 20 for the same reason, then from 18 to 16
# when phase 2 came to hold K7 against its plain version for every tape
K_ZERO_CHECK_ROW = 16
MSM_KERNELS = ("msm_bucket_sums", "msm_window_sums")
# K6, the device transcript's round message: the zero-check's rounds and the
# batch open's degree-2 rounds
FS_KERNELS = ("fs_round_message", "fs_coeff_message")
# K3 and K6's Evaluations round: an Evaluations sum-check's rounds launched one
# by one (PLONKISH_TPU_FUSED_ROUNDS=0, the rounds above the handover, the
# rounds sharded over a mesh)
ROUND_KERNELS = ("sumcheck_round", "fs_round_message")
# K7, the fused rounds: for each Evaluations sum-check of a prove one launch of
# its grid rounds (where the first round's pairs exceed the handover) and one
# of its tail
FUSED_KERNEL = "sumcheck_fused"
TAIL_KERNEL = "sumcheck_fused_tail"
FUSED_KERNELS = (FUSED_KERNEL, TAIL_KERNEL)
# the build seconds of each tape's library before K7 joined K3 in it (the
# parent tree's phase 1 on an NVIDIA H100 80GB HBM3 at 700 W), keyed as
# k3_cases
BUILD_SECONDS_BEFORE_K7 = {
    ("Fr", "vanilla"): 20.3, ("Fr", "lookup"): 23.7, ("Fq", "vanilla"): 20.6,
    ("Fq", "lookup"): 23.1, ("Fr", "aggregation"): 23.7, ("Fr", "protostar_vanilla"): 22.9,
    ("Fr", "protostar_lookup"): 26.2, ("Fr", "sangria_vanilla"): 21.0,
    ("Fr", "sangria_lookup"): 24.4, ("Fq", "protostar_vanilla"): 23.7,
    ("Fr", "single_leaf"): 12.9, ("Fr", "wide"): 30.3, ("Fr", "sha256_k16"): 164.2,
    ("Fr", "sha256_k14"): 166.6,
}
# K7's buffers, in the order kernels/sumcheck.py fused_rounds takes them
FUSED_ORDER = ("ids", "rows", "sponge", "scal", "fixed", "out", "ch_mont")
# phase 2's K6 cases: degree 9 is the widest of phase 1's tapes, 32 the
# widest K6 takes (checked from 0 and 128 pending bytes only: its plain
# version takes a second a case); 128 pending bytes fill the rate with the
# first lane
FS_DEGREES = (1, 2, 3, 5, 9, 32)
# phase 2's K7 checks, each through both K7 kernels: every tape's sum-check at
# K_FUSED_CHECK, whose first round exceeds the handover of 16-24 tables (2,048
# pairs), or at 17 where it does not (one table: 32,768 pairs); the sha256
# tapes' (a handover of 64 pairs) at K_FUSED_CHECK_SHA256, where their plain
# rounds already take a minute
K_FUSED_CHECK = 13
K_FUSED_CHECK_SHA256 = 12
K7_VANILLA_REGS = 156  # K3's registers on the vanilla tape: K7's grid kernel's aim
FS_PENDING = (0, 32, 80, 120, 128)
FS_WIDEST_PENDING = (0, 128)
# a default prove: K1, K2, K4 and K6's Coefficients round (the batch open), K7
PROVER_KERNELS = MSM_KERNELS + ("sumcheck_fold", "fs_coeff_message") + FUSED_KERNELS
# a prove with PLONKISH_TPU_FUSED_ROUNDS=0, or on a mesh
PER_ROUND_KERNELS = MSM_KERNELS + ("sumcheck_round", "sumcheck_fold") + FS_KERNELS
# the decider tapes of phase 8, the harness's sangria and the IPA path:
# (name, scheme, circuit of models.circuits)
DECIDERS = (
    ("protostar_vanilla", "protostar", "rand_vanilla_plonk_circuit"),
    ("protostar_lookup", "protostar", "rand_vanilla_plonk_with_lookup_circuit"),
    ("sangria_vanilla", "sangria", "rand_vanilla_plonk_circuit"),
    ("sangria_lookup", "sangria", "rand_vanilla_plonk_with_lookup_circuit"),
)
# the IPA base fold is two launches: the ladder and the affine conversion
IPA_KERNELS = PROVER_KERNELS + ("ipa_base_fold", "ipa_fold_affine")
# phase 10's sha256 circuit: 29 blocks (k = 20 would be 7,489), cut from 16
# and its harness row from 14 to one k when phase 2 came to hold K7 against
# its plain version for every tape: one sha256 tape to build and check, not
# two, and its proves a quarter of the rows
K_SHA256 = 12
# harness rows of 9 and 10 (aggregation's cut from 18 to 16 with K_SHA256)
K_UNIVARIATE_ROW, K_AGGREGATION_ROW, K_SHA256_ROW = 16, 16, 12
# phase 10's zero-check tapes: (circuit, k).  The sha256 expression holds the
# permutation's identity offsets i * 2^k, and where one equals a bit weight
# 2^j of the gates the two constants share a row of the tape's constant
# table, so its structure, and its kernel, depends on k.
BENCH_TAPES = {
    "aggregation": ("aggregation", K_FULL),
    f"sha256_k{K_SHA256}": ("sha256", K_SHA256),
    f"sha256_k{K_SHA256_ROW}": ("sha256", K_SHA256_ROW),
}
# the sha256 tape takes about four minutes to build: it builds in the
# background through phases 2-9, and is checked before phase 10
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
    native = start_native_build()
    structures, late = phase1_round_kernels(torch)
    main_lib.join()
    if "path" not in built:
        fail("the kernel library did not build")
    log(f"[build] {built['path'].name} in {built['seconds']:.1f}s; phase 1 done in "
        f"{time.time() - t0:.1f}s, the sha256 tapes still building")
    for line in build.ptxas_log.splitlines():
        if "Compiling entry" in line or "registers" in line or "spill" in line:
            log(f"[build] {line.strip()}")
    check_library_frames(build.ptxas_log)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"[card] {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    def at(phase):
        log(f"[phase {phase}] starts {time.time() - t_start:.1f}s into the script")

    at(2)
    brakedown_rows, paths_brakedown = phase2_kernels(torch, structures, reset_launches)
    phase2_round_message(torch)
    at(3)
    phase3_golden(torch, here)
    at(4)
    paths, shapes = phase4_full(torch, K_FULL, LAUNCHES, reset_launches)
    paths["brakedown"] = paths_brakedown
    at(5)
    kernels = phase5_timing(torch, shapes, paths) + brakedown_rows
    at(6)
    paths["harness"] = phase6_harness(K_FULL, LAUNCHES, reset_launches)
    at(7)
    paths["ipa"], paths["ipa_per_round"] = phase7_ipa(torch, K_FULL, LAUNCHES, reset_launches)
    phase7_harness(K_PCS_ROWS, LAUNCHES, reset_launches)
    at(8)
    phase8_folding(torch, K_FULL, LAUNCHES, reset_launches, shapes)
    at(9)
    phase9_univariate(torch, K_UNIVARIATE, LAUNCHES, reset_launches, shapes)
    late_round_kernels(torch, late, structures)  # the sha256 tape, before phase 10 runs it
    at(10)
    ranks = SharedCardRanks(K_FULL, shapes["srs_path"])
    try:
        phase10_circuits(torch, K_FULL, LAUNCHES, reset_launches, shapes, ranks)
        at(11)
        phase11_sharded(torch, K_FULL, LAUNCHES, reset_launches, shapes, ranks)
    finally:
        ranks.close()
    at(12)
    phase12_device_fs(torch, K_FULL, shapes, native)
    for row in kernels:  # each kernel's launches on the path that runs it
        row["launches"] = paths[row.pop("path")][row.pop("counter")]
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


def graph_ms(torch, fn, launches=100, reps=5):
    """ms a call of `fn`, its `launches` calls captured in one CUDA graph
    and replayed: the device's time without the host's enqueue, for kernels
    that take less time than a Python call takes to launch them."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * launches)


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


def xi_with_signs(curve, s1, s2):
    """A random challenge whose GLV halves (k1, k2) have the signs s1, s2."""
    from plonkish_tpu_torch.curves.device import _glv_split

    rng = random.Random(30 + 2 * s1 + s2)
    while True:
        xi = rng.randrange(curve.scalar.p)
        k1, k2 = _glv_split(curve, xi)
        if (k1 > 0) - (k1 < 0) == s1 and (k2 > 0) - (k2 < 0) == s2:
            return xi


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

def ptxas_frames(text):
    """{kernel: (stack frame, spill stores, spill loads, registers)} from a
    `ptxas -v` log."""
    frames, name = {}, None
    for line in text.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            name = m.group(1)
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill "
                      r"loads", line)
        if m and name:
            frames[name] = tuple(int(g) for g in m.groups())
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and name in frames and len(frames[name]) == 3:
            frames[name] += (int(m.group(1)),)
            name = None
    return frames


def check_library_frames(text):
    """The IPA fold's and K6's kernels as ptxas built them; K6's four (two
    rounds, two fields) must keep everything in registers: no stack frame,
    no spills."""
    frames = ptxas_frames(text)
    k6 = 0
    for name, frame in sorted(frames.items()):
        if not any(k in name for k in ("ipa_fold_", "fs_round_kernel", "fs_coeff_kernel")):
            continue
        regs = frame[3] if len(frame) > 3 else "?"
        log(f"[build] {name}: {regs} registers, {frame[0]} bytes stack frame, {frame[1]} bytes "
            f"spill stores, {frame[2]} bytes spill loads")
        if "fs_" in name:
            k6 += 1
            if frame[:3] != (0, 0, 0):
                fail(f"K6 {name} has a stack frame or spills: {frame}")
    if k6 != 4:
        fail(f"ptxas reported {k6} K6 kernels, not 4")


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
    check_fused_kernels(torch, k3_bench_cases(torch, K_FUSED_CHECK_SHA256, gen, LATE_TAPES),
                        random.Random(15))


def log_round_builds(cases, kernels):
    """Each tape library's lines: K3's and K7's (both built from the tape's one
    source) with the library's build seconds beside those before K7 joined
    it; K7's two kernels (the grid rounds and the cluster tail) with their
    launch shapes and registers.  The vanilla and lookup tapes' three kernels
    must keep every register in a register; K7's vanilla grid kernel is
    meant to need at most K7_VANILLA_REGS registers (a line says where it
    does not)."""
    from plonkish_tpu_torch.piop.tape import OP_MUL

    for (field, name), kern in zip(cases, kernels):
        instrs, num_regs, _, tables, degree, _ = tape_of(cases[(field, name)])
        before = BUILD_SECONDS_BEFORE_K7.get((field.split("::")[-1], name))
        log(f"[build] K3 {name} over {field}: {len(instrs)} instructions, "
            f"{int((instrs[:, 0] == OP_MUL).sum())} products, {num_regs} tape registers, "
            f"{tables} tables, degree {degree}: built in {kern.build_seconds:.1f}s "
            f"({'not built before' if before is None else f'{before:.1f}s without K7'}); "
            f"{kern.warps} warps a block, {kern.resident} blocks resident; {kern.ptxas}")
        fused, tail = kern.fused, kern.tail
        grid = "sc_fused_kernel_capped" if fused.capped else "sc_fused_kernel"  # the build taken
        build = (f"the build capped at {fused.max_threads} threads" if fused.capped
                 else "the uncapped build")
        log(f"[build] K7 {name} over {field}: grid rounds {fused.warps} warps a block, "
            f"{fused.resident} blocks resident, {fused.regs} registers, {fused.stack} bytes of "
            f"local memory ({build}); tail {tail.warps} warps a block, a cluster of "
            f"{tail.cluster}, {tail.smem} bytes of shared memory a block, {tail.regs} "
            f"registers, {tail.stack} bytes of local memory; {fused.ptxas}; {tail.ptxas}")
        if name == "vanilla" and fused.regs > K7_VANILLA_REGS:
            log(f"[build] K7 vanilla over {field}: {fused.regs} registers, above "
                f"{K7_VANILLA_REGS}: the grid kernel keeps {fused.warps} warps a block "
                f"({fused.resident} blocks)")
        for kernel, ptxas, stack in (("sc_round_kernel", kern.ptxas, kern.stack),
                                     (grid, fused.ptxas, fused.stack),
                                     ("sc_tail_kernel", tail.ptxas, tail.stack)):
            frame = re.search(re.escape(kernel) + r": (\d+) bytes stack frame, (\d+) bytes "
                              r"spill stores, (\d+) bytes spill loads", ptxas)
            if (name in ("vanilla", "lookup")
                    and (frame is None or frame.groups() != ("0", "0", "0") or stack)):
                fail(f"{kernel} {name} over {field}: ptxas reports a stack frame or spills: "
                     f"{ptxas}")


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


def fused_buffers(torch, spec, degree, k, pending, rng, device="cuda"):
    """K7's buffers for the k rounds of a sum-check of `degree` from round 0
    (FUSED_ORDER): a sponge with `pending` bytes buffered, a random claimed
    sum and offset, the identity stack and round 0's rows, the Lagrange
    constants and the message rows."""
    from plonkish_tpu_torch.fields.host import Fp
    from plonkish_tpu_torch.piop.sum_check import identity_params, identity_stack

    case = fs_round_case(torch, spec, degree, pending, rng, device)
    return {"ids": identity_params(spec, 0, Fp.zero(spec), device),
            "rows": identity_stack(spec, [0] * k, device), "sponge": case["sponge"],
            "scal": case["scal"], "fixed": case["fixed"],
            "out": torch.zeros((k, degree + 2, 8), dtype=torch.int32, device=device),
            "ch_mont": torch.zeros(8, dtype=torch.int32, device=device)}


def fused_outputs(torch, case, bufs, plain, first=0, rounds=None):
    """K7 (or its plain version) over a k3_cases case on copies of `bufs`,
    from round `first` for `rounds` rounds (all when None): the final state
    and every buffer it writes."""
    from plonkish_tpu_torch.kernels import sumcheck as ksc

    stacked, instrs, consts, num_regs, out_reg, degree, spec = case
    b = {n: v.clone() for n, v in bufs.items()}
    fn = ksc.fused_rounds_plain if plain else ksc.fused_rounds_cuda
    rounds = rounds or stacked.shape[1].bit_length() - 1
    b["state"] = fn(spec, stacked.clone(), instrs, consts, num_regs, out_reg, degree,
                    *(b[n] for n in FUSED_ORDER), first, rounds)
    return b


def crosses_handover(case):
    """Whether K7 on a k3_cases case runs both its kernels: a first round
    above the handover (kernels/sumcheck.py tail_plan), then the tail."""
    from plonkish_tpu_torch.kernels import sumcheck as ksc
    from plonkish_tpu_torch.kernels import sumcheck_gen

    stacked, degree = case[0], case[5]
    plan = ksc.tail_plan(sumcheck_gen.kernel(*tape_of(case)).tail, stacked.shape[0], degree)
    return plan is not None and stacked.shape[1] // 2 > plan[2]


def check_fused_kernels(torch, cases, rng):
    """K7 against its plain version for each case of k3_cases, every round of
    its sum-check (k the case's), from sponges with 0, 32, 80 and 120 bytes
    pending in turn: the messages and challenges, the sponge's words, the
    sum and offset, the identity rows and the final tables, exactly.  Each
    case must launch both K7 kernels, the grid rounds and the tail, once."""
    from plonkish_tpu_torch.kernels import LAUNCHES

    t0 = time.time()
    for i, ((field, name), case) in enumerate(cases.items()):
        stacked, degree, spec = case[0], case[5], case[6]
        k = stacked.shape[1].bit_length() - 1
        bufs = fused_buffers(torch, spec, degree, k, FS_PENDING[i % 4], rng, stacked.device)
        before = {n: LAUNCHES[n] for n in FUSED_KERNELS}
        got = fused_outputs(torch, case, bufs, plain=False)
        launched = [LAUNCHES[n] - before[n] for n in FUSED_KERNELS]
        if launched != [1, 1]:
            fail(f"K7 on the {name} expression over {field} at k={k} launched "
                 f"{dict(zip(FUSED_KERNELS, launched))}: the check must run both kernels once")
        want = fused_outputs(torch, case, bufs, plain=True)
        for key in got:
            if not torch.equal(got[key], want[key]):
                fail(f"K7 sumcheck_fused differs from its plain version ({name} expression over "
                     f"{field}, k={k}): {key}")
    log(f"[kernels] K7 fused rounds against the plain K3 -> K6 -> K4, every round of "
        f"{len(cases)} sum-checks ({', '.join(f'{n} over {f}' for f, n in cases)}) at k="
        f"{sorted({c[0].shape[1].bit_length() - 1 for c in cases.values()})}, each through "
        f"the grid rounds and the tail: messages, "
        f"challenges, sponge words, sums, identity rows and final tables equal "
        f"({time.time() - t0:.1f}s)")


# ------------------------------------------------------ 2 kernels vs plain

def phase2_kernels(torch, structures, reset_launches):
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

    early = [n for n in BENCH_TAPES if n not in LATE_TAPES]
    cases, (state, _) = k3_cases(torch, 17, gen, bench=early)
    check_round_kernels(torch, cases, structures)
    # K7 over every round, through both its kernels: each tape over Fr and Fq
    # at k = K_FUSED_CHECK, or at k = 17 where its first round there does not
    # exceed the handover; vanilla at k = 17 too
    fr = BN254_FR.name
    check_fused_kernels(torch, {(fr, "vanilla"): cases[(fr, "vanilla")]}, random.Random(14))
    small = k3_cases(torch, K_FUSED_CHECK, gen, bench=early)[0]
    check_fused_kernels(torch, {key: case if crosses_handover(case) else cases[key]
                                for key, case in small.items()}, random.Random(16))
    for spec, stacked in ((BN254_FR, state.stacked),
                          (BN254_FQ, cases[(BN254_FQ.name, "vanilla")][0])):
        ch = limb.const(spec, 0x1234567890ABCDEF, "cuda")
        if not torch.equal(ksc.fold_cuda(spec, stacked, ch), ksc.fold_plain(spec, stacked, ch)):
            fail(f"K4 sumcheck_fold differs from its plain version over {spec.name}")
        log(f"[kernels] K4 fold over {spec.name}, {stacked.shape[0]} tables x {stacked.shape[1]} "
            "rows: 0 mismatches")

    # the IPA base fold against its plain version: identities among L and R,
    # n one past a chunk of the batch inversion, xi at its edges, lambda
    # (k1 = 0) and at random; the conversion also on the plain ladder's points
    t0 = time.time()
    gc = GRUMPKIN_G1
    n = (1 << 12) + 3
    _, pts, _ = msm_inputs(torch, 2 * n, gen, "random", gc)
    pts[5:9] = 0
    pts[n + 7: n + 11] = 0
    left, right = pts[:n].contiguous(), pts[n:].contiguous()
    right[20] = left[20]  # L + R with L = R
    lam = cdev._endomorphism(gc)[1]
    xis = (0, 1, gc.scalar.p - 1, random.Random(5).randrange(gc.scalar.p), lam, gc.scalar.p - lam)
    for xi in xis:
        plain_jac = kipa.ladder_plain(gc, left, right, xi)
        want = kipa.affine_plain(gc, plain_jac)
        if not torch.equal(kipa.base_fold_cuda(gc, left, right, xi), want):
            fail(f"the IPA base fold differs from its plain version for xi of "
                 f"{xi.bit_length()} bits (GLV halves {cdev._glv_split(gc, xi)})")
        if not torch.equal(kipa.affine_cuda(gc, plain_jac), want):
            fail("the IPA fold's affine conversion differs from its plain version")
    # GLV halves of each pair of signs, on a chunk and 3 points more, against
    # the host's arithmetic (each plain ladder of a 126-bit half takes seconds)
    m = kipa.FOLD_CHUNK + 3
    lh, rh = (cdev.affine_to_host(gc, t[:m].cpu()) for t in (left, right))
    for s1 in (1, -1):
        for s2 in (1, -1):
            xi = xi_with_signs(gc, s1, s2)
            got = kipa.base_fold_cuda(gc, left[:m].contiguous(), right[:m].contiguous(), xi)
            if cdev.affine_to_host(gc, got.cpu()) != [a + b.scalar_mul(xi) for a, b in zip(lh, rh)]:
                fail(f"the IPA base fold differs from the host's arithmetic for GLV halves of "
                     f"signs {s1}, {s2}")
    # a whole chunk of identities: L = -lambda R over the first chunk
    chunk = kipa.FOLD_CHUNK
    left[:chunk] = cdev.jac_to_affine(gc, cdev.unpack_jac(cdev.scalar_mul_const(
        gc, right[:chunk].contiguous(), gc.scalar.p - lam)))
    got = kipa.base_fold_cuda(gc, left, right, lam)
    if not (torch.equal(got, kipa.base_fold_plain(gc, left, right, lam))
            and not got[:chunk].any()):
        fail("the IPA base fold differs from its plain version on a chunk of identities")
    log(f"[kernels] IPA base fold (ladder and affine conversion), {n} points with "
        f"identities, xi in 0, 1, q - 1, lambda, -lambda and at random, a chunk of {chunk} "
        f"identities, against the plain version; GLV halves of each pair of signs on {m} "
        f"points against the host: 0 mismatches ({time.time() - t0:.1f}s)")

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
        f"{', '.join(kprobe.VARIANTS)}: 0 mismatches")
    check_ptx_product(torch, gen)
    check_field_convert(torch, gen)
    return check_brakedown_kernels(torch, gen, reset_launches)


def final_subtraction_pairs(spec, count, rng):
    """`count` pairs (a, b) below p whose Montgomery product's sum
    (a b + m p) / R, before the last conditional subtraction, is p or more."""
    r = 1 << 256
    neg_inv = (-pow(spec.p, -1, r)) % r
    pairs = []
    while len(pairs) < count:
        a, b = rng.randrange(spec.p), rng.randrange(spec.p)
        if (a * b + (a * b * neg_inv % r) * spec.p) // r >= spec.p:
            pairs.append((a, b))
    return pairs


def check_ptx_product(torch, gen):
    """The product in PTX carry chains (csrc/field_ptx.cuh, K3's and K7's
    tape products on the card) against fe_mul, both through K5 one deep, and
    the PTX sum, difference and negation against field.cuh's
    (probe.field_ops_cuda), in Fr and Fq: 2^20 random pairs, every pair of 0,
    1, p - 1 and R mod p, and 64 pairs whose product needs the final
    subtraction; the edge rows also against the host's integers."""
    from plonkish_tpu_torch.fields import limb
    from plonkish_tpu_torch.fields.spec import BN254_FQ, BN254_FR
    from plonkish_tpu_torch.kernels import probe as kprobe

    t0 = time.time()
    rng = random.Random(19)
    for spec in (BN254_FR, BN254_FQ):
        n = 1 << 20
        a, b = rand_field(torch, spec, n, gen), rand_field(torch, spec, n, gen)
        edge = [0, 1, spec.p - 1, (1 << 256) % spec.p]
        pairs = [(x, y) for x in edge for y in edge] + final_subtraction_pairs(spec, 64, rng)
        a[: len(pairs)] = limb.from_ints([x for x, _ in pairs], "cuda")
        b[: len(pairs)] = limb.from_ints([y for _, y in pairs], "cuda")
        a, b = a.contiguous(), b.contiguous()
        got = kprobe.mont_mul_chain_cuda(spec, a, b, 1, "ptx")
        want = kprobe.mont_mul_chain_cuda(spec, a, b, 1, "u32")
        if not torch.equal(got, want):
            bad = int((got != want).any(dim=1).sum())
            fail(f"the PTX product differs from fe_mul over {spec.name} on {bad} of {n} pairs")
        r_inv = pow(1 << 256, -1, spec.p)
        host = [x * y * r_inv % spec.p for x, y in pairs]
        if limb.to_ints(got[: len(pairs)].cpu()) != host:
            fail(f"the PTX product differs from the host's integers over {spec.name}")
        ops = kprobe.field_ops_cuda(spec, a, b)
        for j, what in ((0, "sum"), (2, "difference"), (4, "negation")):
            if not torch.equal(ops[:, j], ops[:, j + 1]):
                fail(f"the PTX {what} differs from field.cuh's over {spec.name}")
        sums = limb.to_ints(ops[: len(edge) ** 2, 0].cpu())
        diffs = limb.to_ints(ops[: len(edge) ** 2, 2].cpu())
        if (sums != [(x + y) % spec.p for x, y in pairs[: len(edge) ** 2]]
                or diffs != [(x - y) % spec.p for x, y in pairs[: len(edge) ** 2]]):
            fail(f"the PTX sum or difference differs from the host's integers over {spec.name}")
    log(f"[kernels] PTX product, sum and difference (field_ptx.cuh) against fe_mul, fe_add, "
        f"fe_sub and fe_neg over Fr and Fq: 2^20 pairs each, 16 edge pairs and 64 needing the "
        f"product's final subtraction among them: 0 mismatches ({time.time() - t0:.1f}s)")


def check_field_convert(torch, gen):
    """limb.from_mont and limb.to_mont on the card (csrc/convert.cu) against
    the plain product by their constant, in Fr and Fq at 2^20: random values
    below p with 0, 1, p - 1, R mod p and R^2 mod p first, to_mont also on
    values up to 2^256 - 1; the edge rows against the host's integers; then
    from_mont timed beside its byte bound (roofline.convert_work)."""
    from plonkish_tpu_torch import roofline
    from plonkish_tpu_torch.fields import limb
    from plonkish_tpu_torch.fields.spec import BN254_FQ, BN254_FR
    from plonkish_tpu_torch.kernels import LAUNCHES

    t0 = time.time()
    n = 1 << 20
    for spec in (BN254_FR, BN254_FQ):
        x = rand_field(torch, spec, n, gen)
        edge = [0, 1, spec.p - 1, (1 << 256) % spec.p, (1 << 512) % spec.p]
        x[: len(edge)] = limb.from_ints(edge, "cuda")
        wide = x.clone()
        wide[:3] = limb.from_ints([(1 << 256) - 1, spec.p, 2 * spec.p + 1], "cuda")
        for name, convert, k, inp in (("from_mont", limb.from_mont, 1, x),
                                      ("to_mont", limb.to_mont, (1 << 512) % spec.p, wide)):
            before = LAUNCHES["field_convert"]
            got = convert(spec, inp)
            if LAUNCHES["field_convert"] != before + 1:
                fail(f"limb.{name} over {spec.name} did not launch csrc/convert.cu once")
            want = limb.mont_mul(spec, inp, limb.from_ints([k], "cuda")[0])
            if not torch.equal(got, want):
                bad = int((got != want).any(dim=1).sum())
                fail(f"the conversion {name} differs from its plain version over {spec.name} "
                     f"on {bad} of {n} elements")
            vals = limb.to_ints(inp[: len(edge)].cpu())
            if limb.to_ints(got[: len(edge)].cpu()) != [v * k * pow(1 << 256, -1, spec.p) % spec.p
                                                       for v in vals]:
                fail(f"the conversion {name} differs from the host's integers over {spec.name}")
    x = rand_field(torch, BN254_FR, n, gen)
    ms = cuda_ms(torch, lambda: limb.from_mont(BN254_FR, x), 50)
    one = limb.from_ints([1], "cuda")[0]
    plain_ms = cuda_ms(torch, lambda: limb.mont_mul(BN254_FR, x, one), 3)
    b_ms, b_by, _ = roofline.bound_ms(*roofline.convert_work(n))
    log(f"[kernels] the Montgomery conversion (csrc/convert.cu) against the plain product, "
        f"both directions over Fr and Fq at 2^20 with edge rows: 0 mismatches; from_mont at "
        f"2^20 {ms:.4f} ms (plain {plain_ms:.3f} ms, bound {b_ms:.4f} ms by {b_by}; "
        f"{100 * b_ms / ms:.1f} % of it) ({time.time() - t0:.1f}s)")


def check_brakedown_kernels(torch, gen, reset_launches):
    """Brakedown's commit at k = 20, Spec 6 (32 rows of 2^15, a codeword of
    56,361) on its main path, MultilinearBrakedown.commit on the card, its
    launches counted from 0: one of csrc/brakedown.cu a matrix of the code
    and the base case, one conversion (csrc/convert.cu), one of
    csrc/merkle.cu for the columns and one a tree level.  Its rows and every
    node of its tree against the plain versions (each matrix's dot_plain,
    keccak_device's hashes) of the same evaluations; whole commits at k = 3,
    5 and 8 (both specs) equal to the CPU's; then each kernel timed beside
    its bound (roofline.brakedown_encode_work, roofline.merkle_work) and its
    plain version.  Returns the kernels line's rows of the two kernels and
    the commit's launches, the path "brakedown" that the rows read."""
    import numpy as np

    from plonkish_tpu_torch import roofline
    from plonkish_tpu_torch.fields import limb
    from plonkish_tpu_torch.fields.spec import BN254_FR
    from plonkish_tpu_torch.kernels import LAUNCHES
    from plonkish_tpu_torch.pcs import brakedown
    from plonkish_tpu_torch.pcs.brakedown_code import BRAKEDOWN_SPEC_6, BRAKEDOWN_SPEC_TEST
    from plonkish_tpu_torch.poly.multilinear import MLPoly

    t0 = time.time()
    pcs = brakedown.MultilinearBrakedown(BN254_FR, BRAKEDOWN_SPEC_6, device="cuda")
    pp = pcs.setup(1 << K_FULL, 1, random.Random(1))
    code, rows = pp.code, pp.num_rows
    t_code = time.time() - t0
    evals = rand_field(torch, BN254_FR, 1 << K_FULL, gen)
    reset_launches()
    comm = pcs.commit(pp, MLPoly(BN254_FR, evals))
    launches = {name: LAUNCHES[name] for name in ("brakedown_dot", "keccak_messages",
                                                  "field_convert")}
    depth = (code.codeword_len - 1).bit_length()
    want = {"brakedown_dot": len(code.a) + len(code.b) + 1, "keccak_messages": 1 + depth,
            "field_convert": 1}
    if launches != want:
        fail(f"Brakedown's commit at k = {K_FULL} made the launches {launches}, not {want}: "
             "one of csrc/brakedown.cu a matrix, one conversion, one of csrc/merkle.cu for the "
             "columns and one a level")
    batch = evals.reshape(rows, code.row_len, limb.L)

    def plain_dot(mat, x, out):
        out.copy_(mat.dot_plain(x))

    def plain_tree(canon):
        nodes = brakedown._column_hashes_plain(canon)
        brakedown._merkle_levels_plain(nodes)
        return nodes

    enc_plain_ms, columns = timed_once(torch, lambda: code.encode_columns(batch, dot=plain_dot))
    canon = limb.from_mont(BN254_FR, columns)
    del columns
    hash_plain_ms, nodes = timed_once(torch, lambda: plain_tree(canon))
    want_rows = canon.transpose(0, 1).cpu().numpy()
    if not np.array_equal(comm.rows, want_rows):
        bad = int((comm.rows != want_rows).any(axis=2).sum())
        fail(f"Brakedown's commit at k = {K_FULL} differs from the plain encoding on {bad} "
             "codeword elements")
    tree = nodes.cpu().numpy().view(np.uint8)
    if comm.root != tree[-1].tobytes() or not np.array_equal(comm.intermediate_hashes.nodes,
                                                             tree[:-1]):
        bad = int((comm.intermediate_hashes.nodes != tree[:-1]).any(axis=1).sum())
        fail(f"Brakedown's commit at k = {K_FULL} differs from the plain hashes on {bad} of "
             f"{tree.shape[0] - 1} nodes, or on the root")
    n_nodes = tree.shape[0]
    del want_rows, tree, nodes
    # whole commits at small k (one row, tiny matrices) equal the CPU's
    for k in (3, 5, 8):
        for bspec in (BRAKEDOWN_SPEC_6, BRAKEDOWN_SPEC_TEST):
            small = rand_field(torch, BN254_FR, 1 << k, gen)
            comms = []
            for dev in ("cuda", "cpu"):
                small_pcs = brakedown.MultilinearBrakedown(BN254_FR, bspec, device=dev)
                small_pp = small_pcs.setup(1 << k, 1, random.Random(k))
                comms.append(small_pcs.commit(small_pp, MLPoly(BN254_FR, small.to(dev))))
            card, host = comms
            if (card.root != host.root or not np.array_equal(card.rows, host.rows)
                    or list(card.intermediate_hashes) != list(host.intermediate_hashes)):
                fail(f"a Brakedown commit at k = {k} (lambda {bspec.lambda_}) on the card differs "
                     f"from the CPU's")
    enc_ms = cuda_ms(torch, lambda: code.encode_columns(batch), 10)
    hash_ms = cuda_ms(torch, lambda: brakedown._merkle_levels(brakedown._column_hashes(canon)), 10)
    out = []
    for name, source, replaces, ms, plain_ms, work in (
        ("brakedown_dot", "plonkish_tpu_torch/csrc/brakedown.cu",
         "plonkish_tpu/pcs/brakedown_code.py:159", enc_ms, enc_plain_ms,
         roofline.brakedown_encode_work(code, rows)),
        ("keccak_messages", "plonkish_tpu_torch/csrc/merkle.cu",
         "plonkish_tpu/pcs/brakedown.py:341", hash_ms, hash_plain_ms,
         roofline.merkle_work(code.codeword_len, rows)),
    ):
        b_ms, b_by, _ = roofline.bound_ms(*work)
        out.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": 0, "max_abs_err": 0, "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": None, "path": "brakedown", "counter": name,
        })
        log(f"[kernels] {name} ({source}) at k = {K_FULL}: {ms:.3f} ms (plain {plain_ms:.1f} "
            f"ms, bound {b_ms:.3f} ms by {b_by}, {100 * b_ms / ms:.1f} %), "
            f"{launches[name]} launches in the commit")
    log(f"[kernels] Brakedown's commit at k = {K_FULL} (Spec 6, {rows} x {code.row_len}, "
        f"codeword {code.codeword_len}; the code drawn in {t_code:.1f}s) on its main path: the "
        f"launches {launches}, its rows and {n_nodes - 1} nodes and "
        f"root equal to the plain versions', the commits at k = 3, 5 and 8 equal to the "
        f"CPU's ({time.time() - t0:.1f}s)")
    return out, launches


def start_native_build():
    """The native host runtime (ops/field_cpp.py, g++), the bench's
    baseline, built in a thread from phase 1 on; phase 12 waits for it."""
    from plonkish_tpu_torch.ops import field_cpp

    result = {}

    def run():
        t0 = time.time()
        try:
            result["path"] = field_cpp.build_native()
        except Exception as e:  # noqa: BLE001 - reported where phase 12 waits for it
            result["error"] = e
        result["seconds"] = time.time() - t0

    thread = threading.Thread(target=run, name="native build")
    thread.start()
    return thread, result


def fs_round_case(torch, spec, degree, pending_bytes, rng, device="cuda"):
    """K6's Evaluations-round buffers: a sponge seeded from a host transcript
    with `pending_bytes` buffered (a permutation already run), random K3
    sums, claimed sum and offset, and round 2's identity rows."""
    from plonkish_tpu_torch.fields import limb
    from plonkish_tpu_torch.fields.host import Fp
    from plonkish_tpu_torch.piop import fiat_shamir as fs
    from plonkish_tpu_torch.piop.sum_check import identity_stack
    from plonkish_tpu_torch.utils.transcript import Keccak256Transcript

    tr = Keccak256Transcript(spec)
    for _ in range(5):
        tr.common_field_element(Fp(rng.randrange(spec.p), spec))
    tr.squeeze_challenge()  # 32 bytes pending
    tr.state.update(bytes(rng.getrandbits(8) for _ in range((pending_bytes - 32) % 136)))
    lanes, pending = tr.export_sponge()
    assert len(pending) == pending_bytes

    def mont(n):
        return limb.from_ints([spec.to_mont(rng.randrange(spec.p)) for _ in range(n)], device)

    return {
        "sums": mont(degree), "scal": mont(2),
        "sponge": fs.DeviceSponge.from_host(lanes, pending).words().to(device),
        "fixed": fs.lagrange_constants(spec, degree, device),
        "rows": identity_stack(spec, [3, 1, 0, 0], device)[2:4].contiguous(),
    }


def fs_round_outputs(torch, spec, degree, case, plain):
    """K6 (or its plain version) on copies of `case`: every buffer it writes."""
    from plonkish_tpu_torch.kernels import fiat_shamir as kfs
    from plonkish_tpu_torch.piop import fiat_shamir as fs

    b = {k: v.clone() for k, v in case.items()}
    dev = b["sums"].device
    out = torch.zeros((degree + 2, 8), dtype=torch.int32, device=dev)
    chm = torch.zeros(8, dtype=torch.int32, device=dev)
    ids = torch.zeros((3, 8), dtype=torch.int32, device=dev)
    args = (b["sums"], b["scal"], b["sponge"], b["fixed"], b["rows"], out, chm, ids)
    if plain:
        fs.round_message_plain(spec, degree, *args)
    else:
        kfs.round_cuda(spec, degree, *args)
    return {"scal": b["scal"], "sponge": b["sponge"], "out": out, "ch_mont": chm, "ids": ids}


def fs_coeff_outputs(torch, spec, v, scal, sponge, c0_base, plain):
    from plonkish_tpu_torch.kernels import fiat_shamir as kfs
    from plonkish_tpu_torch.piop import fiat_shamir as fs

    scal, sponge = scal.clone(), sponge.clone()
    out = torch.zeros((4, 8), dtype=torch.int32, device=v.device)
    chm = torch.zeros(8, dtype=torch.int32, device=v.device)
    if plain:
        fs.coeff_message_plain(spec, v, scal, sponge, c0_base, out, chm)
    else:
        kfs.coeff_cuda(spec, v, scal, sponge, c0_base, out, chm)
    return {"scal": scal, "sponge": sponge, "out": out, "ch_mont": chm}


def phase2_round_message(torch):
    """K6 against its plain version on the card: both fields, degrees 1, 2,
    3, 5, 9 (the widest tape of phase 1) and 32 (the widest K6 takes: lane 0
    holds two terms; from 0 and 128 pending bytes), sponges entered with 0,
    32, 80, 120 and 128 pending bytes (absorbs that straddle the 136-byte
    rate, and one whose first lane fills it), and ten chained rounds, each from the last one's sponge, sum,
    offset and identity rows; the Coefficients round from each chained
    sponge."""
    from plonkish_tpu_torch.fields import limb
    from plonkish_tpu_torch.fields.spec import BN254_FQ, BN254_FR
    from plonkish_tpu_torch.piop.sum_check import identity_stack

    t0 = time.time()
    rng = random.Random(12)
    cases = 0
    for spec in (BN254_FR, BN254_FQ):
        for degree in FS_DEGREES:
            for pending in FS_PENDING if degree < 32 else FS_WIDEST_PENDING:
                case = fs_round_case(torch, spec, degree, pending, rng)
                got = fs_round_outputs(torch, spec, degree, case, plain=False)
                want = fs_round_outputs(torch, spec, degree, case, plain=True)
                for key in got:
                    if not torch.equal(got[key], want[key]):
                        fail(f"K6 fs_round_message differs from its plain version over "
                             f"{spec.name}, degree {degree}, {pending} bytes pending: {key}")
                cases += 1
        degree = 5
        state = fs_round_case(torch, spec, degree, 80, rng)
        stack = identity_stack(spec, list(range(10)), "cuda")
        for r in range(10):
            state["sums"] = limb.from_ints(
                [spec.to_mont(rng.randrange(spec.p)) for _ in range(degree)], "cuda")
            state["rows"] = stack[r: r + 2].contiguous()
            got = fs_round_outputs(torch, spec, degree, state, plain=False)
            want = fs_round_outputs(torch, spec, degree, state, plain=True)
            for key in got:
                if not torch.equal(got[key], want[key]):
                    fail(f"K6 fs_round_message differs from its plain version over {spec.name} "
                         f"at chained round {r}: {key}")
            v = limb.from_ints([spec.to_mont(rng.randrange(spec.p)) for _ in range(2)], "cuda")
            c0 = limb.from_ints([spec.to_mont(rng.randrange(spec.p))], "cuda")[0]
            cg = fs_coeff_outputs(torch, spec, v, got["scal"][0], got["sponge"], c0, plain=False)
            cw = fs_coeff_outputs(torch, spec, v, got["scal"][0], got["sponge"], c0, plain=True)
            for key in cg:
                if not torch.equal(cg[key], cw[key]):
                    fail(f"K6 fs_coeff_message differs from its plain version over {spec.name} "
                         f"at chained round {r}: {key}")
            state.update(sponge=got["sponge"], scal=got["scal"])
            cases += 2
    log(f"[kernels] K6 round message over Fr and Fq, degrees {FS_DEGREES}, sponges with "
        f"{FS_PENDING} bytes pending ({FS_WIDEST_PENDING} at degree 32), ten chained rounds "
        f"with the Coefficients round beside each: 0 mismatches in {cases} cases "
        f"({time.time() - t0:.1f}s)")


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

    times["prove"], main_path, proof, _ = prove_and_check(
        torch, f"k={k}", backend, pp, vp, circuit, BN254_FR, launches, reset_launches,
        must=PROVER_KERNELS)
    check_fused_launches(f"k={k}", main_path, 1)
    times["prove_per_round"], per_round_path = prove_again(
        torch, k, backend, pp, circuit, proof, launches, reset_launches,
        "PLONKISH_TPU_FUSED_ROUNDS", "K3, K6 and K4 launched each round")
    check_per_round_launches(f"k={k} PLONKISH_TPU_FUSED_ROUNDS=0", per_round_path, k)
    times["prove_host_fs"], host_path = prove_again(
        torch, k, backend, pp, circuit, proof, launches, reset_launches,
        "PLONKISH_TPU_DEVICE_FS", "the host transcript")
    if any(host_path[name] for name in FS_KERNELS + FUSED_KERNELS):
        fail(f"[k={k}] PLONKISH_TPU_DEVICE_FS=0 launched K6 or K7: {json.dumps(host_path)}")
    log(f"[k={k}] times {json.dumps({n: round(v, 4) for n, v in times.items()})}")
    return ({"kzg": main_path, "kzg_per_round": per_round_path},
            {"pp": pp, "vp": vp, "k": k, "circuit": (ci, circuit), "param": param,
             "proof": proof, "prove_s": times["prove"], "srs_path": srs_path})


def prove_again(torch, k, backend, pp, circuit, proof, launches, reset_launches, flag, what):
    """The prove again with the environment flag `flag` at 0, timed right
    after the default prove: its proof must equal that one byte for byte.
    Returns its seconds and its launches."""
    from plonkish_tpu_torch.fields.spec import BN254_FR
    from plonkish_tpu_torch.utils.transcript import Keccak256Transcript

    saved = os.environ.get(flag)
    os.environ[flag] = "0"
    try:
        reset_launches()
        tr = Keccak256Transcript(BN254_FR)
        torch.cuda.synchronize()
        t0 = time.time()
        backend.prove(pp, circuit, tr)
        torch.cuda.synchronize()
        prove_s = time.time() - t0
    finally:
        if saved is None:
            os.environ.pop(flag)
        else:
            os.environ[flag] = saved
    path = dict(launches)
    if tr.into_proof() != proof:
        fail(f"[k={k}] the proof with {flag}=0 differs from the default prove's")
    log(f"[k={k}] prove with {flag}=0 ({what}) {prove_s:.3f}s, proof equal to the default "
        f"prove's; kernel launches {json.dumps(path)}")
    return prove_s, path


def check_fused_launches(tag, path, sum_checks):
    """A default prove's launches: K7's grid rounds and its tail once each for
    each of its `sum_checks` Evaluations sum-checks (every one here starts
    above the tail's handover), and, with K7 from the first round
    (piop/sum_check.py FUSED_MAX_PAIRS None), no K3 and no K6 Evaluations
    round."""
    from plonkish_tpu_torch.piop import sum_check as sc

    for name in FUSED_KERNELS:
        if path[name] != sum_checks:
            fail(f"[{tag}] K7's {name} launched {path[name]} times, not once for each of the "
                 f"{sum_checks} Evaluations sum-checks")
    if sc.FUSED_MAX_PAIRS is None and any(path[name] for name in ROUND_KERNELS):
        fail(f"[{tag}] K3 or K6's Evaluations round launched though K7 takes every round: "
             f"{json.dumps(path)}")


def check_per_round_launches(tag, path, rounds):
    """A prove whose Evaluations sum-check runs `rounds` rounds launched one by
    one: K3 and K6's Evaluations round once a round, every per-round kernel
    launched, and no K7."""
    if path["sumcheck_round"] != rounds or path["fs_round_message"] != rounds:
        fail(f"[{tag}] K3 and K6 did not launch once for each of the {rounds} rounds: "
             f"{json.dumps(path)}")
    for name in PER_ROUND_KERNELS:
        if path[name] <= 0:
            fail(f"[{tag}] kernel {name} was not launched")
    if any(path[name] for name in FUSED_KERNELS):
        fail(f"[{tag}] K7 was launched where the rounds run one by one")


# ------------------------------------------------------ 5 kernel timing

def phase5_timing(torch, shapes, paths):
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
    one = limb.from_ints([1], "cuda")[0]
    cv_ms = cuda_ms(torch, lambda: limb.from_mont(BN254_FR, scalars), 20)
    cv_plain_ms, cv_plain = timed_once(torch, lambda: limb.mont_mul(BN254_FR, scalars, one))
    cv_err = 0 if torch.equal(limb.from_mont(BN254_FR, scalars), cv_plain) else 1
    del cv_plain
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
    # K5 at one element, in a CUDA graph: one product's latency (16 deep less
    # the launch with no product, over 16), which K6's latency bound is read
    # against
    one_a, one_b = pa[:1].contiguous(), pb[:1].contiguous()
    one_ms = {c: graph_ms(torch, lambda: kprobe.mont_mul_chain_cuda(
        BN254_FR, one_a, one_b, c, "u32", 1, 32)) for c in (0, pchain)}
    product_s = (one_ms[pchain] - one_ms[0]) / pchain * 1e-3
    one_ptx = {c: graph_ms(torch, lambda: kprobe.mont_mul_chain_cuda(
        BN254_FR, one_a, one_b, c, "ptx", 1, 32)) for c in (0, pchain)}
    product_ptx_s = (one_ptx[pchain] - one_ptx[0]) / pchain * 1e-3
    log(f"[timing] K5 at one element: {pchain} deep {one_ms[pchain] * 1e3:.3f} us, no product "
        f"{one_ms[0] * 1e3:.3f} us (the launch floor): one product's latency "
        f"{product_s * 1e9:.1f} ns (fe_mul), {product_ptx_s * 1e9:.1f} ns (the PTX product, "
        f"{pchain} deep {one_ptx[pchain] * 1e3:.3f} us); the PTX product "
        f"{peaks['fe_mul_ptx_per_s'] / 1e9:.3f} G/s against fe_mul's "
        f"{peaks['fe_mul_per_s'] / 1e9:.3f} G/s")
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
    fs_rows = timing_round_message(torch, state.degree, peaks, paths, product_s,
                                   one_ms[0])
    # K7's least time reads a product's latency at the faster product's
    fused_rows = timing_fused(torch, state, prover, peaks, paths, min(product_s, product_ptx_s))

    rows_out = []
    # each row's launches are read on the path that runs its kernel: the
    # default prove, the prove with PLONKISH_TPU_FUSED_ROUNDS=0 (K3 and K6's
    # Evaluations round, which K7 takes on the default path), the harness (K5)
    for name, path, source_file, replaces, ms, plain_ms, err, work in (
        ("msm_bucket_sums", "kzg", "plonkish_tpu_torch/csrc/msm.cu",
         "plonkish_tpu/pallas/msm.py:46", k1_ms, k1_plain_ms, k1_err,
         roofline.bucket_sums_work(n, m, unique)),
        ("msm_window_sums", "kzg", "plonkish_tpu_torch/csrc/msm.cu",
         "plonkish_tpu/pallas/msm.py:119", k2_ms, k2_plain_ms, k2_err,
         roofline.window_sums_work(w, nb, c)),
        ("sumcheck_round", "kzg_per_round", "plonkish_tpu_torch/csrc/sumcheck.cuh",
         "plonkish_tpu/pallas/sumcheck.py:159", k3_ms, k3_plain_ms, k3_err,
         roofline.round_work(t_count, pairs, state.degree, n_mul)),
        ("sumcheck_fold", "kzg", "plonkish_tpu_torch/csrc/sumcheck.cu",
         "plonkish_tpu/pallas/sumcheck.py:225", k4_ms, k4_plain_ms, k4_err,
         roofline.fold_work(t_count, pairs)),
        ("mont_mul_chain", "harness", "plonkish_tpu_torch/csrc/probe.cu",
         "scripts/validate_pallas_tpu.py:253", k5_ms, k5_plain_ms, k5_err,
         roofline.chain_work(pn, pchain)),
        ("field_convert", "kzg", "plonkish_tpu_torch/csrc/convert.cu",
         "plonkish_tpu_torch/fields/limb.py from_mont (plain torch)", cv_ms, cv_plain_ms,
         cv_err, roofline.convert_work(n)),
    ):
        if err:
            fail(f"{name} differs from its plain version at the k={k} shapes")
        # the probe cannot be its own bound: K5 is held to the assumed rate
        own = name == "mont_mul_chain"
        b_ms, b_by, b_src = roofline.bound_ms(*work, None if own else peaks)
        rows_out.append({
            "name": name, "route": "cuda", "source": source_file, "replaces": replaces,
            "launches": 0, "max_abs_err": 0, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None, "path": path, "counter": name,
        })
        extra = f", f32 variant {k5_f32_ms:.3f} ms" if own else ""
        count = (f"{paths[path][name]} launches in the {path} prove" if path in paths
                 else "launches read on the harness path")
        log(f"[timing] {name}: {ms:.3f} ms{extra} (plain {plain_ms:.1f} ms, bound "
            f"{b_ms:.3f} ms by {b_by} at the {b_src} rate), {count}")
    return rows_out + fs_rows + fused_rows + new_rows


def timing_round_message(torch, degree, peaks, paths, product_s, floor_ms):
    """K6 at the main path's shapes (the zero-check's degree over Fr, its
    sponge in the steady state of 32 bytes pending; the batch open's
    Coefficients round), each launch on the buffers the last one advanced,
    timed in a CUDA graph (and launched one by one, which times the host's
    enqueue), against its plain version once on the same inputs, beside its latency
    bound (roofline.fs_latency_ms at `product_s`, one product's latency)
    and the launch floor (K5 at one element with no product).  Rows of the
    kernels line; their launches are read on the path that runs them."""
    from plonkish_tpu_torch import roofline
    from plonkish_tpu_torch.fields import limb
    from plonkish_tpu_torch.fields.spec import BN254_FR
    from plonkish_tpu_torch.kernels import fiat_shamir as kfs

    spec = BN254_FR
    rng = random.Random(13)
    case = fs_round_case(torch, spec, degree, 32, rng)
    out = torch.zeros((degree + 2, 8), dtype=torch.int32, device="cuda")
    chm = torch.zeros(8, dtype=torch.int32, device="cuda")
    ids = torch.zeros((3, 8), dtype=torch.int32, device="cuda")
    bufs = {k: v.clone() for k, v in case.items()}
    round_ms = graph_ms(torch, lambda: kfs.round_cuda(
        spec, degree, bufs["sums"], bufs["scal"], bufs["sponge"], bufs["fixed"], bufs["rows"],
        out, chm, ids))
    round_host_ms = cuda_ms(torch, lambda: kfs.round_cuda(
        spec, degree, bufs["sums"], bufs["scal"], bufs["sponge"], bufs["fixed"], bufs["rows"],
        out, chm, ids), 200)
    got = fs_round_outputs(torch, spec, degree, case, plain=False)
    round_plain_ms, want = timed_once(
        torch, lambda: fs_round_outputs(torch, spec, degree, case, plain=True))
    round_err = 0 if all(torch.equal(got[key], want[key]) for key in got) else 1
    in_words = degree * 8 + 16 + kfs.SPONGE_WORDS + 2 * (degree + 1) * 8 + 48
    out_words = 16 + kfs.SPONGE_WORDS + (degree + 2) * 8 + 8 + 24
    round_work = roofline.fs_message_work(roofline.fs_round_products(degree),
                                          roofline.fs_permutations(32, degree + 1),
                                          in_words, out_words)

    v = limb.from_ints([spec.to_mont(rng.randrange(spec.p)) for _ in range(2)], "cuda")
    c0 = limb.from_ints([spec.to_mont(rng.randrange(spec.p))], "cuda")[0]
    scal, sponge = case["scal"][0].contiguous(), case["sponge"]
    s2, sp2 = scal.clone(), sponge.clone()
    cout = torch.zeros((4, 8), dtype=torch.int32, device="cuda")
    coeff_ms = graph_ms(torch, lambda: kfs.coeff_cuda(spec, v, s2, sp2, c0, cout, chm))
    coeff_host_ms = cuda_ms(torch, lambda: kfs.coeff_cuda(spec, v, s2, sp2, c0, cout, chm), 200)
    cg = fs_coeff_outputs(torch, spec, v, scal, sponge, c0, plain=False)
    coeff_plain_ms, cw = timed_once(
        torch, lambda: fs_coeff_outputs(torch, spec, v, scal, sponge, c0, plain=True))
    coeff_err = 0 if all(torch.equal(cg[key], cw[key]) for key in cg) else 1
    coeff_work = roofline.fs_message_work(roofline.FS_COEFF_PRODUCTS,
                                          roofline.fs_permutations(32, 3),
                                          16 + 8 + kfs.SPONGE_WORDS + 8,
                                          8 + kfs.SPONGE_WORDS + 32 + 8)
    round_perms = roofline.fs_permutations(32, degree + 1)
    round_latency = roofline.fs_latency_ms(
        round_perms, roofline.fs_round_latency_products(degree), product_s)
    coeff_latency = roofline.fs_latency_ms(
        roofline.fs_permutations(32, 3), roofline.FS_COEFF_LATENCY_PRODUCTS, product_s)
    rows = []
    for name, path, replaces, ms, host_ms, plain_ms, err, work, latency in (
        ("fs_round_message", "kzg_per_round", "plonkish_tpu/piop/fiat_shamir.py:314", round_ms,
         round_host_ms, round_plain_ms, round_err, round_work, round_latency),
        ("fs_coeff_message", "kzg", "plonkish_tpu/piop/fiat_shamir.py:396", coeff_ms,
         coeff_host_ms, coeff_plain_ms, coeff_err, coeff_work, coeff_latency),
    ):
        if err:
            fail(f"K6 {name} differs from its plain version at the main path's shapes")
        # the row's bound is the latency of the shortest dependent chain of
        # operations, far above their count over the card's rate
        rate_ms, _, b_src = roofline.bound_ms(*work, peaks)
        rows.append({
            "name": name, "route": "cuda", "source": "plonkish_tpu_torch/csrc/fiat_shamir.cuh",
            "replaces": replaces, "launches": 0, "max_abs_err": 0, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": latency, "bound_by": "operations",
            "library_ms": None, "path": path, "counter": name,
        })
        log(f"[timing] K6 {name}: {ms * 1e3:.2f} us a launch in a CUDA graph, "
            f"{host_ms * 1e3:.2f} us launched one by one from Python (plain {plain_ms:.1f} ms, "
            f"bound {latency * 1e3:.3f} us by the latency of its shortest dependent chain, "
            f"{100 * latency / ms:.1f} % of it; its operations over the {b_src} rate "
            f"{rate_ms * 1e3:.4f} us; launch floor {floor_ms * 1e3:.3f} us), "
            f"{paths[path][name]} launches in the {path} prove")
    return rows


def timing_fused(torch, state, prover, peaks, paths, product_s):
    """K7 at the k-variable zero-check's shapes (phase 5's vanilla state over
    Fr; the sponge in the steady state of 32 bytes pending), timed with CUDA
    events, each run on a copy of the state made before its events, in turns
    with the same rounds launched one by one (K3 -> K6 -> K4): the rounds
    from round r to the last, for every r.  All k rounds give K7's time
    beside the per-round device time and K7's bound
    (roofline.fused_bound_ms); the difference of two neighbouring runs, a
    round's own time on each path, without the host's work before the first
    launch, which decides the handover (K7's round 0 no slower than 1.05
    times K3 + K6 + K4's: every round; else the largest pair count at which
    it is no slower; else 2^12); the 13 rounds from 2^12 pairs.  Then K7's
    two kernels apart, each timed and held against its plain version once
    (the tail from the plain grid rounds' state), and all its rounds against
    the two plain parts run one after the other: the grid rounds' and the
    tail's rows of the kernels line, each with its bound."""
    from plonkish_tpu_torch import roofline
    from plonkish_tpu_torch.kernels import sumcheck as ksc
    from plonkish_tpu_torch.kernels import sumcheck_gen
    from plonkish_tpu_torch.piop import fiat_shamir as fs
    from plonkish_tpu_torch.piop import sum_check as sc
    from plonkish_tpu_torch.piop.tape import OP_MUL

    spec, k, degree, tape = state.spec, state.num_vars, state.degree, prover.tape
    base = state.stacked
    t_count, pairs = base.shape[0], base.shape[1] // 2
    n_mul = int((prover.instrs[:, 0] == OP_MUL).sum())
    bufs = fused_buffers(torch, spec, degree, k, 32, random.Random(17))
    tape_args = (prover.instrs, prover.consts, tape.num_regs, tape.out_reg, degree)

    def fused(stacked, first, b, rounds=None):
        ksc.fused_rounds_cuda(spec, stacked, *tape_args, *(b[n] for n in FUSED_ORDER), first,
                              rounds or k - first)

    def per_round(stacked, first, b):
        for r in range(first, k):
            sums = ksc.sumcheck_round_cuda(spec, stacked, *tape_args, b["ids"])
            fs.round_message(spec, degree, sums, b["scal"], b["sponge"], b["fixed"],
                             b["rows"][r: r + 2], b["out"][r], b["ch_mont"], b["ids"])
            stacked = ksc.fold_cuda(spec, stacked, b["ch_mont"])

    def events_ms(fn, stacked, first, reps=3):
        b = {n: v.clone() for n, v in bufs.items()}
        fn(stacked.clone(), first, b)  # warm-up
        total = 0.0
        for _ in range(reps):
            copy = stacked.clone()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            start.record()
            fn(copy, first, b)
            end.record()
            torch.cuda.synchronize()
            total += start.elapsed_time(end)
            del copy
        return total / reps

    # suffix[r] = (K7 ms, per-round ms) of rounds r..k-1, in turns
    suffix = []
    for r in range(k):
        rows = base[:, : base.shape[1] >> r].contiguous()
        per = [events_ms(per_round, rows, r)]
        fus = [events_ms(fused, rows, r) for _ in range(2)]
        per.append(events_ms(per_round, rows, r))
        suffix.append((sum(fus) / 2, sum(per) / 2))
        del rows
    suffix.append((0.0, 0.0))
    own = [(suffix[r][0] - suffix[r + 1][0], suffix[r][1] - suffix[r + 1][1]) for r in range(k)]
    fused_ms, per_round_ms = suffix[0]
    tail = suffix[k - 13]
    ratio0 = own[0][0] / own[0][1]
    if ratio0 <= 1.05:
        handover, rule = None, f"K7's round 0 takes {ratio0:.3f} of K3 + K6 + K4's: every round"
    else:
        fits = [pairs >> r for r, (f, p) in enumerate(own) if f <= p]
        handover = max(fits) if fits else 1 << 12
        rule = (f"K7's round 0 takes {ratio0:.3f} of K3 + K6 + K4's: the handover at "
                f"{handover} pairs")
    log(f"[timing] K7, the k={k} zero-check's {k} rounds in its two launches: "
        f"{fused_ms:.3f} ms; launched one by one (K3 -> K6 -> K4) {per_round_ms:.3f} ms")
    log(f"[timing] K7 each round's own time against K3 + K6 + K4's (the runs from it less "
        f"the runs from the next), ms: {[(round(f, 4), round(p, 4)) for f, p in own]}; "
        f"13 rounds from 2^12 pairs {tail[0]:.3f} ms against {tail[1]:.3f} ms "
        f"({1e3 * tail[0] / 13:.1f} and {1e3 * tail[1] / 13:.1f} us a round)")
    committed = "every round" if sc.FUSED_MAX_PAIRS is None else f"{sc.FUSED_MAX_PAIRS} pairs"
    measured = "every round" if handover is None else f"{handover} pairs"
    log(f"[timing] K7 handover: {rule}; piop/sum_check.py FUSED_MAX_PAIRS holds {committed}"
        f"{'' if committed == measured else ' (this run measured another: see PERF.md)'}")

    # the grid rounds and the tail apart: each against its plain version (the
    # tail from the plain grid rounds' state and buffers), both together too
    kern = sumcheck_gen.kernel(*tape_of((base, *tape_args, spec)))
    plan = ksc.tail_plan(kern.tail, t_count, degree)
    g = sum(1 for j in range(k) if pairs >> j > plan[2])
    case = (base, *tape_args, spec)
    grid_plain_ms, want_grid = timed_once(
        torch, lambda: fused_outputs(torch, case, bufs, plain=True, rounds=g))
    got = fused_outputs(torch, case, bufs, plain=False, rounds=g)
    if not all(torch.equal(got[key], want_grid[key]) for key in got):
        fail(f"K7's grid rounds differ from their plain version at the k={k} zero-check")
    tail_case = (want_grid["state"], *tape_args, spec)
    tail_bufs = {n: want_grid[n] for n in FUSED_ORDER}
    tail_plain_ms, want = timed_once(torch, lambda: fused_outputs(
        torch, tail_case, tail_bufs, plain=True, first=g, rounds=k - g))
    got = fused_outputs(torch, tail_case, tail_bufs, plain=False, first=g, rounds=k - g)
    if not all(torch.equal(got[key], want[key]) for key in got):
        fail(f"K7's tail differs from its plain version at the k={k} zero-check")
    got = fused_outputs(torch, case, bufs, plain=False)
    if not all(torch.equal(got[key], want[key]) for key in got):
        fail(f"K7 differs from its plain version at the k={k} zero-check")
    del got, want, want_grid
    grid_ms = events_ms(lambda st, first, b: fused(st, first, b, g), base, 0)
    tail_ms = suffix[g][0]
    latency = roofline.fs_latency_ms(roofline.fs_permutations(32, degree + 1),
                                     roofline.fs_round_latency_products(degree), product_s)
    b_ms, b_by = roofline.fused_bound_ms(t_count, pairs, k, degree, n_mul, latency, peaks)
    grid_b, grid_by = roofline.fused_bound_ms(t_count, pairs, g, degree, n_mul, latency, peaks)
    tail_b, tail_by = roofline.fused_bound_ms(t_count, pairs >> g, k - g, degree, n_mul, latency,
                                              peaks)
    log(f"[timing] K7 sumcheck_fused, all {k} rounds (grid rounds and tail): {fused_ms:.3f} ms "
        f"against {per_round_ms:.3f} ms launched one by one; bound {b_ms:.3f} ms by {b_by} "
        f"({100 * b_ms / fused_ms:.1f} % of it; each round's larger of K3's and K4's bounds and "
        f"K6's chain of {latency * 1e3:.3f} us at a product's {product_s * 1e9:.1f} ns); grid "
        f"kernel {kern.fused.regs} registers, {kern.fused.warps} warps a block, "
        f"{kern.fused.resident} blocks; tail {kern.tail.regs} registers, {kern.tail.warps} warps "
        f"a block, a cluster of {plan[0]} holding {plan[1]} pairs a block, handover {plan[2]} "
        f"pairs")
    log(f"[timing] K7 grid rounds 0..{g - 1}: {grid_ms:.3f} ms (plain {grid_plain_ms:.1f} ms, "
        f"bound {grid_b:.3f} ms by {grid_by}, {100 * grid_b / grid_ms:.1f} %); tail rounds "
        f"{g}..{k - 1}: {tail_ms:.3f} ms, {1e3 * tail_ms / (k - g):.1f} us a round (plain "
        f"{tail_plain_ms:.1f} ms, bound {tail_b:.3f} ms by {tail_by}, "
        f"{100 * tail_b / tail_ms:.1f} %), against {suffix[g][1]:.3f} ms launched one by one; "
        f"{paths['kzg'][FUSED_KERNEL]} and {paths['kzg'][TAIL_KERNEL]} launches in the kzg "
        "prove")
    source = "plonkish_tpu_torch/csrc/sumcheck_fused.cuh"
    replaces = "plonkish_tpu/piop/sum_check.py:573"
    return [{
        "name": FUSED_KERNEL, "route": "cuda", "source": source, "replaces": replaces,
        "launches": 0, "max_abs_err": 0, "ms": grid_ms, "plain_ms": grid_plain_ms,
        "bound_ms": grid_b, "bound_by": grid_by, "library_ms": None, "path": "kzg",
        "counter": FUSED_KERNEL,
    }, {
        "name": TAIL_KERNEL, "route": "cuda", "source": source,
        "replaces": "plonkish_tpu/piop/sum_check.py:609", "launches": 0, "max_abs_err": 0,
        "ms": tail_ms, "plain_ms": tail_plain_ms, "bound_ms": tail_b, "bound_by": tail_by,
        "library_ms": None, "path": "kzg", "counter": TAIL_KERNEL,
    }]


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
    ladder_ms = cuda_ms(torch, lambda: kipa.ladder_cuda(curve, left, right, xi), 3)
    jac = kipa.ladder_cuda(curve, left, right, xi)
    affine_ms = cuda_ms(torch, lambda: kipa.affine_cuda(curve, jac), 5)
    ladder_plain_ms, plain_jac = timed_once(
        torch, lambda: kipa.ladder_plain(curve, left, right, xi))
    affine_plain_ms, fold_plain = timed_once(torch, lambda: kipa.affine_plain(curve, plain_jac))
    # the ladder's points equal the plain ones as affine points; the
    # conversion is exact on the plain ladder's
    ladder_err = 0 if torch.equal(kipa.affine_cuda(curve, jac), fold_plain) else 1
    affine_err = 0 if torch.equal(kipa.affine_cuda(curve, plain_jac), fold_plain) else 1
    del fold_plain, plain_jac, jac
    fold_bound = roofline.bound_ms(*roofline.base_fold_work(curve, half, xi), peaks)[0]
    codes = kipa.digits(curve, xi)
    log(f"[timing] IPA base fold at 2^{k - 1}: {ladder_ms + affine_ms:.3f} ms (ladder "
        f"{ladder_ms:.3f}, affine {affine_ms:.3f}) against the whole fold's bound "
        f"{fold_bound:.3f} ms, {100 * fold_bound / (ladder_ms + affine_ms):.1f} % of it; xi "
        f"{len(codes)} digits, {sum(1 for c in codes if c)} nonzero")

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
         "plonkish_tpu/pcs/ipa.py:157", ladder_ms, ladder_plain_ms, ladder_err,
         roofline.fold_ladder_work(curve, half, xi)),
        ("ipa_fold_affine", "ipa_fold_affine", "plonkish_tpu_torch/csrc/ipa.cu",
         "plonkish_tpu/pcs/ipa.py:157", affine_ms, affine_plain_ms, affine_err,
         roofline.fold_affine_work(curve, half)),
    ):
        if err:
            fail(f"{name} differs from its plain version at the k={k} shapes")
        b_ms, b_by, b_src = roofline.bound_ms(*work, peaks)
        rows_out.append({
            "name": name, "route": "cuda", "source": source_file, "replaces": replaces,
            "launches": 0, "max_abs_err": 0, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            # K3 runs on the IPA path only with the rounds launched one by one
            "path": "ipa_per_round" if counter == "sumcheck_round" else "ipa",
            "counter": counter,
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
    for name in MSM_KERNELS + FUSED_KERNELS + ("mont_mul_chain",):
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

    times["prove"], ipa_path, _, per_round = prove_and_check(
        torch, f"ipa k={k}", backend, pp, vp, circuit, spec, launches, reset_launches,
        must=IPA_KERNELS, warm_env={"PLONKISH_TPU_FUSED_ROUNDS": "0"})
    check_fused_launches(f"ipa k={k}", ipa_path, 1)
    check_per_round_launches(f"ipa k={k} warm-up, PLONKISH_TPU_FUSED_ROUNDS=0", per_round, k)
    log(f"[ipa k={k}] times {json.dumps({n: round(v, 4) for n, v in times.items()})}; the "
        "warm-up with the rounds launched one by one gave the same proof")
    return ipa_path, per_round


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
    spans = [(n, d, s) for n, d, s in timer.phase_trace() if d <= 1]
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
    check_fused_launches(f"fold k={k}", fold_path, 1)  # the decider's sum-check

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
                    must, must_not=(), mesh=None, warm_env=None):
    """A warm-up prove, then a timed prove with its spans, peak device memory
    and kernel launches (each of `must` launched, none of `must_not`, no K3
    built or loaded in the timed prove), and, under `mesh`, the collectives
    of the timed prove; the verifier accepting and a flipped byte rejected.
    With `warm_env` (environment flags), the warm-up proves under those
    flags, its launches are counted and its proof must equal the timed one.
    Returns (prove seconds, launches, proof, the warm-up's launches or None)."""
    from plonkish_tpu_torch.kernels import sumcheck_gen
    from plonkish_tpu_torch.utils import timer
    from plonkish_tpu_torch.utils.transcript import Keccak256Transcript

    t0 = time.time()
    kernels_before = len(sumcheck_gen.BUILDS)
    saved = {name: os.environ.get(name) for name in warm_env or {}}
    os.environ.update(warm_env or {})
    try:
        reset_launches()
        warm_tr = Keccak256Transcript(spec)
        backend.prove(pp, circuit, warm_tr)
        torch.cuda.synchronize()
    finally:
        for name, value in saved.items():
            if value is None:
                os.environ.pop(name)
            else:
                os.environ[name] = value
    warm_path = dict(launches) if warm_env else None
    kernels_warm = len(sumcheck_gen.BUILDS)
    log(f"[{tag}] warm-up prove {time.time() - t0:.2f}s"
        f"{f' with {warm_env}, kernel launches {json.dumps(warm_path)}' if warm_env else ''}; "
        f"K3 kernels loaded in this process {kernels_before} before it, {kernels_warm} after it")

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
    spans = [(n, d, sec) for n, d, sec in timer.phase_trace() if d <= 2]
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
    if warm_env and warm_tr.into_proof() != proof:
        fail(f"[{tag}] the warm-up's proof with {warm_env} differs from the timed prove's")
    return prove_s, path, proof, warm_path


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
    from plonkish_tpu_torch.models.circuits import rand_vanilla_plonk_circuit
    from plonkish_tpu_torch.pcs.univariate_kzg import UnivariateKzg
    from plonkish_tpu_torch.poly import ntt
    from plonkish_tpu_torch.utils import timer

    spec = BN254_FR
    tag = f"univariate k={k}"
    if k == shapes["k"]:
        ci, circuit = shapes["circuit"]
    else:
        t0 = time.time()
        ci, circuit = rand_vanilla_plonk_circuit(spec, k, random.Random(1), random.Random(2))
        log(f"[{tag}] circuit {time.time() - t0:.2f}s")
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
    spans = ", ".join(f"{n} {sec * 1e3:.1f} ms" for n, d, sec in timer.phase_trace() if d == 0)
    log(f"[{tag}] setup {setup_s:.2f}s ({param.powers_of_s_g1.shape[0]} powers), preprocess "
        f"{pre_s:.2f}s ({spans})")
    del param
    prove_and_check(torch, tag, backend, pp, vp, circuit, spec, launches, reset_launches,
                    must=("msm_bucket_sums", "msm_window_sums"),
                    must_not=("sumcheck_round", "sumcheck_fold") + FUSED_KERNELS + FS_KERNELS)
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
        _, path, _, _ = prove_and_check(torch, tag, backend, pp, vp, circuit, spec, launches,
                                        reset_launches, must=PROVER_KERNELS)
        check_fused_launches(tag, path, 1)
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
            # every round's rows are sharded (one rank holds them all, folded
            # to one row only after the last round): K7 takes none
            prove_s, path, proof, _ = prove_and_check(
                torch, f"mesh1 nccl k={k}", HyperPlonk(MultilinearKzg()), shapes["pp"],
                shapes["vp"], circuit, BN254_FR, launches, reset_launches,
                must=PER_ROUND_KERNELS, must_not=FUSED_KERNELS, mesh=mesh)
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
        for name in PER_ROUND_KERNELS + (TAIL_KERNEL,):
            if r["launches"][name] <= 0:
                fail(f"[{tag}] kernel {name} was not launched on the rank's rows")
        # k - 1 sharded rounds one by one, then K7's tail for the last once the
        # rows are gathered (one pair: no grid rounds)
        if (r["launches"][TAIL_KERNEL], r["launches"][FUSED_KERNEL],
                r["launches"]["sumcheck_round"]) != (1, 0, k - 1):
            fail(f"[{tag}] the zero-check's sharded rounds or K7 after the gather did not "
                 f"launch as expected: {json.dumps(r['launches'])}")
        if r["taken"].get("msm", 0) <= 0 or r["taken"].get("sum_check") != 2:
            fail(f"[{tag}] sharded_msm or the sharded sum-checks were not taken: {r['taken']}")
    log(f"[mesh2 gloo k={k}] both ranks' proofs equal phase 4's ({len(want)} bytes)")


# ------------------------------------------------------ 12 device transcript

def phase12_device_fs(torch, k, shapes, native):
    """The device transcript at k on phase 4's circuit and params: (a) the
    zero-check's per-round split with the host transcript and with the
    device one (profile_zero_check), its device rounds enqueued under the
    sync check; (b) the MSM bench (plonkish_tpu_torch.bench) at 2^k, in
    process (after phase 6, whose harness measures the probe's peaks
    itself), whose device point must equal the native one.  Phase 4 proves
    with PLONKISH_TPU_DEVICE_FS=0 beside its device-transcript prove."""
    import contextlib
    import io

    from plonkish_tpu_torch import bench, profile_zero_check

    t0 = time.time()
    prof = profile_zero_check.profile(k, "cuda", shapes["circuit"],
                                      log=lambda line: log(f"[profile k={k}] {line}"),
                                      sync_check=True, pp=shapes["pp"])
    host, dev, fused = prof["host_fs"], prof["device_fs"], prof["fused"]

    def device_split(run):
        return (f"rounds {run['rounds_ms']:.3f} ms (enqueue {run['enqueue_ms']:.3f} under "
                f"set_sync_debug_mode(\"error\"), device {run['device_ms']:.3f}, one transfer "
                f"and replay {run['replay_ms']:.3f}), state init {run['init_ms']:.3f} ms")

    log(f"[profile k={k}] ({time.time() - t0:.1f}s) host transcript: rounds {host['rounds_ms']:.3f} "
        f"ms (message {host['msg_ms']:.3f}, transcript {host['transcript_ms']:.3f}, fold "
        f"{host['fold_ms']:.3f}; K3 {host['k3_ms']:.3f}, K4 {host['k4_ms']:.3f}), state init "
        f"{host['init_ms']:.3f} ms; device transcript, a round at a time: {device_split(dev)}; "
        f"fused (K7): {device_split(fused)}; same challenges and evaluations")

    thread, result = native
    t0 = time.time()
    thread.join()
    if "error" in result:
        fail(f"the native runtime did not build: {result['error']}")
    log(f"[bench] native runtime built in {result['seconds']:.1f}s (waited "
        f"{time.time() - t0:.1f}s)")
    t0 = time.time()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        line = bench.main(["--msm-log2", str(k)])
    log(f"[bench] {out.getvalue().strip()} ({time.time() - t0:.1f}s; the device point equals "
        "the native one)")
    if not line["value"] > 0:
        fail(f"[bench] no throughput: {line}")


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
