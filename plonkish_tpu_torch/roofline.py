"""Roofline accounting for the port: the operations and bytes each kernel
must do, the card's peaks, and the share of them a run achieved (port of
plonkish_tpu/roofline.py).

Unit of work: one 32-bit integer multiply-add.  A Montgomery product of two
8-limb elements (``fe_mul``, csrc/field.cuh) is 128 partial products of
32 x 32 -> 64 bits, two multiply-adds each: ``FE_MUL_IMAD`` = 256.  Carries,
additions and selects are overhead and are not counted, so a share of 100 %
means the card multiplies at its peak with nothing else to do.

Peaks.  The memory rate is the published one of the H100 SXM.  The integer
rate has two sources: the assumed one (SMs x 64 INT32 lanes x clock, half the
published FP32 rate) and the one kernel K5 measures in this process
(``measure_peaks``: products per second of a long ``fe_mul`` chain, times
256).  **A bound is the least time the card could take**, so every bound and
share uses the larger of the two and says which (``imad_rate``).

The counts are the port's algorithms': sorted Pippenger buckets (K1, K2), the
tape-interpreting round kernel (K3), the fold (K4) and the round message
(K6, whose Keccak-f logic operations are counted beside its products, and
whose least time is its shortest dependent chain, ``fs_latency_ms``), the
fused rounds (K7, ``fused_bound_ms``: K3's or K4's bound and K6's chain a
round), the conversion out of or into Montgomery form (``convert_work``); the
IPA base fold's is the work of the design it runs (``base_fold_work``, the sum
of its two kernels' counts), which is not shown to be the least its function
needs.
"""

from __future__ import annotations

import subprocess
from typing import Optional, Tuple

FE_MUL_IMAD = 256  # 128 32x32->64-bit partial products, 2 multiply-adds each
MADD_MULS = 11  # mixed Jacobian addition: 7M + 4S
JADD_MULS = 16  # full Jacobian addition: 11M + 5S
JDBL_MULS = 7  # Jacobian doubling (jac_dbl, csrc/curve.cuh): 2M + 5S
FE_BYTES = 32  # one field element in device memory

# Published figures of one NVIDIA H100 SXM.
PEAKS = {
    "hbm_bytes_per_s": 3.35e12,
    "sm_count": 132,
    "int32_lanes_per_sm": 64,
    "sm_clock_hz": 1.98e9,
}

PROBE_N = 1 << 22  # 64 * 512 * 128 elements, the reference probe's work
PROBE_CHAIN = 16
PROBE_REPS = 5


# ---------------------------------------------------------------------------
# Per-kernel counts: (multiply-adds, bytes)
# ---------------------------------------------------------------------------

def bucket_sums_work(n: int, entries: int, buckets_used: int) -> Tuple[int, int]:
    """K1 on `entries` live (window, bucket) entries of `n` points filling
    `buckets_used` buckets: one mixed addition per entry beyond the first of
    each bucket; the basis and the entries read once, the used buckets
    written once.  The additions that join a run across threads, tiles and
    levels are overhead and are not counted."""
    ops = (entries - buckets_used) * MADD_MULS * FE_MUL_IMAD
    nbytes = n * 2 * FE_BYTES + entries * 8 + buckets_used * 3 * FE_BYTES
    return ops, nbytes


def window_sums_work(windows: int, buckets_per_window: int, c: int) -> Tuple[int, int]:
    """K2: the running-sum reduction is two full additions per bucket; the
    combine sum_w 2^(c*w) * window_w is W * c doublings and W additions.  The
    buckets read once, one point written.  The scan of the segment sums and
    their shares, which join the segments and blocks of a window, are
    overhead and are not counted."""
    ops = (windows * (buckets_per_window - 1) * 2 * JADD_MULS
           + windows * c * JDBL_MULS + windows * JADD_MULS) * FE_MUL_IMAD
    nbytes = (windows * buckets_per_window + 1) * 3 * FE_BYTES
    return ops, nbytes


def round_work(tables: int, pairs: int, degree: int, tape_muls: int) -> Tuple[int, int]:
    """K3 at one round: the tape's products at t = 1..degree per pair, plus
    one product for the identity leaf; every table read once."""
    ops = pairs * (degree * tape_muls + 1) * FE_MUL_IMAD
    return ops, tables * 2 * pairs * FE_BYTES


def fold_work(tables: int, pairs: int) -> Tuple[int, int]:
    """K4 at one round: one product per output; two rows read, one written."""
    return tables * pairs * FE_MUL_IMAD, tables * pairs * 3 * FE_BYTES


FOLD_TABLE_MULS = 16  # csrc/ipa.cu fold_ladder_point's products before the ladder and after
FOLD_AFFINE_MULS = 7  # a point of the batch conversion: 3 for the inversion, 4 for (x, y)


def _fold_schedule_muls(curve, xi: int):
    """Products a point of the ladder for this xi (csrc/ipa.cu): its table
    (beta x, Q = R - phi(R) in Jacobian, the map to Q's curve, the beta
    multiples, L's map and the map back) unless every digit is +-1, a
    doubling per digit below the top, a mixed addition per nonzero digit
    below the top and one for L; 0 for xi = 0 (the fold is L)."""
    from .kernels.ipa import FAMILY_Q, digits

    codes = digits(curve, xi)
    nonzero = [c for c in codes if c]
    if not nonzero:
        return 0
    table = FOLD_TABLE_MULS if any(c & (FAMILY_Q | 3) for c in nonzero) else 0
    return (table + JDBL_MULS * (len(codes) - 1) + MADD_MULS * (len(nonzero) - 1)
            + MADD_MULS)


def _inversion_muls(curve) -> int:
    p = curve.base.p
    return (p - 2).bit_length() + bin(p - 2).count("1")


def fold_ladder_work(curve, n: int, xi: int) -> Tuple[int, int]:
    """The fold's ladder kernel: its products; L and R read once, the
    Jacobian points written once."""
    return n * _fold_schedule_muls(curve, xi) * FE_MUL_IMAD, n * (4 + 3) * FE_BYTES


def fold_affine_work(curve, n: int) -> Tuple[int, int]:
    """The fold's conversion to affine: FOLD_AFFINE_MULS a point and one
    inversion (Montgomery's trick over the whole batch); the Jacobian points
    read once, the affine ones written once."""
    return (n * FOLD_AFFINE_MULS + _inversion_muls(curve)) * FE_MUL_IMAD, n * (3 + 2) * FE_BYTES


def base_fold_work(curve, n: int, xi: int) -> Tuple[int, int]:
    """The work of the IPA base fold L + xi * R over n affine points, for
    this xi, in the design csrc/ipa.cu runs: xi split by the curve's
    endomorphism (curves/device.py::_glv_split) and recoded as a width-2 NAF
    over the Eisenstein integers, whose digit points all come from R and
    Q = R - phi(R) by phi and negation (``_fold_schedule_muls``), then the
    affine output by one batch inversion: the ladder's and the conversion's
    products.  A wider window would need fewer additions; it is not counted,
    so this is the design's work, not the function's least.  xi = 0 needs
    none (the fold is L).  L and R read once, the affine output written
    once."""
    if not _fold_schedule_muls(curve, xi):
        return 0, n * 3 * 2 * FE_BYTES
    ops = fold_ladder_work(curve, n, xi)[0] + fold_affine_work(curve, n)[0]
    return ops, n * 3 * 2 * FE_BYTES


KECCAK_ROUND_OPS = 150  # 64-bit xor, and-not and rotate operations a round of keccak-f
FS_COEFF_PRODUCTS = 6  # three from Montgomery form, one into it, two in the next sum


def fs_round_products(degree: int) -> int:
    """K6's products in one Evaluations round of `degree`: d + 1 out of
    Montgomery form, one into it, d + 1 suffix products, four a point for
    the Lagrange form (prefix, basis, weight, message), one for the offset."""
    return 6 * (degree + 1) + 2


def fs_permutations(pending: int, elements: int) -> int:
    """Keccak-f permutations of absorbing `elements` 32-byte reprs onto
    `pending` buffered bytes, then the squeeze."""
    return (pending + 32 * elements) // 136 + 1


def fs_message_work(products: int, permutations: int, in_words: int,
                    out_words: int) -> Tuple[int, int]:
    """K6: its products, and each permutation's 24 rounds of 64-bit logic
    operations counted as two 32-bit operations each; every input word read
    once and every output word written once."""
    ops = products * FE_MUL_IMAD + permutations * 24 * KECCAK_ROUND_OPS * 2
    return ops, 4 * (in_words + out_words)


KECCAK_ROUND_DEPTH = 7  # a round's dependent chain: theta's two 3-input XORs, its rotation
# by one and its XOR into the lane, rho's rotation, chi's 3-input logic op, iota
# A dependent integer instruction: "typically 4 clock cycles" for most
# arithmetic instructions (CUDA C++ Programming Guide, Performance Guidelines,
# Multiprocessor Level); cited, not measured on the card.
ALU_LATENCY_CYCLES = 4
# The Coefficients round's shortest chain of products: the coefficients out of
# Montgomery form before the absorb, then c^2 beside c c1, then c^2 c2 (the
# challenge's Montgomery factor folded into c1 and c2 before the squeeze).
FS_COEFF_LATENCY_PRODUCTS = 3


def fs_round_latency_products(degree: int) -> int:
    """The products on the shortest dependent chain of an Evaluations round
    of `degree`: the message out of Montgomery form before the absorb (a
    product by one, as the kernel does it), then a Lagrange term's degree + 1
    factors (its weighted message and the degree differences c - x_j) as a
    balanced tree of ceil(log2(degree + 1)) levels.  The challenge's entry
    into Montgomery form is not counted: its factor R can be folded into the
    weighted message before the squeeze.  The kernel runs a longer chain
    (the challenge into Montgomery form, two chains of degree // 2 + 1
    products and their product)."""
    return 1 + max(0, degree).bit_length()


def fs_latency_ms(permutations: int, products: int, product_s: float,
                  clock_hz: float = PEAKS["sm_clock_hz"]) -> float:
    """The least time of K6's dependent chain: each permutation's 24 rounds
    of KECCAK_ROUND_DEPTH dependent instructions at ALU_LATENCY_CYCLES each,
    plus `products` dependent products at `product_s` each (one product's
    latency, measured by K5 at one element)."""
    keccak_s = permutations * 24 * KECCAK_ROUND_DEPTH * ALU_LATENCY_CYCLES / clock_hz
    return (keccak_s + products * product_s) * 1e3


def fused_bound_ms(tables: int, pairs: int, rounds: int, degree: int, tape_muls: int,
                   round_latency_ms: float, peaks: Optional[dict] = None):
    """K7 over `rounds` rounds from `pairs` pairs: each round the larger of
    K3's and K4's bounds (the round's sums and its fold, which needs their
    challenge, cannot overlap), plus K6's dependent chain
    (``fs_latency_ms``, `round_latency_ms` a round).  Returns (ms, "bytes" or
    "operations"): operations unless the rounds' byte bounds outweigh their
    operation bounds and the chains."""
    total, t_ops, t_bytes = 0.0, round_latency_ms * rounds, 0.0
    for j in range(rounds):
        s = pairs >> j
        k3, k3_by, _ = bound_ms(*round_work(tables, s, degree, tape_muls), peaks)
        k4, k4_by, _ = bound_ms(*fold_work(tables, s), peaks)
        ms, by = (k3, k3_by) if k3 >= k4 else (k4, k4_by)
        total += ms + round_latency_ms
        if by == "bytes":
            t_bytes += ms
        else:
            t_ops += ms
    return total, "bytes" if t_bytes > t_ops else "operations"


def convert_work(n: int) -> Tuple[int, int]:
    """The conversion into or out of Montgomery form (csrc/convert.cu): one
    product per element; each element read once and written once.  Bound by
    its bytes, about 0.020 ms at 2^20."""
    return n * FE_MUL_IMAD, n * 2 * FE_BYTES


KECCAK_F_OPS = 4320  # 32-bit operations a keccak-f[1600], three-input logic and funnel shifts
KECCAK_RATE_BYTES = 136


def brakedown_encode_work(code, rows: int) -> Tuple[int, int]:
    """Brakedown's encoding of `rows` rows (csrc/brakedown.cu): one product
    a row for every nonzero of both chains and every entry of the base
    case's matrix; the input, the codeword and the matrices (a coefficient
    and a 4-byte index a nonzero) each once."""
    nonzeros = sum(m.dimension.n * m.dimension.d for m in code.a + code.b)
    base = code.rs.dimension.n * code.rs.dimension.m
    nbytes = (rows * (code.row_len + code.codeword_len) + base) * FE_BYTES + nonzeros * (
        FE_BYTES + 4)
    return rows * (nonzeros + base) * FE_MUL_IMAD, nbytes


def merkle_work(codeword_len: int, rows: int) -> Tuple[int, int]:
    """Brakedown's column hashes and Merkle tree (csrc/merkle.cu): each
    column's 32 * rows bytes in 136-byte blocks, each node with a real leaf
    under it, KECCAK_F_OPS a permutation at the multiply-add rate; the
    canonical codeword read once."""
    depth = (codeword_len - 1).bit_length()
    nodes = sum(-(-codeword_len // (1 << level)) for level in range(1, depth + 1))
    permutations = codeword_len * (32 * rows // KECCAK_RATE_BYTES + 1) + nodes
    return permutations * KECCAK_F_OPS, rows * codeword_len * FE_BYTES


def chain_work(n: int, chain: int) -> Tuple[int, int]:
    """K5: `chain` products per element; a and b read, out written."""
    return n * chain * FE_MUL_IMAD, n * 3 * FE_BYTES


# ---------------------------------------------------------------------------
# Whole-algorithm counts
# ---------------------------------------------------------------------------

def msm_mul_ops(entries: int, buckets_used: int, windows: int,
                buckets_per_window: int, c: int) -> int:
    """Multiply-adds of one MSM through K1 and K2 (the window combine
    included)."""
    return (bucket_sums_work(0, entries, buckets_used)[0]
            + window_sums_work(windows, buckets_per_window, c)[0])


def msm_hbm_bytes(n: int, entries: int, buckets_used: int, windows: int,
                  buckets_per_window: int, c: int) -> int:
    return (bucket_sums_work(n, entries, buckets_used)[1]
            + window_sums_work(windows, buckets_per_window, c)[1])


def expression_mul_count(spec, expr, challenges=None) -> int:
    """Montgomery products per row for one evaluation of `expr`, counted on
    the CSE'd tape (piop/tape.py), the same DAG the round kernel interprets.
    Challenge leaves are substituted first, as the prover does."""
    from .piop.tape import OP_MUL, compile_tape

    if challenges:
        expr = expr.simplified(challenges)
    tape = compile_tape(expr, spec)
    return int((tape.instrs[:, 0] == OP_MUL).sum())


def sumcheck_num_tables(expr, num_polys: int, num_ys: int = 1) -> int:
    """Tables the prover state stacks (piop/sum_check.py::ProverState): every
    input polynomial, one more per rotated query, the Lagrange one-hots and
    the eq tables."""
    rotated = {(q.poly, q.rotation.value) for q in expr.used_query()
               if q.rotation.value != 0}
    return num_polys + len(rotated) + len(expr.used_lagrange()) + num_ys


def sumcheck_mul_ops(spec, expr, k: int, num_tables: int, challenges=None) -> int:
    """Multiply-adds of a full k-round sum-check through K3 and K4: round r
    has 2^(k-1-r) pairs.  The eq table's construction and the host transcript
    are not counted."""
    degree = expr.degree()
    tape_muls = expression_mul_count(spec, expr, challenges)
    pairs_total = (1 << k) - 1
    return (round_work(num_tables, pairs_total, degree, tape_muls)[0]
            + fold_work(num_tables, pairs_total)[0])


def sumcheck_hbm_bytes(k: int, num_tables: int) -> int:
    """Bytes of a full k-round sum-check: per round K3 reads the state once,
    K4 reads it again and writes the halved state."""
    pairs_total = (1 << k) - 1
    return (round_work(num_tables, pairs_total, 0, 0)[1]
            + fold_work(num_tables, pairs_total)[1])


# ---------------------------------------------------------------------------
# Peaks, bounds, shares
# ---------------------------------------------------------------------------

def imad_assumed_per_s(sm_count: Optional[int] = None) -> float:
    return ((sm_count or PEAKS["sm_count"]) * PEAKS["int32_lanes_per_sm"]
            * PEAKS["sm_clock_hz"])


def imad_rate(peaks: Optional[dict]) -> Tuple[float, str]:
    """The multiply-add rate bounds are taken against: the larger of the
    measured and the assumed one, and which it is."""
    assumed = peaks["imad_per_s_assumed"] if peaks else imad_assumed_per_s()
    measured = peaks["imad_per_s_measured"] if peaks else 0.0
    if measured > assumed:
        return measured, "measured"
    return assumed, "assumed"


def bound_ms(ops: int, nbytes: int, peaks: Optional[dict] = None):
    """(least ms the card could take, "bytes" or "operations", the rate's
    source "measured" or "assumed")."""
    rate, source = imad_rate(peaks)
    hbm = peaks["hbm_bytes_per_s"] if peaks else PEAKS["hbm_bytes_per_s"]
    t_ops, t_bytes = ops / rate, nbytes / hbm
    by = "operations" if t_ops >= t_bytes else "bytes"
    return max(t_ops, t_bytes) * 1e3, by, source


def roofline_pct(work: int, seconds: float, peaks: Optional[dict],
                 kind: str = "imad") -> Optional[float]:
    """Achieved over peak in percent: multiply-adds (``kind="imad"``) or bytes
    (``kind="hbm_bytes"``) per second.  None without measured peaks (a run on
    the CPU has no roofline against the card's)."""
    if peaks is None or seconds <= 0:
        return None
    peak = imad_rate(peaks)[0] if kind == "imad" else peaks["hbm_bytes_per_s"]
    return 100.0 * work / seconds / peak


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    return out[0]


_measured: dict = {}


def probe_sweep(device, n: int = PROBE_N, chain: int = PROBE_CHAIN,
                reps: int = PROBE_REPS):
    """Time K5 for every multiplier (``probe.VARIANTS``) over 1, 2 and 4
    elements per thread and blocks of 128 and 256 threads.  Returns
    ``[(variant, per_thread, threads, ms), ...]``; the variants' outputs must
    be equal."""
    import torch

    from .fields.spec import BN254_FR
    from .kernels import probe

    gen = torch.Generator().manual_seed(5)
    raw = torch.randint(0, 1 << 32, (2, n, 8), generator=gen, dtype=torch.int64)
    raw[:, :, 7] %= BN254_FR.p >> 224  # canonical: top limb below p's
    raw = torch.where(raw >= 1 << 31, raw - (1 << 32), raw).to(torch.int32).to(device)
    a, b = raw[0].contiguous(), raw[1].contiguous()
    rows = []
    outs = {}
    for variant in probe.VARIANTS:
        for per_thread in probe.PER_THREAD:
            for threads in (128, 256):
                def run():
                    return probe.mont_mul_chain_cuda(
                        BN254_FR, a, b, chain, variant, per_thread, threads)

                out = run()
                prev = outs.setdefault(variant, out)
                if prev is not out and not torch.equal(prev, out):
                    raise RuntimeError(
                        f"mont_mul_chain {variant}: launch shapes disagree")
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(reps):
                    run()
                end.record()
                torch.cuda.synchronize(device)
                rows.append((variant, per_thread, threads,
                             start.elapsed_time(end) / reps))
    for variant in probe.VARIANTS[1:]:
        if not torch.equal(outs["u32"], outs[variant]):
            raise RuntimeError(f"mont_mul_chain: the u32 and {variant} products disagree")
    return rows


def peaks_from_sweep(sweep, device) -> dict:
    """The card's peaks from one ``probe_sweep``: ``fe_mul_per_s``,
    ``fe_mul_f32_per_s`` and ``fe_mul_ptx_per_s`` are the best products per
    second of the three multipliers over the sweep (a compute rate: at chain
    16 the work is about 8x over the byte bound); the measured multiply-add
    rate is the faster integer product's."""
    import torch

    products = PROBE_N * PROBE_CHAIN
    best = {}
    for variant, per_thread, threads, ms in sweep:
        if variant not in best or ms < best[variant][2]:
            best[variant] = (per_thread, threads, ms)
    rate = {v: products / (best[v][2] * 1e-3) for v in best}
    sm_count = torch.cuda.get_device_properties(device).multi_processor_count
    return {
        "fe_mul_per_s": rate["u32"],
        "fe_mul_f32_per_s": rate["f32"],
        "fe_mul_ptx_per_s": rate["ptx"],
        "imad_per_s_measured": max(rate["u32"], rate["ptx"]) * FE_MUL_IMAD,
        "imad_per_s_assumed": imad_assumed_per_s(sm_count),
        "hbm_bytes_per_s": PEAKS["hbm_bytes_per_s"],
        "card": card_line(),
        "best": {v: {"per_thread": best[v][0], "threads": best[v][1], "ms": best[v][2]}
                 for v in best},
        "sweep": [{"variant": v, "per_thread": e, "threads": t, "ms": ms}
                  for v, e, t, ms in sweep],
    }


def measure_peaks(device=None) -> dict:
    """Launch K5 on the card and return its peaks (``peaks_from_sweep``);
    measured once per process."""
    from . import resolve_device

    device = resolve_device(device)
    if device.type != "cuda":
        raise ValueError("peaks are measured on a CUDA card")
    key = str(device)
    if key not in _measured:
        _measured[key] = peaks_from_sweep(probe_sweep(device), device)
    return _measured[key]
