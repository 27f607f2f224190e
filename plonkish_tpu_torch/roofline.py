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
tape-interpreting round kernel (K3) and the fold (K4); the IPA base fold's
is the least its function needs (``base_fold_work``).
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


def base_fold_work(curve, n: int, xi: int) -> Tuple[int, int]:
    """The least work of the IPA base fold L + xi * R over n affine points,
    for this xi.  xi splits by the curve's endomorphism into k1 + k2 * lambda
    of about half its bits each (curves/device.py::_glv_split), and k1 * R +
    k2 * phi(R) is one double-and-add over both halves at once (Shamir): one
    product for phi(R) and one mixed addition for R + phi(R) when both halves
    are nonzero, a doubling per joint bit below the top, a mixed addition per
    joint bit below the top where either half is set, and one for L.  The
    affine output takes a batch inversion (3 products a point and one
    inversion by Fermat for the batch) and 4 products a point.  L and R read
    once, the affine output written once."""
    from .curves.device import _glv_split

    k1, k2 = (abs(v) for v in _glv_split(curve, xi % curve.scalar.p))
    joint = k1 | k2
    table = 1 + MADD_MULS if k1 and k2 else 0
    shamir = (JDBL_MULS * max(0, joint.bit_length() - 1)
              + MADD_MULS * max(0, bin(joint).count("1") - 1))
    per_point = table + shamir + MADD_MULS + 3 + 4
    p = curve.base.p
    inversion = (p - 2).bit_length() + bin(p - 2).count("1")
    return (n * per_point + inversion) * FE_MUL_IMAD, n * 3 * 2 * FE_BYTES


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
    """Time K5 for both multipliers over 1, 2 and 4 elements per thread and
    blocks of 128 and 256 threads.  Returns ``[(variant, per_thread, threads,
    ms), ...]``; the two variants' outputs must be equal."""
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
    if not torch.equal(outs["u32"], outs["f32"]):
        raise RuntimeError("mont_mul_chain: the u32 and f32 products disagree")
    return rows


def peaks_from_sweep(sweep, device) -> dict:
    """The card's peaks from one ``probe_sweep``: ``fe_mul_per_s`` and
    ``fe_mul_f32_per_s`` are the best products per second of the two
    multipliers over the sweep (a compute rate: at chain 16 the work is about
    8x over the byte bound)."""
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
        "imad_per_s_measured": rate["u32"] * FE_MUL_IMAD,
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
