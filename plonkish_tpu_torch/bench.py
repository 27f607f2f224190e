"""MSM benchmark entry point (port of the root bench.py): prints ONE JSON line.

    python -m plonkish_tpu_torch.bench [--msm-log2 N] [--budget S] [--fieldmul-only]
                                       [--device cuda|cpu]

Headline: MSM throughput (points per second) of ``curves.msm.variable_base_msm``
at 2^N points of BN254 G1 on the device, with the native multicore C++ MSM
(``ops/field_cpp.ec_msm``) as the baseline column, one reused basis (the
production pattern: commits reuse the SRS), and the device's point asserted
equal to the native one.  ``roofline_pct`` and ``roofline_hbm_pct`` hold the
run against the card's integer rate and memory rate (roofline.py's counts
of K1 and K2); on the CPU they are null.  ``--fieldmul-only`` times the
port's Montgomery product (``fields/limb.py``) against ``field_cpp.mul``.

An MSM that fails raises, and the exit code is not 0: no other metric is
reported in its place.  ``--budget`` bounds the device part in seconds.
Without ``--device`` it needs the card.
"""

from __future__ import annotations

import argparse
import json
import random
import signal
import time

import torch

from . import resolve_device


class BudgetExceeded(RuntimeError):
    pass


def _alarm(_sig, _frm):
    raise BudgetExceeded("the MSM did not finish within --budget")


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize()


def bench_msm(log2n: int, budget: int, device):
    """(device points/s, native points/s, MSM work dict); asserts the
    device's point equals the native one."""
    from .curves import device as cdev
    from .curves import msm as tmsm
    from .curves.host import AffinePoint
    from .curves.specs import BN254_G1
    from .fields import limb
    from .ops import field_cpp

    rng = random.Random(0)
    curve = BN254_G1
    g = AffinePoint.generator(curve)
    base_pts = [g.scalar_mul(rng.randrange(1, curve.scalar.p)) for _ in range(64)]
    n = 1 << log2n
    basis = cdev.affine_from_host(curve, base_pts, device).repeat(n // 64, 1, 1).contiguous()
    scalars = limb.from_ints([rng.randrange(curve.scalar.p) for _ in range(n)], device)

    signal.signal(signal.SIGALRM, _alarm)
    signal.alarm(budget)
    try:
        res = tmsm.variable_base_msm(curve, scalars, basis)  # warm-up
        _sync(device)
        t0 = time.perf_counter()
        res2 = tmsm.variable_base_msm(curve, scalars, basis)
        dt = time.perf_counter() - t0
    finally:
        signal.alarm(0)
    assert res == res2
    device_pps = n / dt

    host_basis, host_scalars = basis.cpu(), scalars.cpu()
    field_cpp.ec_msm(curve, host_scalars, host_basis)  # warm-up (threads, pages)
    t0 = time.perf_counter()
    native = field_cpp.ec_msm(curve, host_scalars, host_basis)
    native_pps = n / (time.perf_counter() - t0)
    # correctness gate: a kernel regression fails the bench loudly
    assert res == native, "device MSM result diverges from native"

    c = tmsm.window_size(n)
    w = tmsm.num_windows(curve, c)
    keys, _, nb = tmsm.msm_entries(scalars, c, w)
    live = keys[keys < w * nb]
    used = int((live[1:] != live[:-1]).sum()) + 1 if live.numel() else 0
    work = {"entries": int(live.numel()), "buckets_used": used, "windows": w,
            "buckets_per_window": nb, "c": c}
    return device_pps, native_pps, work


def bench_fieldmul(log2n: int, iters: int, device):
    """(device products/s, native products/s) of BN254 Fr Montgomery products."""
    from .fields import limb
    from .fields.spec import BN254_FR as spec
    from .ops import field_cpp

    n = 1 << log2n
    rng = random.Random(0)
    host = limb.from_canonical_ints(spec, [rng.randrange(spec.p) for _ in range(4096)])
    vals = host.repeat((2 * n + 4095) // 4096, 1)[: 2 * n]
    a_cpu, b_cpu = vals[:n].contiguous(), vals[n:].contiguous()
    a, b = a_cpu.to(device), b_cpu.to(device)
    limb.mont_mul(spec, a, b)
    _sync(device)
    t0 = time.perf_counter()
    out = a
    for _ in range(iters):
        out = limb.mont_mul(spec, out, b)
    _sync(device)
    device_mps = n * iters / (time.perf_counter() - t0)

    host_iters = max(1, iters // 6)
    field_cpp.mul(spec, a_cpu[:1024], b_cpu[:1024])
    t0 = time.perf_counter()
    for _ in range(host_iters):
        field_cpp.mul(spec, a_cpu, b_cpu)
    host_mps = n * host_iters / (time.perf_counter() - t0)
    return device_mps, host_mps


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--msm-log2", type=int, default=20)
    ap.add_argument("--budget", type=int, default=1200)
    ap.add_argument("--fieldmul-only", action="store_true")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    if args.fieldmul_only:
        device_mps, host_mps = bench_fieldmul(16, 30, device)
        line = {
            "metric": f"bn254_fr_mont_mul_throughput[{device.type}]",
            "value": round(device_mps / 1e6, 3),
            "unit": "Mmul/s",
            "vs_baseline": round(device_mps / host_mps, 3),
        }
    else:
        from . import roofline

        device_pps, native_pps, work = bench_msm(args.msm_log2, args.budget, device)
        n = 1 << args.msm_log2
        secs = n / device_pps
        peaks = roofline.measure_peaks(device) if device.type == "cuda" else None
        ops = roofline.msm_mul_ops(work["entries"], work["buckets_used"], work["windows"],
                                   work["buckets_per_window"], work["c"])
        nbytes = roofline.msm_hbm_bytes(n, work["entries"], work["buckets_used"],
                                        work["windows"], work["buckets_per_window"], work["c"])
        pct = roofline.roofline_pct(ops, secs, peaks)
        hbm_pct = roofline.roofline_pct(nbytes, secs, peaks, kind="hbm_bytes")
        line = {
            "metric": f"bn254_msm_2^{args.msm_log2}_throughput[{device.type}]",
            "value": round(device_pps, 1),
            "unit": "points/s",
            "vs_baseline": round(device_pps / native_pps, 3),
            "roofline_pct": round(pct, 1) if pct is not None else None,
            "roofline_hbm_pct": round(hbm_pct, 1) if hbm_pct is not None else None,
        }
    print(json.dumps(line))
    return line


if __name__ == "__main__":
    main()
