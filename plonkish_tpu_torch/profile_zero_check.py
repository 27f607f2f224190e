"""Where a zero-check's time goes: one vanilla-PLONK zero-check sum-check,
round by round (port of scripts/profile_zero_check.py).

    python -m plonkish_tpu_torch.profile_zero_check [k] [--device cuda|cpu]

With the host transcript (the per-round squeeze) each round is split into
message (K3 and the read of its sums), transcript (write and squeeze on the
host) and fold (K4, synchronised), with K3's and K4's own times by CUDA
events on the card; then ``into_evals``.  With the device transcript
(piop/fiat_shamir.py): the uploads before the rounds, the host time to
enqueue every round (K3 -> K6 -> K4 a round, PLONKISH_TPU_FUSED_ROUNDS=0),
the wait for the card, and the one transfer with the host replay; then the
same with the fused rounds (one launch of K7 from the handover on, the
flag at 1).  The three must give the same challenges and evaluations.  Each
is run twice, a warm-up and the run that is printed.
Without ``--device`` it needs the card; on the CPU every kernel runs its
plain version, so only the split's shape means anything there.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import random
import time

import torch

from . import resolve_device
from .backend.hyperplonk.preprocessor import compose, permutation_polys
from .backend.hyperplonk.prover import instance_polys, permutation_z_polys
from .fields import limb
from .fields.host import Fp
from .fields.spec import BN254_FR
from .models.circuits import rand_vanilla_plonk_circuit
from .piop.sum_check import (
    DeviceFsRun, Evaluations, EvaluationsProver, ProverState, VirtualPolynomial,
    identity_params,
)
from .poly.multilinear import MLPoly
from .utils.transcript import Keccak256Transcript


def zero_check_polys(spec, k, circuit, device, pp=None):
    """The vanilla zero-check's virtual polynomial of `circuit` ((info,
    circuit) at k), with challenges and y drawn from a seed; the preprocessed
    and permutation polynomials are taken from HyperPlonk's prover params
    `pp` of the circuit when given (the same tables, without their upload)."""
    circuit_info, circuit = circuit
    num_z, expression = compose(circuit_info)
    inst = instance_polys(spec, k, circuit.instances(), device)
    wit = [MLPoly.from_fps(spec, col, device) for col in circuit.synthesize(0, [])]
    perm_idx = circuit_info.permutation_polys()
    if pp is None:
        pre = [MLPoly.from_fps(spec, col, device) for col in circuit_info.preprocess_polys]
        perm = permutation_polys(spec, k, perm_idx, circuit_info.permutations, device)
    else:
        pre = list(pp.preprocess_polys)
        perm = [poly for _, poly in pp.permutation_polys]
    rng = random.Random(42)
    beta, gamma, alpha = (Fp(rng.randrange(spec.p), spec) for _ in range(3))
    base = inst + pre + wit
    z = permutation_z_polys(num_z, list(zip(perm_idx, perm)), base, beta, gamma)
    y = [Fp(rng.randrange(spec.p), spec) for _ in range(k)]
    return VirtualPolynomial(expression, base + perm + z, [beta, gamma, alpha], [y])


class _Clock:
    """Host seconds and, on the card, CUDA events, read after a sync."""

    def __init__(self, device):
        self.cuda = device.type == "cuda"

    def sync(self):
        if self.cuda:
            torch.cuda.synchronize()

    def event(self):
        if not self.cuda:
            return None
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    @staticmethod
    def ms(a, b):
        return a.elapsed_time(b) if a is not None else None


def _fmt(ms):
    return "time not measured" if ms is None else f"{ms:.3f} ms"


def host_fs(spec, k, vp, device, log):
    """One zero-check with the host transcript, split per round."""
    clock = _Clock(device)
    tr = Keccak256Transcript(spec)
    t0 = time.perf_counter()
    state = ProverState(spec, k, Fp.zero(spec), vp)
    clock.sync()
    out = {"init_ms": (time.perf_counter() - t0) * 1e3, "rounds": []}
    prover = EvaluationsProver(state)
    aux = Evaluations.auxiliary(state.degree, spec)
    log(f"host FS: state init {out['init_ms']:.1f} ms (T={len(state.table_keys)}, "
        f"degree={state.degree})")
    challenges = []
    t_all = time.perf_counter()
    for r in range(k):
        t0 = time.perf_counter()
        ids = identity_params(spec, state.round, state.identity_offset, device, state.row0 // 2)
        e0 = clock.event()
        sums = prover.round_sums(state, ids)
        e1 = clock.event()
        vals = limb.to_canonical_ints(spec, sums)
        msg = Evaluations([state.sum - Fp(vals[0], spec)] + [Fp(v, spec) for v in vals])
        t_msg = time.perf_counter() - t0
        t0 = time.perf_counter()
        msg.write(tr)
        challenge = tr.squeeze_challenge()
        t_tr = time.perf_counter() - t0
        t0 = time.perf_counter()
        state.sum = msg.evaluate(aux, challenge)
        state.identity_offset = state.identity_offset + challenge * (1 << r)
        c = limb.const(spec, int(challenge), device)
        e2 = clock.event()
        state.fold(c)
        e3 = clock.event()
        clock.sync()
        t_fold = time.perf_counter() - t0
        challenges.append(challenge)
        row = {"msg_ms": t_msg * 1e3, "transcript_ms": t_tr * 1e3, "fold_ms": t_fold * 1e3,
               "k3_ms": clock.ms(e0, e1), "k4_ms": clock.ms(e2, e3)}
        out["rounds"].append(row)
        log(f"  round {r:2d} size 2^{k - r - 1}: msg {row['msg_ms']:7.3f} ms  transcript "
            f"{row['transcript_ms']:6.3f} ms  fold {row['fold_ms']:7.3f} ms  (K3 "
            f"{_fmt(row['k3_ms'])}, K4 {_fmt(row['k4_ms'])})")
    out["rounds_ms"] = (time.perf_counter() - t_all) * 1e3
    t0 = time.perf_counter()
    evals = state.into_evals()
    out["into_evals_ms"] = (time.perf_counter() - t0) * 1e3
    out["total_ms"] = out["init_ms"] + out["rounds_ms"] + out["into_evals_ms"]
    for part in ("msg", "transcript", "fold"):
        out[f"{part}_ms"] = sum(row[f"{part}_ms"] for row in out["rounds"])
    for kern in ("k3", "k4"):
        vals_ms = [row[f"{kern}_ms"] for row in out["rounds"]]
        out[f"{kern}_ms"] = None if None in vals_ms else sum(vals_ms)
    log(f"host FS: rounds {out['rounds_ms']:.1f} ms = message {out['msg_ms']:.1f} + transcript "
        f"{out['transcript_ms']:.1f} + fold {out['fold_ms']:.1f} (K3 {_fmt(out['k3_ms'])}, K4 "
        f"{_fmt(out['k4_ms'])}); into_evals {out['into_evals_ms']:.1f} ms; total "
        f"{out['total_ms']:.1f} ms")
    return out, challenges, evals


@contextlib.contextmanager
def _fused_flag(fused: bool):
    saved = os.environ.get("PLONKISH_TPU_FUSED_ROUNDS")
    os.environ["PLONKISH_TPU_FUSED_ROUNDS"] = "1" if fused else "0"
    try:
        yield
    finally:
        if saved is None:
            os.environ.pop("PLONKISH_TPU_FUSED_ROUNDS")
        else:
            os.environ["PLONKISH_TPU_FUSED_ROUNDS"] = saved


def device_fs(spec, k, vp, device, log, sync_check=False, fused=False):
    """The same zero-check with the device transcript, its rounds launched
    one by one or, `fused`, as K7 (config.fused_rounds); with `sync_check`,
    the rounds are enqueued under ``torch.cuda.set_sync_debug_mode("error")``,
    so that a host read or a blocking upload before the one transfer raises."""
    with _fused_flag(fused):
        return _device_fs(spec, k, vp, device, log, sync_check, "fused" if fused else "device FS")


def _device_fs(spec, k, vp, device, log, sync_check, name):
    clock = _Clock(device)
    tr = Keccak256Transcript(spec)
    t0 = time.perf_counter()
    state = ProverState(spec, k, Fp.zero(spec), vp)
    prover = EvaluationsProver(state)
    aux = Evaluations.auxiliary(state.degree, spec)
    clock.sync()
    out = {"init_ms": (time.perf_counter() - t0) * 1e3}
    t0 = time.perf_counter()
    run = DeviceFsRun(state, prover, tr)
    clock.sync()
    out["setup_ms"] = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    e0 = clock.event()
    if sync_check:
        torch.cuda.set_sync_debug_mode("error")
    try:
        run.enqueue()
    finally:
        if sync_check:
            torch.cuda.set_sync_debug_mode("default")
    e1 = clock.event()
    out["enqueue_ms"] = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    clock.sync()
    out["drain_ms"] = (time.perf_counter() - t0) * 1e3
    out["device_ms"] = clock.ms(e0, e1)
    t0 = time.perf_counter()
    challenges = run.replay(aux, tr)
    out["replay_ms"] = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    evals = state.into_evals()
    out["into_evals_ms"] = (time.perf_counter() - t0) * 1e3
    out["rounds_ms"] = out["enqueue_ms"] + out["drain_ms"] + out["replay_ms"]
    out["total_ms"] = (out["init_ms"] + out["setup_ms"] + out["rounds_ms"]
                       + out["into_evals_ms"])
    log(f"{name}: state init {out['init_ms']:.1f} ms, uploads {out['setup_ms']:.1f} ms, "
        f"enqueue of {k} rounds {out['enqueue_ms']:.1f} ms (device "
        f"{_fmt(out['device_ms'])} from the first launch to the last), wait "
        f"{out['drain_ms']:.1f} ms, one transfer and replay {out['replay_ms']:.1f} ms; rounds "
        f"{out['rounds_ms']:.1f} ms; into_evals {out['into_evals_ms']:.1f} ms; total "
        f"{out['total_ms']:.1f} ms")
    return out, challenges, evals


def profile(k: int, device, circuit=None, log=print, sync_check=False, pp=None) -> dict:
    """The three splits of the vanilla zero-check at k on `device` (host
    transcript, device transcript a round at a time, fused), on `circuit`
    ((info, circuit) of models.circuits at k; a random vanilla-PLONK
    circuit when None, and then no `pp`); each run twice, the second kept,
    its device rounds under the sync check when `sync_check`
    (``device_fs``).  Raises if the three disagree."""
    spec = BN254_FR
    device = resolve_device(device)
    if circuit is None:
        circuit = rand_vanilla_plonk_circuit(spec, k, random.Random(42), random.Random(4242))
    t0 = time.perf_counter()
    vp = zero_check_polys(spec, k, circuit, device, pp)
    log(f"k={k} on {device}: polynomials ready in {time.perf_counter() - t0:.2f} s")
    result = {}
    for run in range(2):
        log(f"-- run {run}{' (warm-up)' if run == 0 else ''}")
        host, host_ch, host_ev = host_fs(spec, k, vp, device, log)
        dev, dev_ch, dev_ev = device_fs(spec, k, vp, device, log, sync_check and run == 1)
        fused, fused_ch, fused_ev = device_fs(spec, k, vp, device, log, sync_check and run == 1,
                                              fused=True)
        if host_ch != dev_ch or host_ev != dev_ev:
            raise ValueError("the device transcript's zero-check differs from the host's")
        if host_ch != fused_ch or host_ev != fused_ev:
            raise ValueError("the fused rounds' zero-check differs from the host's")
        result = {"k": k, "device": str(device), "host_fs": host, "device_fs": dev,
                  "fused": fused}
    log(f"host FS rounds {result['host_fs']['rounds_ms']:.1f} ms, device FS rounds "
        f"{result['device_fs']['rounds_ms']:.1f} ms, fused rounds "
        f"{result['fused']['rounds_ms']:.1f} ms: same challenges and evaluations")
    return result


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("k", type=int, nargs="?", default=20)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    profile(args.k, args.device)


if __name__ == "__main__":
    main()
