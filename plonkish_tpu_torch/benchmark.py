"""Proof-system benchmark harness (port of plonkish_tpu/benchmark.py).

Usage:
    python -m plonkish_tpu_torch.benchmark --system hyperplonk \
        --circuit vanilla_plonk --k 8..12 [--device cuda|cpu] [--breakdown]

Appends ``k, avg_ms`` lines to target/bench_torch/<system> (``k, commit_ms,
open_ms`` for ``--system pcs``) and, with --breakdown, prints the per-phase
cost aggregation from the timer trace and writes it beside the series as
``<system>.breakdown.json`` (the plotter's input).

Runs on the CUDA card unless ``--device cpu`` is given; without a card the
default raises.  Every timed region ends in ``torch.cuda.synchronize()``.
On the card the ``zero_check`` system prints the share of the roofline the
prove reached, against the peaks that the ``mont_mul`` chain probe measures
in the same process (``roofline.measure_peaks``).

Systems: ``hyperplonk`` (a whole proof), ``univariate_plonk`` (the
halo2-style comparison system: NTT and univariate KZG, vanilla PLONK only),
``zero_check`` (the sum-check prover alone over the composed vanilla-PLONK
expression), ``pcs`` (commit and open of one polynomial), ``protostar`` and
``sangria`` (the average of ``max(2, samples // 2)`` folds, then a
``# decider k=...: ... ms`` row for a decider that the verifier accepted);
``--pcs`` picks kzg, brakedown, gemini, zeromorph, ipa or hyrax for ``pcs``
and ``hyperplonk``, and every one but brakedown (which cannot combine
commitments) for the folding systems; the rows of ``pcs`` go to
target/bench_torch/pcs_<name>.  ``--circuit`` picks vanilla_plonk,
vanilla_plonk_with_lookup, sha256 (as many blocks as fit in 2^k rows) or
aggregation (an in-circuit Grumpkin double-and-add ladder) for
``hyperplonk`` and the folding systems.  The multilinear KZG SRS and the
univariate one are cached under target/srs_cache_torch/; ``--setup-only`` writes the
zero-check tables of each k to target/setup_cache_torch/, and a later run of
the same k reads them instead of synthesising the circuit again.  Each cache
file's name holds a fingerprint of the sources that produce it, so that a
change to them is never answered from a stale file.
"""

from __future__ import annotations

import argparse
import datetime
import hashlib
import json
import os
import pathlib
import pickle
import random
import signal
import time

BENCH_DIR = "target/bench_torch"
SRS_CACHE_DIR = "target/srs_cache_torch"
SETUP_CACHE_DIR = "target/setup_cache_torch"

# The package's sources whose code produces each cache.
SRS_SOURCES = (
    "pcs/kzg.py", "curves/msm.py", "curves/device.py", "curves/host.py",
    "curves/pairing.py", "curves/specs.py", "fields/limb.py", "fields/host.py",
    "fields/spec.py",
)
ZERO_CHECK_SOURCES = (
    "benchmark.py", "models/circuits.py", "backend/circuit.py",
    "backend/hyperplonk/preprocessor.py", "backend/hyperplonk/prover.py",
    "piop/evaluator.py", "poly/multilinear.py", "utils/bh.py",
    "utils/expression.py", "fields/limb.py", "fields/host.py", "fields/spec.py",
)


def source_fingerprint(sources) -> str:
    """12 hex digits of a SHA-256 over the named sources of the package."""
    root = pathlib.Path(__file__).resolve().parent
    h = hashlib.sha256()
    for rel in sources:
        h.update(rel.encode() + b"\0" + (root / rel).read_bytes())
    return h.hexdigest()[:12]


UNIVARIATE_SRS_SOURCES = SRS_SOURCES[1:] + ("pcs/univariate_kzg.py", "poly/univariate.py")


def srs_cache_path(k: int, seed: int) -> str:
    return f"{SRS_CACHE_DIR}/kzg_k{k}_seed{seed}_{source_fingerprint(SRS_SOURCES)}.npz"


def univariate_srs_cache_path(k: int, seed: int) -> str:
    """The univariate KZG SRS of a k-row univariate PLONK circuit (4·2^k
    powers)."""
    return (f"{SRS_CACHE_DIR}/univariate_kzg_k{k}_seed{seed}_"
            f"{source_fingerprint(UNIVARIATE_SRS_SOURCES)}.npz")


def setup_cache_path(circuit: str, k: int) -> str:
    return (f"{SETUP_CACHE_DIR}/zero_check_{circuit}_k{k}_"
            f"{source_fingerprint(ZERO_CHECK_SOURCES)}.pkl")


def _sample_size(k: int) -> int:
    """proof_system.rs:321-329."""
    if k < 16:
        return 20
    if k < 20:
        return 5
    return 1


# A crash, an out-of-memory error or a SIGTERM in the middle of a k appends
# an explicit `# FAILED k=<k>: <reason>` row to the series file.  The run
# header is written lazily, together with the first row, so a SIGKILL (which
# no handler sees) leaves no trace rather than a bare header.
_FAIL_NOTE = {"path": None, "k": None, "header": None}


def _append_series(path: str, text: str) -> None:
    """Append a data or FAILED row, emitting the pending run header first."""
    with open(path, "a") as f:
        if _FAIL_NOTE["header"] is not None and path == _FAIL_NOTE["path"]:
            f.write(_FAIL_NOTE["header"])
            _FAIL_NOTE["header"] = None
        f.write(text)


def _fail_note(reason: str) -> None:
    if _FAIL_NOTE["path"] is None:
        return
    # an allocator's message can run to kilobytes: first line only, capped
    reason = reason.splitlines()[0][:200] if reason else reason
    try:
        _append_series(
            _FAIL_NOTE["path"], f"# FAILED k={_FAIL_NOTE['k']}: {reason}\n"
        )
    except OSError:
        pass


def _arm_failure_notes(out_path: str) -> None:
    _FAIL_NOTE["path"] = out_path

    def _on_signal(signum, frame):
        _fail_note(f"killed by {signal.Signals(signum).name} (timeout?)")
        signal.signal(signum, signal.SIG_DFL)
        os.kill(os.getpid(), signum)

    for s in (signal.SIGTERM, signal.SIGINT):
        signal.signal(s, _on_signal)


def main(argv=None) -> None:
    try:
        _main(argv)
    except BaseException as e:  # noqa: BLE001 - note and re-raise
        if not isinstance(e, SystemExit):
            _fail_note(f"{type(e).__name__}: {e}")
        raise


def _prog(msg: str) -> None:
    print(f"[{time.strftime('%H:%M:%S')}] {msg}", flush=True)


def _main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument(
        "--system", default="hyperplonk",
        choices=["hyperplonk", "univariate_plonk", "zero_check", "pcs", "protostar", "sangria"],
    )
    ap.add_argument(
        "--circuit", default="vanilla_plonk",
        choices=["vanilla_plonk", "vanilla_plonk_with_lookup", "sha256", "aggregation"],
    )
    ap.add_argument("--k", default="8..10", help="range, e.g. 8..12")
    ap.add_argument("--pcs", default="kzg", choices=list(PCS_CHOICES))
    ap.add_argument(
        "--device", default="cuda", choices=["cuda", "cpu"],
        help="cuda (the default) raises without a card; cpu runs every "
        "kernel's plain version",
    )
    ap.add_argument("--samples", type=int, default=None)
    ap.add_argument(
        "--mesh", default=None, metavar="N1,N2,..",
        help="zero_check: a scaling sweep, each k proved by a group of each "
        "listed number of ranks (one process a rank, every rank timing its "
        "prove; NCCL with a card a rank, else gloo); appends 'k, ranks, avg_ms, efficiency_pct' to "
        f"{BENCH_DIR}/scaling: T1/(N*TN) with a card a rank, T1/TN where the "
        "ranks share a card or the CPU (collective overhead only)",
    )
    ap.add_argument("--breakdown", action="store_true")
    ap.add_argument(
        "--setup-only", action="store_true",
        help="zero_check: build the setup tables, write them to "
        f"{SETUP_CACHE_DIR}/ and exit without proving",
    )
    ap.add_argument(
        "--profile", metavar="DIR", default=None,
        help="hyperplonk: trace one extra prove with torch.profiler, write "
        "the Chrome trace to DIR and print the device-busy share",
    )
    args = ap.parse_args(argv)

    import torch

    from . import resolve_device
    from .utils import timer

    device = resolve_device(None if args.device == "cuda" else args.device)
    on_card = device.type == "cuda"
    if args.profile and not (on_card and args.system == "hyperplonk"):
        ap.error("--profile traces a hyperplonk prove on the card")
    if args.system in FOLDING_SYSTEMS and args.pcs == "brakedown":
        ap.error(f"--system {args.system} folds commitments; brakedown cannot combine them")
    if args.system in ("zero_check", "univariate_plonk") and args.circuit != "vanilla_plonk":
        ap.error(f"--system {args.system} takes --circuit vanilla_plonk only")
    args.mesh_sizes = None
    if args.mesh:
        if args.system != "zero_check":
            ap.error("--mesh sweeps the zero_check system")
        sizes = args.mesh.split(",")
        if not all(v.isdigit() and int(v) >= 1 for v in sizes):
            ap.error("--mesh takes rank counts of 1 or more")
        args.mesh_sizes = sorted({int(v) for v in sizes})

    def sync():
        if on_card:
            torch.cuda.synchronize(device)

    lo, hi = args.k.split("..")
    ks = range(int(lo), int(hi))

    os.makedirs(BENCH_DIR, exist_ok=True)
    out_path = (
        f"{BENCH_DIR}/pcs_{args.pcs}" if args.system == "pcs"
        else f"{BENCH_DIR}/{args.system}"
    )
    # Each batch of rows is labelled; readers skip '#' lines and the last row
    # per k wins.
    if on_card:
        from . import roofline

        device_label = roofline.card_line()
    else:
        device_label = "cpu"
    now = datetime.datetime.now(datetime.timezone.utc).isoformat(timespec="seconds")
    _FAIL_NOTE["header"] = (
        f"# run {now} circuit={args.circuit} pcs={args.pcs}"
        f" device={device_label} k={args.k}\n"
    )
    _arm_failure_notes(out_path)
    if args.breakdown:
        timer.set_enabled(True)
        timer.set_sync(sync if on_card else None)

    if args.system == "zero_check":
        _bench_zero_check(args, ks, device, sync, out_path)
    elif args.system == "univariate_plonk":
        _bench_univariate(args, ks, device, sync, out_path)
    elif args.system in FOLDING_SYSTEMS:
        _bench_folding(args, ks, device, sync, out_path)
    elif args.system == "pcs":
        _bench_pcs(args, ks, device, sync, out_path)
    else:
        _bench_hyperplonk(args, ks, device, sync, out_path)


def rand_sha256(spec, k, _rng1, _rng2):
    """As many chained 512-bit blocks as fit in 2^k rows, from message seed
    42 (the reference's sha256 bench circuit, plonkish_tpu/benchmark.py:221)."""
    from .models.sha256 import message_for_blocks, sha256_circuit

    m = ((1 << k) - 10) // 140
    assert m >= 1, f"k={k} too small for one sha256 block"
    info, circuit, _ = sha256_circuit(message_for_blocks(m, seed=42), k=k, spec=spec)
    return info, circuit


def _circuit_fn(name: str):
    from .models.aggregation import rand_aggregation_circuit
    from .models.circuits import (
        rand_vanilla_plonk_circuit,
        rand_vanilla_plonk_with_lookup_circuit,
    )

    return {
        "vanilla_plonk": rand_vanilla_plonk_circuit,
        "vanilla_plonk_with_lookup": rand_vanilla_plonk_with_lookup_circuit,
        "sha256": rand_sha256,
        "aggregation": rand_aggregation_circuit,
    }[name]


PCS_CHOICES = ("kzg", "brakedown", "gemini", "zeromorph", "ipa", "hyrax")
FOLDING_SYSTEMS = ("protostar", "sangria")


def _make_pcs(name: str, device):
    """The reference harness's mapping (plonkish_tpu/benchmark.py:195-218):
    KZG, Gemini and Zeromorph on BN254, Brakedown over BN254 Fr with its
    default spec, IPA and Hyrax on Grumpkin."""
    if name == "kzg":
        from .pcs.kzg import MultilinearKzg

        return MultilinearKzg(device=device)
    if name == "brakedown":
        from .fields.spec import BN254_FR
        from .pcs.brakedown import MultilinearBrakedown

        return MultilinearBrakedown(BN254_FR, device=device)
    if name == "gemini":
        from .pcs.gemini import Gemini

        return Gemini(device=device)
    if name == "zeromorph":
        from .pcs.zeromorph import Zeromorph

        return Zeromorph(device=device)
    if name == "ipa":
        from .pcs.ipa import MultilinearIpa

        return MultilinearIpa(device=device)
    from .pcs.hyrax import MultilinearHyrax

    assert name == "hyrax", name
    return MultilinearHyrax(device=device)


# ---------------------------------------------------------------------------
# zero_check: the sum-check prover alone
# ---------------------------------------------------------------------------

def zero_check_challenges(spec, k: int):
    """(challenges [beta, gamma, alpha], y) of the zero-check bench at size k,
    from the fixed seed 42."""
    from .fields.host import Fp

    rng = random.Random(42)
    beta = Fp(rng.randrange(spec.p), spec)
    gamma = Fp(rng.randrange(spec.p), spec)
    alpha = Fp(rng.randrange(spec.p), spec)
    y = [Fp(rng.randrange(spec.p), spec) for _ in range(k)]
    return [beta, gamma, alpha], y


def zero_check_tables(spec, k: int, circuit_fn, challenges, device):
    """The composed zero-check expression of a random circuit with a VALID
    assignment, and every polynomial it reads (instances, preprocessed,
    witness, permutation, grand-product z) as Montgomery tensors on `device`:
    the reference's zero_check criterion bench
    (plonkish_backend/benches/zero_check.rs:18-42)."""
    from .backend.hyperplonk.preprocessor import compose, permutation_polys
    from .backend.hyperplonk.prover import instance_polys, permutation_z_polys
    from .poly.multilinear import MLPoly

    beta, gamma, _ = challenges
    circuit_info, circuit = circuit_fn(spec, k, random.Random(42), random.Random(4242))
    num_z, expression = compose(circuit_info)
    perm_idx = circuit_info.permutation_polys()
    inst = instance_polys(spec, k, circuit.instances(), device)
    pre = [MLPoly.from_fps(spec, col, device) for col in circuit_info.preprocess_polys]
    wit = [MLPoly.from_fps(spec, col, device) for col in circuit.synthesize(0, [])]
    perm = permutation_polys(spec, k, perm_idx, circuit_info.permutations, device)
    base_polys = inst + pre + wit
    z = permutation_z_polys(num_z, list(zip(perm_idx, perm)), base_polys, beta, gamma)
    return expression, [p.evals for p in base_polys + perm + z]


def zero_check_prove(spec, k: int, expression, tables, challenges, y):
    """One sum-check prove over the tables; returns the transcript."""
    from .fields.host import Fp
    from .piop.sum_check import ClassicSumCheck, VirtualPolynomial
    from .poly.multilinear import MLPoly
    from .utils.transcript import Keccak256Transcript

    tr = Keccak256Transcript(spec)
    polys = [MLPoly(spec, t) for t in tables]
    ClassicSumCheck.evaluations().prove(
        spec, k, VirtualPolynomial(expression, polys, challenges, [y]),
        Fp.zero(spec), tr,
    )
    return tr


def _bench_zero_check(args, ks, device, sync, out_path) -> None:
    import torch

    from . import roofline
    from .fields.spec import BN254_FR as spec

    on_card = device.type == "cuda"
    for k in ks:
        _FAIL_NOTE["k"] = k
        challenges, y = zero_check_challenges(spec, k)
        samples = args.samples or _sample_size(k)

        # The setup (circuit synthesis and digit conversion in Python) takes
        # minutes at large k.  Everything cached is deterministic (the seeds
        # are fixed above) and independent of the device.
        setup_cache = setup_cache_path(args.circuit, k)
        if args.mesh_sizes:  # every rank reads the tables from the cache
            if not os.path.exists(setup_cache):
                _write_setup_cache(setup_cache, *zero_check_tables(
                    spec, k, _circuit_fn(args.circuit), challenges, device))
            _scaling_sweep(args, k, device, samples, setup_cache)
            continue
        if os.path.exists(setup_cache) and not args.setup_only:
            expression, tables = _load_setup_cache(setup_cache, device)
            print(f"k={k}: setup loaded from {setup_cache}", flush=True)
        else:
            expression, tables = zero_check_tables(
                spec, k, _circuit_fn(args.circuit), challenges, device
            )
        if args.setup_only:
            _write_setup_cache(setup_cache, expression, tables)
            print(f"k={k}: setup cached, skipping prove", flush=True)
            continue
        num_polys = len(tables)

        if on_card:
            torch.cuda.reset_peak_memory_stats(device)
        times, _ = _timed_zero_checks(k, expression, tables, samples, sync)
        warm_ms = times[0] * 1e3
        times = times[1:]
        avg_ms = sum(times) / len(times) * 1e3
        _append_series(out_path, f"{k}, {avg_ms:.3f}\n")

        pct_s = ""
        if on_card:
            # share of the roofline: the multiply-adds and bytes of the whole
            # k-round prove against the peaks the probe kernel measured
            peaks = roofline.measure_peaks(device)
            num_tables = roofline.sumcheck_num_tables(expression, num_polys)
            secs = avg_ms / 1e3
            mul_pct = roofline.roofline_pct(
                roofline.sumcheck_mul_ops(spec, expression, k, num_tables, challenges),
                secs, peaks,
            )
            hbm_pct = roofline.roofline_pct(
                roofline.sumcheck_hbm_bytes(k, num_tables), secs, peaks,
                kind="hbm_bytes",
            )
            peak_gib = torch.cuda.max_memory_allocated(device) / 2**30
            pct_s = (
                f", roofline {max(mul_pct, hbm_pct):.1f}% "
                f"(mul {mul_pct:.1f}%, hbm {hbm_pct:.1f}%) against "
                f"{roofline.imad_rate(peaks)[0] / 1e12:.2f} T multiply-adds/s "
                f"({roofline.imad_rate(peaks)[1]}; fe_mul "
                f"{peaks['fe_mul_per_s'] / 1e9:.2f} G/s, fe_mul_f32 "
                f"{peaks['fe_mul_f32_per_s'] / 1e9:.2f} G/s measured), "
                f"peak device memory {peak_gib:.2f} GiB"
            )
        print(
            f"k={k} zero_check prove avg {avg_ms:.1f} ms "
            f"(warm-up {warm_ms:.0f} ms){pct_s}", flush=True
        )
        del tables


def _write_setup_cache(path: str, expression, tables) -> None:
    os.makedirs(SETUP_CACHE_DIR, exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump({"expression": expression, "tables": [t.cpu().numpy() for t in tables]},
                    f, protocol=5)


def _load_setup_cache(path: str, device):
    """(expression, tables on `device`) from a setup cache."""
    import torch

    with open(path, "rb") as f:
        blob = pickle.load(f)
    return blob["expression"], [torch.from_numpy(t).to(device) for t in blob["tables"]]


def _timed_zero_checks(k: int, expression, tables, samples: int, sync, mesh=None):
    """An untimed warm-up prove, whose message chain must verify (a kernel
    regression fails the bench loudly), then `samples` timed proves, each
    between two `sync` calls.  Returns (the seconds of every prove, the
    warm-up's first, the last proof).  Under a mesh its counters are reset
    before each prove, so they hold the last one's."""
    from .fields.host import Fp
    from .fields.spec import BN254_FR as spec
    from .piop.sum_check import ClassicSumCheck
    from .utils.transcript import Keccak256Transcript

    challenges, y = zero_check_challenges(spec, k)
    times, proof = [], None
    for sample in range(samples + 1):
        if mesh is not None:
            mesh.reset_stats()
        sync()
        t0 = time.perf_counter()
        tr = zero_check_prove(spec, k, expression, tables, challenges, y)
        sync()
        times.append(time.perf_counter() - t0)
        proof = tr.into_proof()
        if sample == 0:
            ClassicSumCheck.evaluations().verify(
                spec, k, expression.degree(), Fp.zero(spec),
                Keccak256Transcript.from_proof(spec, proof))
    return times, proof


def _zero_check_rank(mesh, k: int, samples: int, setup_cache: str):
    """One rank of the scaling sweep: the zero-check tables from the setup
    cache on this rank's device, then ``_timed_zero_checks`` under the
    mesh.  Returns (the timed seconds, the proof, collectives and bytes of
    one prove, the sharded sites)."""
    import torch

    dev = mesh.device
    expression, tables = _load_setup_cache(setup_cache, dev)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    times, proof = _timed_zero_checks(k, expression, tables, samples, sync, mesh)
    return times[1:], proof, mesh.collectives, mesh.bytes, dict(mesh.taken)


def _scaling_sweep(args, k: int, device, samples: int, setup_cache: str) -> None:
    """Prove the zero-check at k with a group of each size of ``--mesh``
    (reference benchmark.py:836-890) and append ``k, ranks, avg_ms,
    efficiency_pct`` rows to scaling.  avg_ms is the slowest rank's mean
    over its timed proves.  With a card a rank the efficiency is
    T1/(N*TN); where the ranks share a card, or the CPU, dividing by N
    means nothing, and the row reports T1/TN, the collective overhead only
    (the reference's convention for virtual devices).  Every rank's proof
    must equal every other's, at every size."""
    from . import parallel

    mesh_sizes = args.mesh_sizes
    backend = parallel.backend_for(max(mesh_sizes), device)
    shared = backend == "gloo"  # the ranks share a card, or the CPU
    where = "card" if device.type == "cuda" else "CPU"
    metric = f"T1/TN (shared {where}, collective overhead only)" if shared else "T1/(N*TN)"
    path = f"{BENCH_DIR}/scaling"
    now = datetime.datetime.now(datetime.timezone.utc).isoformat(timespec="seconds")
    header = (f"# run {now} system=zero_check k={k} backend={backend} "
              f"device={args.device} metric={metric}\n")
    base_ms, want = None, None
    for nd in mesh_sizes:
        _prog(f"k={k}: {nd} rank(s) over {backend}")
        results = parallel.spawn(
            _zero_check_rank, nd, backend, device, args=(k, samples, setup_cache),
            threads=1 if device.type == "cpu" else None)
        proofs = {r[1] for r in results}
        want = want or results[0][1]
        if proofs != {want}:
            raise AssertionError(f"k={k}: the proofs of {nd} rank(s) differ")
        avg_ms = max(sum(r[0]) / len(r[0]) for r in results) * 1e3
        if base_ms is None:
            base_ms = avg_ms if shared else avg_ms * nd
        eff = base_ms / avg_ms if shared else base_ms / (nd * avg_ms)
        with open(path, "a") as f:
            if header is not None:
                f.write(header)
                header = None
            f.write(f"{k}, {nd}, {avg_ms:.3f}, {100 * eff:.1f}\n")
        _, _, collectives, sent, taken = results[0]
        print(f"k={k} mesh={nd}: avg {avg_ms:.1f} ms, efficiency {100 * eff:.1f}% "
              f"({metric}); {collectives} collectives, {sent} bytes a prove a rank; "
              f"sharded sites {taken}", flush=True)


# ---------------------------------------------------------------------------
# pcs: commit and open of one polynomial
# ---------------------------------------------------------------------------

def _bench_pcs(args, ks, device, sync, out_path) -> None:
    """The reference's criterion pcs bench (plonkish_backend/benches/pcs.rs:26,
    102-124: k = 16..21, commit and open timed separately)."""
    from .fields.host import Fp
    from .poly.multilinear import MLPoly
    from .utils.transcript import Keccak256Transcript

    pcs = _make_pcs(args.pcs, device)
    spec = pcs.field_spec
    warm = device.type == "cuda"
    for k in ks:
        _FAIL_NOTE["k"] = k
        rng = random.Random(42)
        n = 1 << k
        _prog(f"k={k}: pcs setup (SRS)")
        param = pcs.setup(n, 1, random.Random(0))
        pp, vp = pcs.trim(param, n, 1)
        poly = MLPoly.from_fps(
            spec, [Fp(rng.randrange(spec.p), spec) for _ in range(n)], device
        )
        samples = args.samples or _sample_size(k)
        commit_t, open_t = [], []
        proof = None
        for sample in range(samples + warm):
            tr = Keccak256Transcript(spec)
            sync()
            t0 = time.perf_counter()
            comm = pcs.commit_and_write(pp, poly, tr)
            sync()
            t1 = time.perf_counter()
            point = tr.squeeze_challenges(k)
            eval_ = poly.evaluate(point)
            tr.write_field_element(eval_)
            sync()
            t2 = time.perf_counter()
            pcs.open(pp, poly, comm, point, eval_, tr)
            sync()
            t3 = time.perf_counter()
            commit_t.append(t1 - t0)
            open_t.append(t3 - t2)
            proof = tr.into_proof()
        # self-check once per k: the proof must verify
        r = Keccak256Transcript.from_proof(spec, proof)
        comm_r = pcs.read_commitments(vp, 1, r)[0]
        point_r = r.squeeze_challenges(k)
        eval_r = r.read_field_element()
        pcs.verify(vp, comm_r, point_r, eval_r, r)
        if warm:  # the first sample was the warm-up
            commit_t, open_t = commit_t[1:], open_t[1:]
        commit_ms = sum(commit_t) / len(commit_t) * 1e3
        open_ms = sum(open_t) / len(open_t) * 1e3
        _append_series(out_path, f"{k}, {commit_ms:.3f}, {open_ms:.3f}\n")
        print(
            f"k={k} {args.pcs} commit {commit_ms:.1f} ms "
            f"open {open_ms:.1f} ms (avg of {len(open_t)})",
            flush=True,
        )


# ---------------------------------------------------------------------------
# protostar / sangria: folds, then a decider
# ---------------------------------------------------------------------------

def _bench_folding(args, ks, device, sync, out_path) -> None:
    """The reference's folding rows (plonkish_tpu/benchmark.py:611-690): the
    average of max(2, samples // 2) folds (prove_accumulation_from_nark of
    circuits with witness seeds 1000, 1001, ...), appended before the
    decider runs, then the decider with the last NARK (witness seed 999),
    checked by the verifier before its row is written.  The circuit info
    comes with the first fold's circuit: it depends on the preprocess seed
    (42) alone, so it is the one the reference draws with witness seed 4242,
    without a synthesis of its own.  On the card an untimed fold of the
    first circuit warms up first (the reference leaves out its first fold
    on the jax backend)."""
    from .accumulation.protostar import Protostar, Sangria
    from .utils.transcript import Keccak256Transcript

    scheme_cls = Protostar if args.system == "protostar" else Sangria
    circuit_fn = _circuit_fn(args.circuit)
    for k in ks:
        _FAIL_NOTE["k"] = k
        pcs = _make_pcs(args.pcs, device)
        spec = pcs.field_spec
        _prog(f"k={k}: synthesize circuit 0 ({args.circuit}) and its info")
        circuit_info, circuit = circuit_fn(spec, k, random.Random(42), random.Random(1000))
        scheme = scheme_cls(pcs)
        _prog(f"k={k}: setup (SRS)")
        param = _setup_cached(scheme, circuit_info, k, args.pcs, device)
        _prog(f"k={k}: preprocess")
        pp, vp = scheme.preprocess(param, circuit_info)
        accumulator = scheme.init_accumulator(pp)
        samples = max(2, (args.samples or _sample_size(k)) // 2)
        warm_note = ""
        if device.type == "cuda":
            _prog(f"k={k}: warm-up fold")
            t0 = time.perf_counter()
            scheme.prove_accumulation_from_nark(
                pp, scheme.init_accumulator(pp), circuit, Keccak256Transcript(spec)
            )
            sync()
            warm_note = f", warm-up {(time.perf_counter() - t0) * 1e3:.0f} ms"
        fold_times = []
        for i in range(samples):
            if i:
                _prog(f"k={k}: synthesize circuit {i}")
                _, circuit = circuit_fn(spec, k, random.Random(42), random.Random(1000 + i))
            _prog(f"k={k}: fold {i}")
            sync()
            t0 = time.perf_counter()
            scheme.prove_accumulation_from_nark(
                pp, accumulator, circuit, Keccak256Transcript(spec)
            )
            sync()
            fold_times.append(time.perf_counter() - t0)
        avg_ms = sum(fold_times) / len(fold_times) * 1e3
        # the fold row goes out before the decider runs: a failure there
        # keeps the fold measurement
        _append_series(out_path, f"{k}, {avg_ms:.3f}\n")
        print(f"k={k} {args.system} fold avg {avg_ms:.1f} ms ({len(fold_times)} folds"
              f"{warm_note})", flush=True)

        _prog(f"k={k}: decider")
        _, last_circuit = circuit_fn(spec, k, random.Random(42), random.Random(999))
        acc_before = accumulator.instance.clone()
        tr = Keccak256Transcript(spec)
        sync()
        t0 = time.perf_counter()
        scheme.prove_decider_with_last_nark(pp, accumulator, last_circuit, tr)
        sync()
        decider_s = time.perf_counter() - t0
        scheme.verify_decider_with_last_nark(
            vp, acc_before, last_circuit.instances(),
            Keccak256Transcript.from_proof(spec, tr.into_proof()),
        )
        _append_series(out_path, f"# decider k={k}: {decider_s * 1e3:.3f} ms\n")
        print(f"k={k} {args.system} decider {decider_s * 1e3:.1f} ms (verified)", flush=True)


# ---------------------------------------------------------------------------
# univariate_plonk: the halo2-style comparison system
# ---------------------------------------------------------------------------

def _bench_univariate(args, ks, device, sync, out_path) -> None:
    """The reference's univariate_plonk rows (plonkish_tpu/benchmark.py:
    572-611): vanilla PLONK from seeds 42 and 4242, the univariate KZG SRS
    from seed 0, the average prove time, written after the verifier accepted
    the last proof.  On the card an untimed prove warms up first."""
    import torch

    from .backend.univariate import UnivariatePlonk
    from .pcs.univariate_kzg import UnivariateKzg
    from .utils.transcript import Keccak256Transcript

    on_card = device.type == "cuda"
    for k in ks:
        _FAIL_NOTE["k"] = k
        backend = UnivariatePlonk(UnivariateKzg(device=device))
        spec = backend.field_spec
        _prog(f"k={k}: generating circuit ({args.circuit})")
        circuit_info, circuit = _circuit_fn(args.circuit)(
            spec, k, random.Random(42), random.Random(4242)
        )
        _prog(f"k={k}: setup (SRS)")
        param = _univariate_setup_cached(backend, circuit_info, k, device)
        _prog(f"k={k}: preprocess")
        pp, vp = backend.preprocess(param, circuit_info)
        samples = args.samples or _sample_size(k)
        warm_note = ""
        if on_card:
            sync()
            t0 = time.perf_counter()
            backend.prove(pp, circuit, Keccak256Transcript(spec))
            sync()
            warm_note = f", warm-up {(time.perf_counter() - t0) * 1e3:.0f} ms"
            torch.cuda.reset_peak_memory_stats(device)
        times = []
        proof = None
        for _ in range(samples):
            tr = Keccak256Transcript(spec)
            sync()
            t0 = time.perf_counter()
            backend.prove(pp, circuit, tr)
            sync()
            times.append(time.perf_counter() - t0)
            proof = tr.into_proof()
        peak_note = ""
        if on_card:
            peak_note = (f", peak device memory "
                         f"{torch.cuda.max_memory_allocated(device) / 2**30:.2f} GiB")
        backend.verify(vp, circuit.instances(), Keccak256Transcript.from_proof(spec, proof))
        avg_ms = sum(times) / len(times) * 1e3
        _append_series(out_path, f"{k}, {avg_ms:.3f}\n")
        print(f"k={k} univariate_plonk prove avg {avg_ms:.1f} ms (avg of {samples}"
              f"{warm_note}){peak_note}, verified", flush=True)


def _univariate_setup_cached(backend, circuit_info, k: int, device, seed=0):
    """Disk-cache the univariate KZG SRS (4·2^k powers of s in G1 and the G2
    points), as `_setup_cached` does the multilinear one."""
    import numpy as np
    import torch

    from .curves.host import AffinePoint
    from .pcs.univariate_kzg import UnivariateKzgParam

    path = univariate_srs_cache_path(k, seed)
    if os.path.exists(path):
        with np.load(path) as z:
            meta = json.loads(str(z["meta"]))
            powers = torch.from_numpy(z["powers"]).to(device)
        return UnivariateKzgParam(
            powers_of_s_g1=powers, g1=AffinePoint.generator(backend.pcs.curve),
            g2=_g2_from(meta["g2"]), s_g2=_g2_from(meta["s_g2"]),
            offset_g2={int(off): _g2_from(pt) for off, pt in meta["offset_g2"].items()},
        )
    param = backend.setup(circuit_info, random.Random(seed))
    os.makedirs(SRS_CACHE_DIR, exist_ok=True)
    meta = {
        "g2": _g2_to(param.g2), "s_g2": _g2_to(param.s_g2),
        "offset_g2": {str(off): _g2_to(pt) for off, pt in param.offset_g2.items()},
    }
    np.savez(path, meta=json.dumps(meta), powers=param.powers_of_s_g1.cpu().numpy())
    return param


def _g2_to(pt):
    return [int(pt.x.a), int(pt.x.b), int(pt.y.a), int(pt.y.b)]


def _g2_from(d):
    from .curves.pairing import Fq2, G2Point

    return G2Point(Fq2(d[0], d[1]), Fq2(d[2], d[3]))


# ---------------------------------------------------------------------------
# hyperplonk: a whole proof
# ---------------------------------------------------------------------------

def _bench_hyperplonk(args, ks, device, sync, out_path) -> None:
    import torch

    from .backend.hyperplonk import HyperPlonk
    from .utils import timer
    from .utils.transcript import Keccak256Transcript

    circuit_fn = _circuit_fn(args.circuit)
    on_card = device.type == "cuda"
    for k in ks:
        _FAIL_NOTE["k"] = k
        pcs = _make_pcs(args.pcs, device)
        spec = pcs.field_spec
        _prog(f"k={k}: generating circuit ({args.circuit})")
        circuit_info, circuit = circuit_fn(
            spec, k, random.Random(42), random.Random(4242)
        )
        backend = HyperPlonk(pcs)
        t0 = time.perf_counter()
        _prog(f"k={k}: setup (SRS)")
        param = _setup_cached(backend, circuit_info, k, args.pcs, device)
        _prog(f"k={k}: preprocess")
        pp, vp = backend.preprocess(param, circuit_info)
        sync()
        setup_s = time.perf_counter() - t0

        samples = args.samples or _sample_size(k)
        warm_s = None
        if on_card:
            _prog(f"k={k}: warm-up prove")
            sync()
            t0 = time.perf_counter()
            backend.prove(pp, circuit, Keccak256Transcript(spec))
            sync()
            warm_s = time.perf_counter() - t0
            torch.cuda.reset_peak_memory_stats(device)
        timer.reset_trace()
        prove_times = []
        proof = None
        for s in range(samples):
            _prog(f"k={k}: prove sample {s + 1}/{samples}")
            tr = Keccak256Transcript(spec)
            sync()
            t0 = time.perf_counter()
            backend.prove(pp, circuit, tr)
            sync()
            prove_times.append(time.perf_counter() - t0)
            proof = tr.into_proof()
        peak_note = ""
        if on_card:
            peak_gib = torch.cuda.max_memory_allocated(device) / 2**30
            peak_note = f", peak device memory {peak_gib:.2f} GiB"
        # read the spans of the timed proves before anything else proves
        breakdown = timer.cost_breakdown() if args.breakdown else None
        if args.profile:
            _profile_prove(args.profile, k, backend, pp, circuit, spec, device)

        t0 = time.perf_counter()
        backend.verify(
            vp, circuit.instances(), Keccak256Transcript.from_proof(spec, proof)
        )
        verify_s = time.perf_counter() - t0

        avg_ms = sum(prove_times) / len(prove_times) * 1e3
        _append_series(out_path, f"{k}, {avg_ms:.3f}\n")
        warm_note = f", warm-up {warm_s * 1e3:.0f} ms" if warm_s is not None else ""
        print(
            f"k={k} pcs={args.pcs} device={args.device}: "
            f"prove {avg_ms:.1f} ms (avg of {samples}{warm_note}), "
            f"setup+preprocess {setup_s * 1e3:.1f} ms, "
            f"verify {verify_s * 1e3:.1f} ms, proof {len(proof)} B{peak_note}",
            flush=True,
        )
        if args.breakdown:
            print("  cost breakdown (per prove):")
            breakdown_ms = {}
            for cat, secs in breakdown.items():
                breakdown_ms[cat] = secs / samples * 1e3
                print(f"    {cat:14s} {secs / samples * 1e3:9.2f} ms")
            _append_breakdown(out_path + ".breakdown.json", k, breakdown_ms)


def _profile_prove(out_dir, k, backend, pp, circuit, spec, device) -> None:
    """Trace one extra prove with torch.profiler (CPU and CUDA activity),
    write the Chrome trace, and print the share of the traced window in
    which the device ran a kernel or a copy and the ten operations with most
    device time.  A trace without device events exits non-zero."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from .utils.transcript import Keccak256Transcript

    os.makedirs(out_dir, exist_ok=True)
    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        backend.prove(pp, circuit, Keccak256Transcript(spec))
        torch.cuda.synchronize(device)
        window_s = time.perf_counter() - t0
    path = os.path.join(out_dir, f"hyperplonk_k{k}.trace.json")
    prof.export_chrome_trace(path)
    spans = sorted(
        (e.time_range.start, e.time_range.end) for e in prof.events()
        if e.device_type == torch.autograd.DeviceType.CUDA
    )
    if not spans:
        print(f"  torch.profiler trace {path} holds no device events", flush=True)
        raise SystemExit(1)
    busy_us, cur_lo, cur_hi = 0.0, *spans[0]
    for lo, hi in spans[1:]:  # union of the device intervals
        if lo > cur_hi:
            busy_us += cur_hi - cur_lo
            cur_lo, cur_hi = lo, hi
        else:
            cur_hi = max(cur_hi, hi)
    busy_us += cur_hi - cur_lo
    print(
        f"  torch.profiler trace written to {path}: {len(spans)} device events, "
        f"device busy {busy_us / 1e3:.1f} ms of the {window_s * 1e3:.1f} ms "
        f"traced prove ({100 * busy_us / 1e6 / window_s:.1f}%; the trace slows "
        "the host)",
        flush=True,
    )
    rows = sorted(prof.key_averages(), key=lambda e: e.self_device_time_total,
                  reverse=True)
    print("  top operations by device time:")
    for e in rows[:10]:
        if e.self_device_time_total <= 0:
            break
        print(f"    {e.self_device_time_total / 1e3:10.2f} ms  {e.count:7d} calls  "
              f"{e.key[:90]}")


def _setup_cached(backend, circuit_info, k: int, pcs_name: str, device, seed=0):
    """Disk-cache the multilinear KZG SRS across bench runs (the other PCS
    set up afresh); `backend` is a HyperPlonk or a folding scheme.

    setup is deterministic in (seed, size), `random.Random(seed)` drives the
    trapdoor draw, so caching is sound; the fixed-base MSM that builds the SRS
    runs in plain PyTorch and gates every measurement at large k."""
    if pcs_name != "kzg":
        return backend.setup(circuit_info, random.Random(seed))
    path = srs_cache_path(k, seed)
    if os.path.exists(path):
        return load_srs(path, device)
    param = backend.setup(circuit_info, random.Random(seed))
    save_srs(path, param)
    return param


def load_srs(path: str, device):
    """A multilinear KZG SRS written by ``save_srs``, its tables on `device`."""
    import numpy as np
    import torch

    from .curves.host import AffinePoint
    from .curves.specs import BN254_G1
    from .fields.host import Fp
    from .pcs.kzg import MultilinearKzgParams

    with np.load(path) as z:
        meta = json.loads(str(z["meta"]))
        eqs = [torch.from_numpy(z[f"eq{i}"]).to(device) for i in range(meta["levels"])]
    curve = BN254_G1
    fq = curve.base

    def pt(d):
        return AffinePoint(curve, Fp(d[0], fq), Fp(d[1], fq))

    return MultilinearKzgParams(
        g1=pt(meta["g1"]), eqs=eqs, g2=_g2_from(meta["g2"]),
        ss=[_g2_from(d) for d in meta["ss"]],
    )


def save_srs(path: str, param) -> None:
    """Write a multilinear KZG SRS where ``load_srs`` reads it."""
    import numpy as np

    os.makedirs(os.path.dirname(path), exist_ok=True)
    meta = {
        "levels": len(param.eqs),
        "g1": [int(param.g1.x), int(param.g1.y)],
        "g2": _g2_to(param.g2),
        "ss": [_g2_to(s) for s in param.ss],
    }
    arrays = {f"eq{i}": e.cpu().numpy() for i, e in enumerate(param.eqs)}
    np.savez(path, meta=json.dumps(meta), **arrays)


def _append_breakdown(path: str, k: int, breakdown_ms) -> None:
    """Persist per-k category costs for the plotter's stacked bars."""
    data = {}
    if os.path.exists(path):
        with open(path) as f:
            data = json.load(f)
    data[str(k)] = breakdown_ms
    with open(path, "w") as f:
        json.dump(data, f, indent=1)


if __name__ == "__main__":
    main()
