"""The port's benchmark harness through its CLI entry point on the CPU at tiny
k, mirroring tests/test_benchmark_cli.py: every system and circuit it offers
runs end to end and writes its rows in the reference's formats (the
``--mesh`` scaling sweep too), a choice that is not ported is refused by
argparse, and the zero_check system's
sum-check proof equals, byte for byte, the reference's built from the same
seeds."""

import json
import os
import random

import pytest
import torch

from plonkish_tpu_torch import benchmark, plotter

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _bench_dir(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)


def _rows(path):
    with open(path) as f:
        lines = f.read().splitlines()
    return ([l for l in lines if l.startswith("#")],
            [l for l in lines if not l.startswith("#")])


@pytest.mark.parametrize("circuit", ["vanilla_plonk", "vanilla_plonk_with_lookup"])
def test_cli_hyperplonk(circuit, capsys):
    benchmark.main(
        ["--device", "cpu", "--system", "hyperplonk", "--circuit", circuit,
         "--k", "5..6", "--samples", "1", "--breakdown"]
    )
    notes, rows = _rows("target/bench_torch/hyperplonk")
    assert len(notes) == 1 and notes[0].startswith("# run ")
    assert f"circuit={circuit} pcs=kzg device=cpu k=5..6" in notes[0]
    assert len(rows) == 1
    k, ms = rows[0].split(",")  # `k, avg_ms`
    assert int(k) == 5 and float(ms) > 0
    with open("target/bench_torch/hyperplonk.breakdown.json") as f:
        bars = json.load(f)
    assert set(bars) == {"5"} and bars["5"]["sum_check"] > 0 and bars["5"]["pcs"] > 0
    assert os.path.exists(benchmark.srs_cache_path(5, 0))
    assert benchmark.srs_cache_path(5, 0).startswith("target/srs_cache_torch/kzg_k5_seed0_")
    out = capsys.readouterr().out
    assert "k=5 pcs=kzg device=cpu: prove" in out and "cost breakdown" in out
    assert "counters (per prove): " in out and "ints_in" in out  # the tracer's counters
    # a second run reads the SRS back from the cache and appends a row
    benchmark.main(
        ["--device", "cpu", "--system", "hyperplonk", "--circuit", circuit,
         "--k", "5..6", "--samples", "1"]
    )
    notes, rows = _rows("target/bench_torch/hyperplonk")
    assert len(notes) == 2 and len(rows) == 2


def test_cli_zero_check(capsys):
    benchmark.main(
        ["--device", "cpu", "--system", "zero_check", "--k", "5..7", "--samples", "1"]
    )
    notes, rows = _rows("target/bench_torch/zero_check")
    assert len(notes) == 1 and "device=cpu" in notes[0]
    assert [int(r.split(",")[0]) for r in rows] == [5, 6]
    assert all(len(r.split(",")) == 2 and float(r.split(",")[1]) > 0 for r in rows)
    out = capsys.readouterr().out
    assert "k=5 zero_check prove avg" in out
    assert "roofline" not in out  # no card, no share of the card's roofline


def test_cli_zero_check_setup_only_then_cached(capsys):
    benchmark.main(
        ["--device", "cpu", "--system", "zero_check", "--k", "5..6", "--setup-only"]
    )
    assert os.path.exists(benchmark.setup_cache_path("vanilla_plonk", 5))
    assert not os.path.exists("target/bench_torch/zero_check")  # nothing proved
    assert "setup cached, skipping prove" in capsys.readouterr().out
    benchmark.main(
        ["--device", "cpu", "--system", "zero_check", "--k", "5..6", "--samples", "1"]
    )
    assert "setup loaded from" in capsys.readouterr().out
    assert len(_rows("target/bench_torch/zero_check")[1]) == 1


def test_cli_pcs_microbench():
    benchmark.main(
        ["--device", "cpu", "--system", "pcs", "--pcs", "kzg", "--k", "5..6",
         "--samples", "1"]
    )
    notes, rows = _rows("target/bench_torch/pcs_kzg")
    assert len(notes) == 1
    # `k, commit_ms, open_ms`
    assert len(rows) == 1 and len(rows[0].split(",")) == 3


def test_cli_plotter():
    os.makedirs("target/bench_torch", exist_ok=True)
    with open("target/bench_torch/sys_a", "w") as f:
        f.write("# run x\n5, 100.0\n6, 250.0\n6, 240.0\n")
    with open("target/bench_torch/pcs_kzg", "w") as f:
        f.write("5, 80.0, 190.0\n")  # another row format: skipped
    with open("target/bench_torch/sys_a.breakdown.json", "w") as f:
        json.dump({"5": {"sum_check": 60.0, "pcs": 40.0}}, f)
    assert plotter.read_series("target/bench_torch/sys_a") == [(5, 100.0), (6, 240.0)]
    plotter.main([])
    assert os.path.exists("target/bench_torch/plot.svg")
    assert os.path.exists("target/bench_torch/sys_a.breakdown.svg")


@pytest.mark.parametrize("argv", [["--backend", "jax"]])
def test_cli_refuses_what_is_not_ported(argv, capsys):
    with pytest.raises(SystemExit) as e:
        benchmark.main(["--device", "cpu", "--k", "5..6", *argv])
    assert e.value.code == 2
    err = capsys.readouterr().err
    assert "invalid choice" in err or "unrecognized arguments" in err
    assert not os.path.exists("target/bench_torch/hyperplonk")


def test_cli_mesh(capsys):
    """The scaling sweep on the CPU: a group of one and of two gloo ranks
    prove the zero-check at k = 5 (their proofs equal, or the harness
    raises), and the rows come back in the reference's `scaling` format."""
    benchmark.main(["--device", "cpu", "--system", "zero_check", "--mesh", "1,2",
                    "--k", "5..6", "--samples", "1"])
    notes, rows = _rows("target/bench_torch/scaling")
    assert len(notes) == 1 and "system=zero_check k=5 backend=gloo device=cpu" in notes[0]
    assert "metric=T1/TN (shared CPU, collective overhead only)" in notes[0]
    fields = [r.split(",") for r in rows]  # `k, ranks, avg_ms, efficiency_pct`
    assert [(int(f[0]), int(f[1])) for f in fields] == [(5, 1), (5, 2)]
    assert all(float(f[2]) > 0 and float(f[3]) > 0 for f in fields)
    assert float(fields[0][3]) == 100.0
    out = capsys.readouterr().out
    assert "k=5 mesh=2: avg" in out and "sharded sites {'sum_check': 1}" in out


@pytest.mark.parametrize("argv", [
    ["--system", "hyperplonk", "--mesh", "1,2"],
    ["--system", "zero_check", "--mesh", "0,2"],
    ["--system", "zero_check", "--mesh", "1,two"],
])
def test_cli_mesh_refusals(argv, capsys):
    """--mesh sweeps the zero_check system only, with rank counts of 1 or
    more: refused before anything runs."""
    with pytest.raises(SystemExit) as e:
        benchmark.main(["--device", "cpu", "--k", "5..6", *argv])
    assert e.value.code == 2
    assert "--mesh" in capsys.readouterr().err
    assert not os.path.exists("target/bench_torch/scaling")


@pytest.mark.parametrize("argv", [
    ["--system", "zero_check", "--circuit", "sha256"],
    ["--system", "zero_check", "--circuit", "aggregation"],
    ["--system", "univariate_plonk", "--circuit", "vanilla_plonk_with_lookup"],
    ["--system", "univariate_plonk", "--circuit", "sha256"],
])
def test_cli_refuses_what_the_reference_refuses(argv, capsys):
    """zero_check and univariate_plonk take vanilla PLONK only, as in the
    reference's harness: refused before anything runs."""
    with pytest.raises(SystemExit) as e:
        benchmark.main(["--device", "cpu", "--k", "8..9", *argv])
    assert e.value.code == 2
    assert "takes --circuit vanilla_plonk only" in capsys.readouterr().err
    assert not os.path.exists("target/bench_torch")


def test_cli_univariate_plonk(capsys):
    """A univariate_plonk row at k = 5 after the verifier accepted, and the
    univariate SRS cached under a name that holds the sources' fingerprint;
    a second run reads it back."""
    argv = ["--device", "cpu", "--system", "univariate_plonk", "--k", "5..6", "--samples", "1"]
    benchmark.main(argv)
    notes, rows = _rows("target/bench_torch/univariate_plonk")
    assert len(notes) == 1 and "circuit=vanilla_plonk" in notes[0]
    assert len(rows) == 1 and int(rows[0].split(",")[0]) == 5 and float(rows[0].split(",")[1]) > 0
    assert "k=5 univariate_plonk prove avg" in capsys.readouterr().out
    path = benchmark.univariate_srs_cache_path(5, 0)
    assert path.startswith("target/srs_cache_torch/univariate_kzg_k5_seed0_") and os.path.exists(path)
    mtime = os.path.getmtime(path)
    benchmark.main(argv)
    assert os.path.getmtime(path) == mtime
    assert len(_rows("target/bench_torch/univariate_plonk")[1]) == 2


def test_univariate_srs_cache_round_trips():
    """The cached univariate SRS is the one setup draws."""
    from plonkish_tpu_torch.backend.univariate import UnivariatePlonk
    from plonkish_tpu_torch.models.circuits import rand_vanilla_plonk_circuit
    from plonkish_tpu_torch.pcs.univariate_kzg import UnivariateKzg
    from plonkish_tpu_torch.fields.spec import BN254_FR

    backend = UnivariatePlonk(UnivariateKzg(device="cpu"))
    info, _ = rand_vanilla_plonk_circuit(BN254_FR, 3, random.Random(42), random.Random(4242))
    fresh = benchmark._univariate_setup_cached(backend, info, 3, torch.device("cpu"))
    cached = benchmark._univariate_setup_cached(backend, info, 3, torch.device("cpu"))
    assert torch.equal(fresh.powers_of_s_g1, cached.powers_of_s_g1)
    assert (fresh.g1, fresh.g2, fresh.s_g2) == (cached.g1, cached.g2, cached.s_g2)
    assert fresh.offset_g2 == cached.offset_g2 and fresh.offset_g2


@pytest.mark.parametrize("circuit,k", [("aggregation", 5), ("sha256", 8)])
def test_cli_hyperplonk_benchmark_circuits(circuit, k, capsys):
    """The reference's benchmark circuits under HyperPlonk: the aggregation
    ladder at k = 5 and sha256 at k = 8, the smallest k that holds a block."""
    benchmark.main(["--device", "cpu", "--system", "hyperplonk", "--circuit", circuit,
                    "--k", f"{k}..{k + 1}", "--samples", "1"])
    notes, rows = _rows("target/bench_torch/hyperplonk")
    assert len(notes) == 1 and f"circuit={circuit} pcs=kzg" in notes[0]
    assert len(rows) == 1 and int(rows[0].split(",")[0]) == k and float(rows[0].split(",")[1]) > 0
    assert f"k={k} pcs=kzg device=cpu: prove" in capsys.readouterr().out


@pytest.mark.parametrize("system", ["protostar", "sangria"])
def test_cli_folding(system, capsys):
    """Two folds at k = 5 (the fold row), then a decider the verifier
    accepted (the `# decider` row), as the reference's harness writes them;
    brakedown, which cannot combine commitments, is refused."""
    benchmark.main(["--device", "cpu", "--system", system, "--k", "5..6", "--samples", "1"])
    notes, rows = _rows(f"target/bench_torch/{system}")
    assert len(notes) == 2 and notes[0].startswith("# run ")
    assert notes[1].startswith("# decider k=5: ") and float(notes[1].split()[3]) > 0
    assert len(rows) == 1 and int(rows[0].split(",")[0]) == 5 and float(rows[0].split(",")[1]) > 0
    out = capsys.readouterr().out
    assert f"k=5 {system} fold avg" in out and "(2 folds)" in out and "(verified)" in out
    with pytest.raises(SystemExit) as e:
        benchmark.main(["--device", "cpu", "--system", system, "--pcs", "brakedown",
                        "--k", "5..6"])
    assert e.value.code == 2


def test_cache_names_hold_the_sources_fingerprint(monkeypatch, capsys):
    """A change to the sources that produce a cache changes its name, so the
    next run sets up afresh instead of reading the stale file."""
    argv = ["--device", "cpu", "--system", "zero_check", "--k", "5..6"]
    benchmark.main([*argv, "--setup-only"])
    first = benchmark.setup_cache_path("vanilla_plonk", 5)
    assert os.path.exists(first)
    srs = benchmark.srs_cache_path(5, 0)
    real = benchmark.source_fingerprint
    def edited(sources):  # another first digit, whatever the real one is
        digest = real(sources)
        return ("1" if digest[0] == "0" else "0") + digest[1:]

    monkeypatch.setattr(benchmark, "source_fingerprint", edited)
    assert benchmark.setup_cache_path("vanilla_plonk", 5) != first
    assert benchmark.srs_cache_path(5, 0) != srs
    capsys.readouterr()
    benchmark.main([*argv, "--samples", "1"])
    assert "setup loaded from" not in capsys.readouterr().out
    monkeypatch.setattr(benchmark, "source_fingerprint", real)
    benchmark.main([*argv, "--samples", "1"])
    assert "setup loaded from" in capsys.readouterr().out


def test_cli_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this checks the failure without a card")
    with pytest.raises(RuntimeError, match="CUDA"):
        benchmark.main(["--system", "zero_check", "--k", "5..6", "--samples", "1"])
    with pytest.raises(SystemExit):  # --profile traces the card only
        benchmark.main(["--device", "cpu", "--k", "5..6", "--samples", "1",
                        "--profile", "trace"])
    assert not os.path.exists("target/bench_torch/hyperplonk")


def test_failed_run_leaves_a_note():
    """A crash in the middle of a k appends `# FAILED k=...` after the header."""
    boom = RuntimeError("out of memory\nsecond line")

    def bad_circuit(*_):
        raise boom

    real = benchmark._circuit_fn
    benchmark._circuit_fn = lambda name: bad_circuit
    try:
        with pytest.raises(RuntimeError):
            benchmark.main(["--device", "cpu", "--k", "5..6", "--samples", "1"])
    finally:
        benchmark._circuit_fn = real
    notes, rows = _rows("target/bench_torch/hyperplonk")
    assert rows == [] and len(notes) == 2
    assert notes[1] == "# FAILED k=5: RuntimeError: out of memory"


def test_zero_check_proof_equals_reference():
    """The zero_check system's inputs and proof at k = 5 against the
    reference's zero_check bench (plonkish_tpu/benchmark.py) built from the
    same seeds on its native backend."""
    from plonkish_tpu.backend.hyperplonk.preprocessor import (
        compose as ref_compose, permutation_polys as ref_permutation_polys,
    )
    from plonkish_tpu.backend.hyperplonk.prover import (
        instance_polys as ref_instance_polys,
        permutation_z_polys as ref_permutation_z_polys,
    )
    from plonkish_tpu.fields import BN254_FR as ref_spec
    from plonkish_tpu.fields.host import Fp as RefFp
    from plonkish_tpu.models.circuits import rand_vanilla_plonk_circuit as ref_circuit
    from plonkish_tpu.piop.sum_check import (
        ClassicSumCheck as RefSumCheck, VirtualPolynomial as RefVirtualPolynomial,
    )
    from plonkish_tpu.poly.multilinear import MLPoly as RefMLPoly
    from plonkish_tpu.utils.transcript import Keccak256Transcript as RefTranscript
    from plonkish_tpu_torch.fields.spec import BN254_FR as spec

    k = 5
    rng = random.Random(42)
    beta, gamma, alpha = (RefFp(rng.randrange(ref_spec.p), ref_spec) for _ in range(3))
    y = [RefFp(rng.randrange(ref_spec.p), ref_spec) for _ in range(k)]
    info, circuit = ref_circuit(ref_spec, k, random.Random(42), random.Random(4242))
    num_z, expression = ref_compose(info)
    perm_idx = info.permutation_polys()
    inst = ref_instance_polys(ref_spec, k, circuit.instances())
    pre = [RefMLPoly.from_fps(ref_spec, col) for col in info.preprocess_polys]
    wit = [RefMLPoly.from_fps(ref_spec, col) for col in circuit.synthesize(0, [])]
    perm = ref_permutation_polys(ref_spec, k, perm_idx, info.permutations)
    base = inst + pre + wit
    z = ref_permutation_z_polys(num_z, list(zip(perm_idx, perm)), base, beta, gamma)
    ref_tr = RefTranscript(ref_spec)
    RefSumCheck.evaluations().prove(
        ref_spec, k,
        RefVirtualPolynomial(expression, base + perm + z, [beta, gamma, alpha], [y]),
        RefFp.zero(ref_spec), ref_tr,
    )
    want = ref_tr.into_proof()

    challenges, ours_y = benchmark.zero_check_challenges(spec, k)
    assert [int(c) for c in challenges] == [int(beta), int(gamma), int(alpha)]
    assert [int(v) for v in ours_y] == [int(v) for v in y]
    ours_expr, tables = benchmark.zero_check_tables(
        spec, k, benchmark._circuit_fn("vanilla_plonk"), challenges, torch.device("cpu")
    )
    assert len(tables) == len(base + perm + z)
    got = benchmark.zero_check_prove(spec, k, ours_expr, tables, challenges, ours_y)
    assert got.into_proof() == want
    assert len(want) == k * (expression.degree() + 1) * 32
