"""The port's benchmark harness through its CLI entry point on the CPU at tiny
k, mirroring tests/test_benchmark_cli.py: every system and circuit it offers
runs end to end and writes its rows in the reference's formats, a choice that
is not ported yet is refused by argparse, and the zero_check system's
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


@pytest.mark.parametrize("argv", [
    ["--circuit", "aggregation"], ["--system", "univariate_plonk"], ["--circuit", "sha256"],
    ["--system", "protostar", "--circuit", "sha256"], ["--backend", "jax"], ["--mesh", "1,2"],
])
def test_cli_refuses_what_is_not_ported(argv, capsys):
    with pytest.raises(SystemExit) as e:
        benchmark.main(["--device", "cpu", "--k", "5..6", *argv])
    assert e.value.code == 2
    err = capsys.readouterr().err
    assert "invalid choice" in err or "unrecognized arguments" in err
    assert not os.path.exists("target/bench_torch/hyperplonk")


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
    monkeypatch.setattr(benchmark, "source_fingerprint", lambda sources: "0" + real(sources)[1:])
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
