"""Whole runs of the benchmark's cells at a tiny k through the port's
``device="cpu"`` paths: the traffic, the metric readers, the last line's
shape, the check that decides ``correct`` with every fault of the cells
planted under the timed path, and a new configuration found by its name.

    python -m pytest -p no:cacheprovider proofbench/tests

The test marked ``gpu`` runs one short window on the card and skips without
one (decided in a fixture)."""

import json
import os
import subprocess
import sys

import pytest
import torch

from proofbench import harness, srs

REPO = harness.REPO
PROVE, COMMIT = "hyperplonk_kzg_vanilla_k20.prove", "mlkzg_bn254_k20.commit"
SEED = 2**31 + 1234567  # the driver's seeds are large

# The prove cell is not in BENCHMARK.json yet (PERF.md, Open questions): its
# entries, as a later change would add them.
PROVE_ENTRIES = {
    "configs": [{"name": "hyperplonk_kzg_vanilla_k20", "source": "proof_system.rs",
                 "file": "proofbench/configs/hyperplonk_kzg_vanilla_k20.json", "reduced": [],
                 "why": "HyperPlonk over multilinear KZG"}],
    "workloads": [{"name": PROVE, "config": "hyperplonk_kzg_vanilla_k20", "traffic": "prove",
                   "chips": 1, "why": "one prover, closed loop"}],
    "end_to_end": [{"name": "prove_s", "unit": "s", "better": "lower", "bound": 0.25,
                    "source": "host_clock", "workloads": [PROVE]}],
    "per_layer": [{"name": name, "unit": unit, "better": "lower", "source": source,
                   "layer": "layer", "moves": "prove_s", "workloads": [PROVE]}
                  for name, unit, source in [
                      ("witness_ms", "ms", "program_span"), ("permutation_ms", "ms", "program_span"),
                      ("zero_check_ms", "ms", "program_span"), ("batch_open_ms", "ms", "program_span"),
                      ("device_idle_pct.prove", "%", "device_trace")]],
}


@pytest.fixture(scope="module")
def spec_path(tmp_path_factory):
    spec = harness.load_spec()
    for key, entries in PROVE_ENTRIES.items():
        spec[key] += entries
    path = tmp_path_factory.mktemp("spec") / "BENCHMARK.json"
    path.write_text(json.dumps(spec))
    return str(path)


def run(workload, tmp_path, trace=False, fault=None, k=4, seconds=0.2, spec_path=None, **kw):
    return harness.run(workload, SEED, seconds, trace, device="cpu", config_overrides={"k": k},
                       cache_dir=str(tmp_path / "cache"), fault=fault, spec_path=spec_path, **kw)


def shape(result, names):
    assert list(result)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(result)[-1] == "checks"
    assert set(result["metrics"]) == set(names)
    for m in result["metrics"].values():
        assert set(m) == {"value", "unit"} and isinstance(m["value"], float)
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(result["device"])
    for c in result["checks"].values():
        assert set(c) == {"value", "limit"}
    json.dumps(result)


def test_prove_traced_reads_every_span_metric(tmp_path, spec_path):
    result = run(PROVE, tmp_path, trace=True, spec_path=spec_path)
    assert result["correct"] and result["failed"] == 0 and result["attempted"] >= 1
    assert result["checks"]["proofs_rejected"] == {"value": 0, "limit": 0}
    # no card: the device-trace readers find nothing to read and stay silent
    shape(result, ["witness_ms", "permutation_ms", "zero_check_ms", "batch_open_ms"])
    assert all(m["value"] > 0 for m in result["metrics"].values())


def test_prove_untraced_reads_end_to_end_metrics(tmp_path, spec_path):
    result = run(PROVE, tmp_path, spec_path=spec_path)
    assert result["correct"]
    shape(result, ["prove_s", "setup_s"])


def test_commit_untraced_reads_end_to_end_metrics(tmp_path):
    result = run(COMMIT, tmp_path, seconds=2.0)
    assert result["correct"] and result["attempted"] >= 2
    # peak_mem_gib is read from the card's allocator: silent on the CPU
    shape(result, ["commit_ms", "setup_s"])
    # the SRS was made once and is found by the next run
    assert os.listdir(tmp_path / "cache") == ["mlkzg_bn254_k4_seed1.pt"]
    assert run(COMMIT, tmp_path)["correct"]


@pytest.mark.parametrize("stale", ["unreadable", "other_tables"])
def test_an_srs_cache_that_does_not_fit_is_made_again(tmp_path, stale):
    from plonkish_tpu_torch.pcs.kzg import MultilinearKzg

    pcs = MultilinearKzg(device="cpu")
    made = []

    def setup(rng):
        made.append(1)
        return pcs.setup(1 << 4, 1, rng)

    cache = str(tmp_path / "cache")
    param = srs.load_or_setup(cache, 4, 1, pcs, setup, "cpu")
    assert srs.load_or_setup(cache, 4, 1, pcs, setup, "cpu") is not None and len(made) == 1
    file = srs.path(cache, 4, 1)
    if stale == "unreadable":  # as a file of classes the program no longer has
        with open(file, "wb") as f:
            f.write(b"not a parameters object")
    else:  # the tables in another layout: the limbs of each point in turn reversed
        param.eqs = [e.flip(-1) for e in param.eqs]
        torch.save(param, file)
    again = srs.load_or_setup(cache, 4, 1, pcs, setup, "cpu")
    assert len(made) == 2 and srs.fits(pcs, again, 4, 1, "cpu")
    assert srs.load_or_setup(cache, 4, 1, pcs, setup, "cpu") is not None and len(made) == 2


@pytest.mark.parametrize("workload,fault", [
    (PROVE, "witness"), (PROVE, "answer"),
    (COMMIT, "scalar"), (COMMIT, "half"), (COMMIT, "answer"),
])
def test_a_planted_fault_is_not_correct(tmp_path, spec_path, workload, fault):
    result = run(workload, tmp_path, fault=fault, spec_path=spec_path)
    assert result["correct"] is False
    wrong = {k: v["value"] for k, v in result["checks"].items() if v["value"] > v["limit"]}
    assert wrong and "requests_failed" not in wrong


def test_a_new_configuration_is_found_by_name(tmp_path):
    spec = harness.load_spec()
    cfg = json.load(open(os.path.join(REPO, "proofbench/configs/mlkzg_bn254_k20.json")))
    cfg["k"] = 3
    path = tmp_path / "mlkzg_bn254_k3.json"
    path.write_text(json.dumps(cfg))
    spec["configs"].append({"name": "mlkzg_bn254_k3", "source": "test", "file": str(path),
                            "reduced": ["k"], "why": "test"})
    spec["workloads"].append({"name": "mlkzg_bn254_k3.commit", "config": "mlkzg_bn254_k3",
                              "traffic": "commit", "chips": 1, "why": "test"})
    for m in spec["end_to_end"]:
        if COMMIT in m.get("workloads", []):
            m["workloads"].append("mlkzg_bn254_k3.commit")
    spec_path = tmp_path / "BENCHMARK.json"
    spec_path.write_text(json.dumps(spec))
    result = harness.run("mlkzg_bn254_k3.commit", SEED, 0.2, False, device="cpu",
                         spec_path=str(spec_path), cache_dir=str(tmp_path / "cache"))
    assert result["correct"] and set(result["metrics"]) == {"commit_ms", "setup_s"}


def test_run_without_a_card_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("the refusal is seen only where there is no card")
    p = subprocess.run([sys.executable, "-m", "proofbench.run", "--workload", COMMIT,
                        "--seed", "1", "--seconds", "1", "--trace", "0"],
                       cwd=REPO, capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_a_run_loads_no_jax_module(tmp_path):
    """A whole run in a fresh process, then its sys.modules by whole top-level name."""
    code = (
        "import sys; from proofbench import harness\n"
        f"r = harness.run({COMMIT!r}, 5, 0.2, True, device='cpu', config_overrides={{'k': 3}},"
        f" cache_dir={str(tmp_path)!r})\n"
        "assert r['correct']\n"
        "tops = {m.split('.')[0] for m in sys.modules}\n"
        "assert 'plonkish_tpu_torch' in tops\n"
        "print(sorted(tops & {'jax', 'jaxlib', 'flax', 'plonkish_tpu'}))\n"
    )
    p = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                       timeout=300)
    assert p.returncode == 0, p.stderr[-2000:]
    assert p.stdout.strip().splitlines()[-1] == "[]"


def test_forbidden_names_are_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "plonkish_tpu_torch_extra", sys)
    monkeypatch.setitem(sys.modules, "jaxish", sys)
    before = harness.forbidden_modules()
    assert not {"jaxish", "plonkish_tpu_torch_extra"} & set(before)
    monkeypatch.setitem(sys.modules, "plonkish_tpu.pcs", sys)
    assert harness.forbidden_modules() == sorted(set(before) | {"plonkish_tpu"})


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
def test_commit_cell_on_the_card(cuda, tmp_path):
    result = harness.run(COMMIT, SEED, 2.0, True, cache_dir=str(tmp_path))
    assert result["correct"] and result["device"]["platform"] == "gpu"
    assert 0 < result["metrics"]["msm_roofline_pct"]["value"] <= 100
