"""The Brakedown commit cell, brakedown_bn254_k20.commit_check2, run whole on
the CPU at k = 10 through the port's ``device="cpu"`` path: an unfaulted run
is correct, its roots equal to reference/brakedown.py's, and each planted
fault (``scalar``, ``half``, ``answer``) reads not correct.

    python -m pytest -p no:cacheprovider proofbench/tests/test_brakedown_cell.py
"""

import pytest

from proofbench import harness

CELL = "brakedown_bn254_k20.commit_check2"
SEED = 2**31 + 7654321  # seeds above 32 signed bits, as the benchmark's runs take


def run(tmp_path, fault=None, trace=False):
    return harness.run(CELL, SEED, 0.3, trace, device="cpu", config_overrides={"k": 10},
                       cache_dir=str(tmp_path / "cache"), fault=fault)


@pytest.mark.parametrize("trace", [False, True])
def test_unfaulted_run_is_correct(tmp_path, trace):
    result = run(tmp_path, trace=trace)
    assert result["correct"] and result["failed"] == 0 and result["attempted"] >= 2
    assert result["checks"] == {"requests_failed": {"value": 0, "limit": 0},
                                "roots_wrong": {"value": 0, "limit": 0}}
    # the card's allocator, stages and profiler are not there to read
    assert set(result["metrics"]) == (set() if trace else {"commit_ms", "setup_s"})


@pytest.mark.parametrize("fault", ["scalar", "half", "answer"])
def test_each_fault_reads_not_correct(tmp_path, fault):
    result = run(tmp_path, fault=fault)
    assert not result["correct"]
    assert result["checks"]["roots_wrong"]["value"] == 2
