"""The prove cell's entries (``prove_cell.json``) added to a copy of
``BENCHMARK.json``, as the change that declares the cell would add them: its
``prove_s`` runs spread wider than a bound can hold (PERF.md, Open
questions), so the cell is built and tested but not declared.  Its
``prove_s`` bound there holds no measurement: the declaring change sets it
from its own sets of runs."""

import json
import os

import pytest

from proofbench import harness


@pytest.fixture(scope="session")
def spec_path(tmp_path_factory):
    spec = harness.load_spec()
    with open(os.path.join(os.path.dirname(__file__), "prove_cell.json")) as f:
        for key, entries in json.load(f).items():
            spec[key] += entries
    path = tmp_path_factory.mktemp("spec") / "BENCHMARK.json"
    path.write_text(json.dumps(spec))
    return str(path)
