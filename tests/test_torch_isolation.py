"""The port stands alone: it imports neither JAX nor anything of the JAX
package, its entry points default to the CUDA card and raise without one,
and chip_smoke.py imports neither."""

import ast
import pathlib
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent

PROBE = r"""
import random, sys
from plonkish_tpu_torch.backend.hyperplonk import HyperPlonk
from plonkish_tpu_torch.fields.spec import BN254_FR
from plonkish_tpu_torch.models.circuits import rand_vanilla_plonk_circuit
from plonkish_tpu_torch.pcs.kzg import MultilinearKzg
from plonkish_tpu_torch.utils.transcript import Keccak256Transcript

ci, circuit = rand_vanilla_plonk_circuit(BN254_FR, 3, random.Random(1), random.Random(2))
backend = HyperPlonk(MultilinearKzg(device="cpu"))
pp, vp = backend.preprocess(backend.setup(ci, random.Random(0)), ci)
tr = Keccak256Transcript(BN254_FR)
backend.prove(pp, circuit, tr)
backend.verify(vp, circuit.instances(), Keccak256Transcript.from_proof(BN254_FR, tr.into_proof()))
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "plonkish_tpu" or m.startswith("plonkish_tpu."))
print("LOADED", bad)
"""


def test_prove_loads_no_jax():
    out = subprocess.run(
        [sys.executable, "-c", PROBE], cwd=ROOT, capture_output=True, text=True, timeout=600,
    )
    assert out.returncode == 0, out.stderr
    assert "LOADED []" in out.stdout, out.stdout


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


SOURCES = [ROOT / "chip_smoke.py"] + [
    p for p in (ROOT / "plonkish_tpu_torch").rglob("*.py") if "_build" not in p.parts
]


@pytest.mark.parametrize("path", sorted(SOURCES), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    for name in _imports(path):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "plonkish_tpu"), f"{path} imports {name}"


def test_entry_points_default_to_cuda():
    from plonkish_tpu_torch import resolve_device
    from plonkish_tpu_torch.pcs.kzg import MultilinearKzg

    if torch.cuda.is_available():
        assert MultilinearKzg().device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        MultilinearKzg()
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    assert MultilinearKzg(device="cpu").device.type == "cpu"


def test_wrappers_take_plain_only_on_cpu():
    """A wrapper given a tensor on another device launches its kernel or
    raises; it never falls back to the plain version."""
    from plonkish_tpu_torch.fields import limb
    from plonkish_tpu_torch.fields.spec import BN254_FR
    from plonkish_tpu_torch.kernels import sumcheck as ksc

    state = limb.zeros((1, 4))
    meta = state.to("meta")
    with pytest.raises((RuntimeError, ValueError, NotImplementedError)):
        ksc.fold(BN254_FR, meta, limb.const(BN254_FR, 3))
