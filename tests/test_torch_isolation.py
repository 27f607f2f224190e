"""The port stands alone: it imports neither JAX nor anything of the JAX
package (nor do the ranks of a sharded prove), its entry points default to
the CUDA card and raise without one, and chip_smoke.py imports neither."""

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


FOLD_PROBE = r"""
import random, sys
from plonkish_tpu_torch.accumulation.protostar import Protostar
from plonkish_tpu_torch.fields.spec import BN254_FR
from plonkish_tpu_torch.models.circuits import rand_vanilla_plonk_circuit
from plonkish_tpu_torch.pcs.kzg import MultilinearKzg
from plonkish_tpu_torch.utils.transcript import Keccak256Transcript

def make(seed):
    return rand_vanilla_plonk_circuit(BN254_FR, 3, random.Random(42), random.Random(seed))

ci, _ = make(0)
circuits = [make(100 + i)[1] for i in range(3)]
scheme = Protostar(MultilinearKzg(device="cpu"))
pp, vp = scheme.preprocess(scheme.setup(ci, random.Random(0)), ci)
acc = scheme.init_accumulator(pp)
for circuit in circuits[:2]:
    scheme.prove_accumulation_from_nark(pp, acc, circuit, Keccak256Transcript(BN254_FR))
before = acc.instance.clone()
tr = Keccak256Transcript(BN254_FR)
scheme.prove_decider_with_last_nark(pp, acc, circuits[2], tr)
scheme.verify_decider_with_last_nark(vp, before, circuits[2].instances(),
                                     Keccak256Transcript.from_proof(BN254_FR, tr.into_proof()))
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "plonkish_tpu" or m.startswith("plonkish_tpu."))
print("LOADED", bad)
"""


UNIVARIATE_PROBE = r"""
import random, sys
from plonkish_tpu_torch.backend.univariate import UnivariatePlonk
from plonkish_tpu_torch.fields.spec import BN254_FR
from plonkish_tpu_torch.models.aggregation import rand_aggregation_circuit
from plonkish_tpu_torch.models.circuits import rand_vanilla_plonk_circuit
from plonkish_tpu_torch.models.sha256 import sha256_circuit
from plonkish_tpu_torch.pcs.univariate_kzg import UnivariateKzg
from plonkish_tpu_torch.utils.transcript import Keccak256Transcript

ci, circuit = rand_vanilla_plonk_circuit(BN254_FR, 3, random.Random(1), random.Random(2))
backend = UnivariatePlonk(UnivariateKzg(device="cpu"))
pp, vp = backend.preprocess(backend.setup(ci, random.Random(0)), ci)
tr = Keccak256Transcript(BN254_FR)
backend.prove(pp, circuit, tr)
backend.verify(vp, circuit.instances(), Keccak256Transcript.from_proof(BN254_FR, tr.into_proof()))
rand_aggregation_circuit(BN254_FR, 4, random.Random(1), random.Random(2))
sha256_circuit(b"abc")
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "plonkish_tpu" or m.startswith("plonkish_tpu."))
print("LOADED", bad)
"""


SHARDED_PROBE = r"""
import random, sys
sys.path.insert(0, ROOT)
from plonkish_tpu_torch import parallel


def loaded():
    return sorted(m for m in sys.modules
                  if m == "jax" or m.startswith("jax.") or m == "plonkish_tpu"
                  or m.startswith("plonkish_tpu."))


def rank(mesh):
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
    backend.verify(vp, circuit.instances(),
                   Keccak256Transcript.from_proof(BN254_FR, tr.into_proof()))
    assert mesh.taken["sum_check"] > 0
    return loaded()


if __name__ == "__main__":
    ranks = parallel.spawn(rank, 2, "gloo", "cpu", threads=1, deadline_s=300)
    print("LOADED", sorted(set(loaded()).union(*ranks)))
"""


DEVICE_FS_PROBE = r"""
import sys
from plonkish_tpu_torch import bench, config, profile_zero_check
from plonkish_tpu_torch.piop import sum_check

sum_check.device_fs_selected = lambda state, prover: sum_check.device_fs_eligible(prover)
profile_zero_check.profile(4, "cpu", log=lambda line: None)
bench.main(["--device", "cpu", "--msm-log2", "6"])
assert config.device_fs()
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "plonkish_tpu" or m.startswith("plonkish_tpu."))
print("LOADED", bad)
"""


def _loads_no_jax(probe):
    out = subprocess.run(
        [sys.executable, "-c", probe], cwd=ROOT, capture_output=True, text=True, timeout=600,
    )
    assert out.returncode == 0, out.stderr
    assert "LOADED []" in out.stdout, out.stdout


def test_prove_loads_no_jax():
    _loads_no_jax(PROBE)


def test_fold_and_decide_loads_no_jax():
    """Two Protostar folds and a decider at k = 3, verified."""
    _loads_no_jax(FOLD_PROBE)


def test_univariate_and_models_load_no_jax():
    """A univariate PLONK prove and verify at k = 3, and the aggregation and
    sha256 circuits built through the frontend."""
    _loads_no_jax(UNIVARIATE_PROBE)


def test_device_fs_profile_and_bench_load_no_jax():
    """The zero-check profiler (host and device transcripts), the device-FS
    sum-check, config, and the bench with its native baseline."""
    _loads_no_jax(DEVICE_FS_PROBE)


def test_sharded_prove_loads_no_jax(tmp_path):
    """A HyperPlonk prove at k = 3 by two gloo ranks, verified: neither the
    ranks nor the process that started them load JAX."""
    script = tmp_path / "sharded_probe.py"
    script.write_text(SHARDED_PROBE.replace("sys.path.insert(0, ROOT)",
                                            f"sys.path.insert(0, {str(ROOT)!r})"))
    out = subprocess.run([sys.executable, str(script)], cwd=ROOT, capture_output=True,
                         text=True, timeout=600)
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
    from plonkish_tpu_torch.backend.univariate import UnivariatePlonk

    with pytest.raises(RuntimeError, match="CUDA"):
        UnivariatePlonk()
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
    from plonkish_tpu_torch.piop import fiat_shamir as fs

    def buf(*shape):
        return torch.zeros((*shape, 8), dtype=torch.int32, device="meta")

    with pytest.raises((RuntimeError, ValueError, NotImplementedError)):
        fs.round_message(BN254_FR, 3, buf(3), buf(2), torch.zeros(85, dtype=torch.int32,
                         device="meta"), buf(8), buf(2, 3), buf(5), buf(), buf(3))
    with pytest.raises((RuntimeError, ValueError, NotImplementedError)):
        fs.coeff_message(BN254_FR, buf(2), buf(), torch.zeros(85, dtype=torch.int32,
                         device="meta"), buf(), buf(4), buf())
