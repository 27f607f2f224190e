"""The MSM bench entry point (plonkish_tpu_torch/bench.py), its native
baseline (ops/field_cpp.py over csrc/field_native.cpp) and the zero-check
profiler (plonkish_tpu_torch/profile_zero_check.py), on the CPU."""

import json
import pathlib
import random
import subprocess
import sys

import pytest
import torch

from plonkish_tpu_torch.curves import device as cdev
from plonkish_tpu_torch.curves import msm as tmsm
from plonkish_tpu_torch.curves.host import AffinePoint
from plonkish_tpu_torch.curves.specs import BN254_G1
from plonkish_tpu_torch.fields import limb
from plonkish_tpu_torch.fields.spec import BN254_FQ, BN254_FR

ROOT = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def field_cpp():
    from plonkish_tpu_torch.ops import field_cpp as mod

    mod.lib()  # g++ at first use
    return mod


@pytest.mark.parametrize("spec", [BN254_FR, BN254_FQ], ids=["fr", "fq"])
def test_field_ops_equal_limb(field_cpp, spec):
    rng = random.Random(3)
    vals = [0, 1, spec.p - 1] + [rng.randrange(spec.p) for _ in range(253)]
    a = limb.from_canonical_ints(spec, vals)
    b = limb.from_canonical_ints(spec, vals[::-1])
    assert torch.equal(field_cpp.add(spec, a, b), limb.add(spec, a, b))
    assert torch.equal(field_cpp.mul(spec, a, b), limb.mont_mul(spec, a, b))
    assert torch.equal(field_cpp.mul(spec, a, b[:1]), limb.mont_mul(spec, a, b[0]))


def test_ec_msm_equals_plain_msm(field_cpp):
    """2^8 points of one tiled basis (as the bench builds it) with an
    identity and zero scalars: the native Pippenger gives the port's plain
    K1 + K2 point."""
    rng = random.Random(4)
    curve = BN254_G1
    g = AffinePoint.generator(curve)
    base = [g.scalar_mul(rng.randrange(1, curve.scalar.p)) for _ in range(16)]
    basis = cdev.affine_from_host(curve, base, "cpu").repeat(16, 1, 1).contiguous()
    basis[5] = 0
    scalars = limb.from_ints([rng.randrange(curve.scalar.p) for _ in range(256)])
    scalars[7:9] = 0
    assert field_cpp.ec_msm(curve, scalars, basis) == tmsm.variable_base_msm(curve, scalars, basis)


def test_bench_prints_one_json_line():
    out = subprocess.run(
        [sys.executable, "-m", "plonkish_tpu_torch.bench", "--device", "cpu", "--msm-log2", "8"],
        cwd=ROOT, capture_output=True, text=True, timeout=600,
    )
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert set(line) == {"metric", "value", "unit", "vs_baseline", "roofline_pct",
                         "roofline_hbm_pct"}
    assert line["metric"] == "bn254_msm_2^8_throughput[cpu]" and line["unit"] == "points/s"
    assert line["value"] > 0 and line["vs_baseline"] > 0
    assert line["roofline_pct"] is None and line["roofline_hbm_pct"] is None  # no card


def test_bench_fieldmul_only():
    from plonkish_tpu_torch import bench

    line = bench.main(["--device", "cpu", "--fieldmul-only"])
    assert line["metric"] == "bn254_fr_mont_mul_throughput[cpu]" and line["value"] > 0


def test_bench_needs_the_card_unless_told(monkeypatch):
    from plonkish_tpu_torch import bench

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        bench.main(["--msm-log2", "8"])


def test_profile_zero_check_prints_every_round():
    from plonkish_tpu_torch import profile_zero_check

    lines = []
    result = profile_zero_check.profile(5, "cpu", log=lines.append)
    text = "\n".join(lines)
    for r in range(5):
        assert f"round {r:2d} size 2^{4 - r}:" in text
    assert "device FS:" in text and "fused:" in text and "same challenges and evaluations" in text
    host, dev, fused = result["host_fs"], result["device_fs"], result["fused"]
    assert len(host["rounds"]) == 5 and host["k3_ms"] is None  # CUDA events only on a card
    assert dev["rounds_ms"] > 0 and dev["device_ms"] is None
    assert fused["rounds_ms"] > 0 and fused["device_ms"] is None
