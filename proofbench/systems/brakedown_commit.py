"""Multilinear Brakedown commitments (plonkish_tpu_torch/pcs/brakedown.py):
each request commits one fresh polynomial through
``MultilinearBrakedown.commit`` and its answer is the Merkle root.

The code is the setup's, drawn from ``random.Random(code_seed)``.  A
request's evaluations are drawn on the card from (seed, request index) as
raw Montgomery limbs below r, eight 32-bit words an evaluation, the form the
program stores; the reference draws the same limbs again after the window,
draws the code again from the seed, and works the roots out in plain Python
ints (reference/brakedown.py).  Only the setup, trim and commit of the PCS
are called."""

from __future__ import annotations

import random
import time
from typing import Dict, List

from ..reference import brakedown
from ..reference.field import BN254_R

FAULTS = ("scalar", "half", "answer")  # the control; half the evaluations zeroed; a root altered
TOP_LIMB_BOUND = BN254_R >> 224  # the top limb drawn below r's keeps every value below r
WARM_UP_INDEX = 1 << 21  # warm-up draws, beyond any index a window reaches


class System:
    span = "commit"

    def __init__(self, cfg: dict, traffic, seed: int, device, cache_dir: str, fault=None):
        import torch
        from plonkish_tpu_torch.fields.spec import BN254_FR
        from plonkish_tpu_torch.pcs.brakedown import MultilinearBrakedown
        from plonkish_tpu_torch.pcs.brakedown_code import BRAKEDOWN_SPEC_6
        from plonkish_tpu_torch.poly.multilinear import MLPoly

        if (cfg["pcs"], cfg["field"], cfg["spec"]) != (
                "multilinear_brakedown", "bn254_fr", "BrakedownSpec6"):
            raise ValueError("this system drives Brakedown over BN254 Fr with Spec 6")
        if fault is not None and fault not in FAULTS:
            raise ValueError(f"unknown fault {fault!r}")
        self.cfg, self.traffic, self.seed, self.device, self.fault = cfg, traffic, seed, device, fault
        self.k = k = cfg["k"]
        t = time.perf_counter()
        self.pcs = MultilinearBrakedown(BN254_FR, BRAKEDOWN_SPEC_6, device=device)
        param = self.pcs.setup(1 << k, 1, random.Random(cfg["code_seed"]))
        self.pp, _ = self.pcs.trim(param, 1 << k, 1)
        del param
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        self.phases = {"code": time.perf_counter() - t}
        self.generator = torch.Generator(device=device)
        self._poly = lambda evals: MLPoly(BN254_FR, evals)

    def draw(self, index: int):
        """The evaluations of request `index`, as the program stores them."""
        import torch

        g = self.generator.manual_seed(((self.seed % (1 << 40)) << 22) + index)
        n = 1 << self.k
        evals = torch.randint(-(1 << 31), 1 << 31, (n, 8), dtype=torch.int32,
                              generator=g, device=self.device)
        evals[:, 7] = torch.randint(0, TOP_LIMB_BOUND, (n,), dtype=torch.int32,
                                    generator=g, device=self.device)
        return evals

    def warm_up(self) -> None:
        t = time.perf_counter()
        self.run(self.prepare_draw(WARM_UP_INDEX))
        self.phases["warm_up"] = time.perf_counter() - t

    def prepare(self, req):
        return self.prepare_draw(req.input_index)

    def prepare_draw(self, index: int):
        import torch

        evals = self.draw(index)
        if self.fault == "scalar":
            evals[0, 0] ^= 1
        elif self.fault == "half":
            evals[evals.shape[0] // 2:] = 0
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return self._poly(evals)

    def run(self, poly) -> bytes:
        root = self.pcs.commit(self.pp, poly).root
        if self.fault == "answer":
            root = bytes([root[0] ^ 1]) + root[1:]
        return root

    def release(self) -> None:
        self.pp = self.pcs = None

    def check(self, answers: Dict[int, bytes], requests: List) -> List[tuple]:
        """(name, value, limit) of each number compared."""
        picked = sorted(answers)
        polys = [self.draw(requests[i].input_index).cpu().numpy() for i in picked]
        roots = brakedown.commit_roots(self.k, self.cfg["code_seed"], polys, self.cfg["spec"])
        wrong = sum(root != answers[i] for i, root in zip(picked, roots))
        return [("roots_wrong", wrong, 0)]
