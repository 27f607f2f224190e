"""Multilinear KZG commitments (plonkish_tpu_torch/pcs/kzg.py): each request
commits one fresh polynomial through ``MultilinearKzg.commit`` and its answer
is the affine point.

A request's evaluations are drawn on the card from (seed, request index) as
raw Montgomery limbs below r, eight 32-bit words an evaluation, the form the
program stores; the reference draws the same limbs again after the window
and works the commitment out from the trapdoor (reference/mlkzg.py)."""

from __future__ import annotations

import time
from typing import Dict, List

from .. import srs
from ..reference import mlkzg
from ..reference.field import BN254_Q, BN254_R

FAULTS = ("scalar", "half", "answer")  # the control; half the points left out; an answer altered
TOP_LIMB_BOUND = BN254_R >> 224  # the top limb drawn below r's keeps every value below r
WARM_UP_INDEX = 1 << 21  # warm-up draws, beyond any index a window reaches


class System:
    span = "commit"

    def __init__(self, cfg: dict, traffic, seed: int, device, cache_dir: str, fault=None):
        import torch
        from plonkish_tpu_torch.fields.spec import BN254_FR
        from plonkish_tpu_torch.pcs.kzg import MultilinearKzg
        from plonkish_tpu_torch.poly.multilinear import MLPoly

        if cfg["pcs"] != "multilinear_kzg":
            raise ValueError("this system drives multilinear KZG")
        if fault is not None and fault not in FAULTS:
            raise ValueError(f"unknown fault {fault!r}")
        self.cfg, self.traffic, self.seed, self.device, self.fault = cfg, traffic, seed, device, fault
        self.k = k = cfg["k"]
        t = time.perf_counter()
        self.pcs = MultilinearKzg(device=device)
        param = srs.load_or_setup(cache_dir, k, cfg["srs_seed"], self.pcs,
                                  lambda rng: self.pcs.setup(1 << k, 1, rng), device)
        self.pp, _ = self.pcs.trim(param, 1 << k, 1)
        del param
        self.phases = {"srs": time.perf_counter() - t}
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

    def run(self, poly):
        point = self.pcs.commit(self.pp, poly)
        answer = None if point.is_identity() else (int(point.x), int(point.y))
        if self.fault == "answer" and answer is not None:
            answer = (answer[0], BN254_Q - answer[1])
        return answer

    def release(self) -> None:
        self.pp = self.pcs = None

    def check(self, answers: Dict[int, tuple], requests: List) -> List[tuple]:
        """(name, value, limit) of each number compared."""
        eq = mlkzg.eq_table(mlkzg.trapdoor(self.k, self.cfg["srs_seed"]))
        wrong = 0
        for i, answer in answers.items():
            limbs = self.draw(requests[i].input_index).cpu().numpy()
            if mlkzg.commit_montgomery(limbs, eq) != answer:
                wrong += 1
        return [("commitments_wrong", wrong, 0)]
