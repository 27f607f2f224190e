"""HyperPlonk over multilinear KZG (plonkish_tpu_torch/backend/hyperplonk):
each request is one ``HyperPlonk.prove`` of the configuration's circuit for
one witness of the pool, and its answer is the proof's bytes.

The reference (reference/hyperplonk.py) verifies every proof of the window
against commitments it works out itself from the circuit and the trapdoor,
and requires each proof's witness commitments to be those of the witness
the request handed in."""

from __future__ import annotations

import contextlib
import gc
import importlib
import time
from typing import Dict, List

from .. import srs
from ..reference import hyperplonk as ref
from ..reference import mlkzg
from ..reference.field import BN254_R

FAULTS = ("witness", "answer")  # the control, and an answer altered where produced


class System:
    span = "prove"

    def __init__(self, cfg: dict, traffic, seed: int, device, cache_dir: str, fault=None):
        from plonkish_tpu_torch.backend.circuit import MockCircuit
        from plonkish_tpu_torch.backend.hyperplonk import HyperPlonk
        from plonkish_tpu_torch.fields.host import Fp
        from plonkish_tpu_torch.fields.spec import BN254_FR
        from plonkish_tpu_torch.models.circuits import vanilla_plonk_circuit_info
        from plonkish_tpu_torch.pcs.kzg import MultilinearKzg
        from plonkish_tpu_torch.utils.transcript import Keccak256Transcript

        if cfg["circuit"] != "vanilla_plonk" or cfg["pcs"] != "multilinear_kzg":
            raise ValueError("this system drives the vanilla PLONK circuit over multilinear KZG")
        if fault is not None and fault not in FAULTS:
            raise ValueError(f"unknown fault {fault!r}")
        self.cfg, self.fault, self.device = cfg, fault, device
        self.k = k = cfg["k"]
        self.phases = {}
        t = time.perf_counter()
        with _without_gc():  # the inputs are tens of millions of objects that live to the end
            gen = importlib.import_module(f"..circuits.{cfg['circuit']}", __package__)
            self.circuit = gen.circuit(k, seed)
            t = self._phase("circuit", t)
            self.witnesses = [gen.witness(self.circuit, seed, j) for j in range(traffic.inputs)]
            t = self._phase("witnesses", t)

            def fps(values):
                """The program's field elements, one object a value, as the
                upstream's generator shares them (a copy is the same object)."""
                made = {}
                return [made.get(v) or made.setdefault(v, Fp(v, BN254_FR)) for v in values]

            info = vanilla_plonk_circuit_info(BN254_FR, k, k,
                                              [fps(s) for s in self.circuit.selectors],
                                              self.circuit.cycles)
            self.circuits = []
            for instances, cols in self.witnesses:
                cols = [list(c) for c in cols]
                if fault == "witness":  # one gate of the witness no longer holds
                    cols[2][3] = (cols[2][3] + 1) % BN254_R
                self.circuits.append(MockCircuit([fps(instances)], [fps(c) for c in cols]))
            t = self._phase("program_inputs", t)
        pcs = MultilinearKzg(device=device)
        self.backend = HyperPlonk(pcs)
        param = srs.load_or_setup(cache_dir, k, cfg["srs_seed"], pcs,
                                  lambda rng: self.backend.setup(info, rng), device)
        t = self._phase("srs", t)
        self.pp, _ = self.backend.preprocess(param, info)
        del param, info
        self._phase("preprocess", t)
        self._transcript = lambda: Keccak256Transcript(BN254_FR)

    def _phase(self, name: str, t0: float) -> float:
        t = time.perf_counter()
        self.phases[name] = t - t0
        return t

    def warm_up(self) -> None:
        t = time.perf_counter()
        self.run(self.prepare_index(0))
        self._phase("warm_up", t)

    def prepare(self, req):
        return self.prepare_index(req.input_index)

    def prepare_index(self, j: int):
        return self.circuits[j]

    def run(self, circuit) -> bytes:
        import torch

        transcript = self._transcript()
        self.backend.prove(self.pp, circuit, transcript)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        proof = transcript.into_proof()
        if self.fault == "answer":
            i = len(proof) // 2
            proof = proof[:i] + bytes([proof[i] ^ 1]) + proof[i + 1:]
        return proof

    def release(self) -> None:
        self.pp = self.circuits = self.backend = None

    def check(self, answers: Dict[int, bytes], requests: List) -> List[tuple]:
        """(name, value, limit) of each number compared."""
        c = self.circuit
        s = mlkzg.trapdoor(self.k, self.cfg["srs_seed"])
        eq = mlkzg.eq_table(s)
        vk = ref.verifier_key(
            ref.vanilla_plonk_info(self.k, self.k, [6, 7, 8]),
            [mlkzg.commit(col, eq) for col in c.selectors],
            [mlkzg.commit(col, eq) for col in c.sigmas], s)
        witness_comms = {}
        rejected = 0
        for i, proof in answers.items():
            j = requests[i].input_index
            if j not in witness_comms:
                witness_comms[j] = [mlkzg.commit(col, eq) for col in self.witnesses[j][1]]
            try:
                ref.verify(vk, [self.witnesses[j][0]], proof, witness_comms[j])
            except (ValueError, EOFError):
                rejected += 1
        return [("proofs_rejected", rejected, 0)]


@contextlib.contextmanager
def _without_gc():
    was = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if was:
            gc.enable()
