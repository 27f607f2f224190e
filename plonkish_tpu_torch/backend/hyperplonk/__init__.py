"""HyperPlonk backend: multilinear PLONKish SNARK over a multilinear PCS
(port of plonkish_tpu/backend/hyperplonk/__init__.py).

Orchestration mirrors plonkish_backend/src/backend/hyperplonk.rs:85-362
(challenge schedule, commitment ordering, zero-check, batch open), with the
same span names as the reference.  Every tensor lives on the PCS's device
(``pcs.device``): CUDA unless the PCS was built with ``device="cpu"``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Tuple

from ...fields.host import Fp
from ...fields.spec import FieldSpec
from ...poly.multilinear import MLPoly
from ...utils.expression import Expression
from ...utils.timer import span
from ...utils.transcript import Keccak256Transcript
from ..circuit import PlonkishCircuit, PlonkishCircuitInfo
from . import preprocessor, prover, verifier
from .preprocessor import batch_size, compose, permutation_polys
from .prover import (
    instance_polys,
    lookup_compressed_polys,
    lookup_h_polys,
    lookup_m_polys,
    permutation_z_polys,
    prove_zero_check,
)
from .verifier import verify_zero_check


@dataclasses.dataclass
class HyperPlonkProverParam:
    pcs: Any
    num_instances: List[int]
    num_witness_polys: List[int]
    num_challenges: List[int]
    lookups: List
    num_permutation_z_polys: int
    num_vars: int
    expression: Expression
    preprocess_polys: List[MLPoly]
    preprocess_comms: List[Any]
    permutation_polys: List[Tuple[int, MLPoly]]
    permutation_comms: List[Any]
    spec: FieldSpec = None


@dataclasses.dataclass
class HyperPlonkVerifierParam:
    pcs: Any
    num_instances: List[int]
    num_witness_polys: List[int]
    num_challenges: List[int]
    num_lookups: int
    num_permutation_z_polys: int
    num_vars: int
    expression: Expression
    preprocess_comms: List[Any]
    permutation_comms: List[Tuple[int, Any]]
    spec: FieldSpec = None


class HyperPlonk:
    def __init__(self, pcs):
        self.pcs = pcs

    # ------------------------------------------------------------------ setup
    def setup(self, circuit_info: PlonkishCircuitInfo, rng):
        assert circuit_info.is_well_formed()
        poly_size = 1 << circuit_info.k
        return self.pcs.setup(poly_size, batch_size(circuit_info), rng)

    def preprocess(self, param, circuit_info: PlonkishCircuitInfo):
        assert circuit_info.is_well_formed()
        spec = circuit_info.field_spec or _default_spec()
        num_vars = circuit_info.k
        poly_size = 1 << num_vars
        pcs_pp, pcs_vp = self.pcs.trim(param, poly_size, batch_size(circuit_info))

        device = self.pcs.device
        preprocess_polys = [
            MLPoly.from_fps(spec, col, device)
            for col in circuit_info.preprocess_polys
        ]
        preprocess_comms = self.pcs.batch_commit(pcs_pp, preprocess_polys)

        perm_poly_indices = circuit_info.permutation_polys()
        perm_polys = permutation_polys(
            spec, num_vars, perm_poly_indices, circuit_info.permutations, device
        )
        permutation_comms = self.pcs.batch_commit(pcs_pp, perm_polys)

        num_permutation_z_polys, expression = compose(circuit_info)
        pp = HyperPlonkProverParam(
            pcs=pcs_pp,
            num_instances=circuit_info.num_instances,
            num_witness_polys=circuit_info.num_witness_polys,
            num_challenges=circuit_info.num_challenges,
            lookups=circuit_info.lookups,
            num_permutation_z_polys=num_permutation_z_polys,
            num_vars=num_vars,
            expression=expression,
            preprocess_polys=preprocess_polys,
            preprocess_comms=preprocess_comms,
            permutation_polys=list(zip(perm_poly_indices, perm_polys)),
            permutation_comms=permutation_comms,
            spec=spec,
        )
        vp = HyperPlonkVerifierParam(
            pcs=pcs_vp,
            num_instances=circuit_info.num_instances,
            num_witness_polys=circuit_info.num_witness_polys,
            num_challenges=circuit_info.num_challenges,
            num_lookups=len(circuit_info.lookups),
            num_permutation_z_polys=num_permutation_z_polys,
            num_vars=num_vars,
            expression=expression,
            preprocess_comms=preprocess_comms,
            permutation_comms=list(zip(perm_poly_indices, permutation_comms)),
            spec=spec,
        )
        return pp, vp

    # ------------------------------------------------------------------ prove
    def prove(
        self,
        pp: HyperPlonkProverParam,
        circuit: PlonkishCircuit,
        transcript: Keccak256Transcript,
    ) -> None:
        # the request's root span: the phases below nest under it
        with span(f"hyperplonk_prove-{pp.num_vars}", request=True):
            self._prove(pp, circuit, transcript)

    def _prove(self, pp, circuit, transcript) -> None:
        spec = pp.spec
        device = self.pcs.device
        instances = circuit.instances()
        for num_instances, column in zip(pp.num_instances, instances):
            if len(column) != num_instances:
                raise ValueError("instance column length mismatch")
            for instance in column:
                transcript.common_field_element(instance)
        inst_polys = instance_polys(spec, pp.num_vars, instances, device)

        # Phase rounds: witness commit + challenges
        witness_polys: List[MLPoly] = []
        witness_comms = []
        challenges: List[Fp] = []
        for round_, (num_witness, num_challenges) in enumerate(
            zip(pp.num_witness_polys, pp.num_challenges)
        ):
            with span(f"witness_collector-{round_}"):
                columns = circuit.synthesize(round_, challenges)
                polys = [MLPoly.from_fps(spec, col, device) for col in columns]
            assert len(polys) == num_witness
            with span(f"witness_commit-{round_}"):
                witness_comms.extend(
                    self.pcs.batch_commit_and_write(pp.pcs, polys, transcript)
                )
            witness_polys.extend(polys)
            challenges.extend(transcript.squeeze_challenges(num_challenges))

        polys = inst_polys + pp.preprocess_polys + witness_polys

        # Round n: beta, lookup m polys
        beta = transcript.squeeze_challenge()
        max_lookup_width = max((len(l) for l in pp.lookups), default=0)
        betas = _powers(beta, max_lookup_width)
        with span(f"lookup_compressed_polys-{len(pp.lookups)}"):
            lookup_compressed = lookup_compressed_polys(
                spec, pp.lookups, polys, challenges, betas
            )
        with span(f"lookup_m_polys-{len(pp.lookups)}"):
            m_polys = lookup_m_polys(lookup_compressed)
        m_comms = self.pcs.batch_commit_and_write(pp.pcs, m_polys, transcript)

        # Round n+1: gamma, lookup h + permutation z polys
        gamma = transcript.squeeze_challenge()
        with span(f"lookup_h_polys-{len(pp.lookups)}"):
            h_polys = lookup_h_polys(lookup_compressed, m_polys, gamma)
        with span(f"permutation_z_polys-{len(pp.permutation_polys)}"):
            z_polys = permutation_z_polys(
                pp.num_permutation_z_polys,
                pp.permutation_polys,
                polys,
                beta,
                gamma,
            )
        h_z_polys = h_polys + z_polys
        h_z_comms = self.pcs.batch_commit_and_write(pp.pcs, h_z_polys, transcript)

        # Round n+2: alpha, y, zero check
        alpha = transcript.squeeze_challenge()
        y = transcript.squeeze_challenges(pp.num_vars)

        all_polys = (
            polys
            + [poly for _, poly in pp.permutation_polys]
            + m_polys
            + h_z_polys
        )
        challenges = challenges + [beta, gamma, alpha]
        with span("zero_check"):
            points, evals = prove_zero_check(
                len(pp.num_instances),
                pp.expression,
                all_polys,
                challenges,
                y,
                transcript,
            )

        # PCS batch open (commitment order: dummy instances, preprocess,
        # witness, permutation, lookup m, lookup h + permutation z)
        dummy_comm = self.pcs.dummy_commitment()
        comms = (
            [dummy_comm] * len(pp.num_instances)
            + pp.preprocess_comms
            + witness_comms
            + pp.permutation_comms
            + m_comms
            + h_z_comms
        )
        with span(f"pcs_batch_open-{len(evals)}"):
            self.pcs.batch_open(
                pp.pcs, all_polys, comms, points, evals, transcript
            )

    # ----------------------------------------------------------------- verify
    def verify(
        self,
        vp: HyperPlonkVerifierParam,
        instances: List[List[Fp]],
        transcript: Keccak256Transcript,
    ) -> None:
        spec = vp.spec
        for num_instances, column in zip(vp.num_instances, instances):
            if len(column) != num_instances:
                raise ValueError("instance column length mismatch")
            for instance in column:
                transcript.common_field_element(instance)

        witness_comms = []
        challenges: List[Fp] = []
        for num_polys, num_challenges in zip(
            vp.num_witness_polys, vp.num_challenges
        ):
            witness_comms.extend(
                self.pcs.read_commitments(vp.pcs, num_polys, transcript)
            )
            challenges.extend(transcript.squeeze_challenges(num_challenges))

        beta = transcript.squeeze_challenge()
        m_comms = self.pcs.read_commitments(vp.pcs, vp.num_lookups, transcript)

        gamma = transcript.squeeze_challenge()
        h_z_comms = self.pcs.read_commitments(
            vp.pcs, vp.num_lookups + vp.num_permutation_z_polys, transcript
        )

        alpha = transcript.squeeze_challenge()
        y = transcript.squeeze_challenges(vp.num_vars)

        challenges = challenges + [beta, gamma, alpha]
        points, evals = verify_zero_check(
            spec,
            vp.num_vars,
            vp.expression,
            instances,
            challenges,
            y,
            transcript,
        )

        dummy_comm = self.pcs.dummy_commitment()
        comms = (
            [dummy_comm] * len(vp.num_instances)
            + vp.preprocess_comms
            + witness_comms
            + [comm for _, comm in vp.permutation_comms]
            + m_comms
            + h_z_comms
        )
        self.pcs.batch_verify(vp.pcs, comms, points, evals, transcript)


def _powers(base: Fp, n: int) -> List[Fp]:
    out = []
    acc = Fp.one(base.spec)
    for _ in range(n):
        out.append(acc)
        acc = acc * base
    return out


def _default_spec():
    from ...fields.spec import BN254_FR

    return BN254_FR
