"""Univariate (halo2-style) vanilla-PLONK backend over univariate KZG (port of
plonkish_tpu/backend/univariate.py).

The reference's comparison system for HyperPlonk (its benchmark's
``System::Halo2``): witness and selector columns interpolated on the 2^k
subgroup H with the NTT (``poly/ntt.py``), the classic PLONK grand product
over the wire cosets k_j·H (GWC19 §5), the quotient
``(gate + α·perm + α²·L1·(z − 1)) / Z_H`` evaluated on the 4n coset
``19·H_4n`` and split into three chunks below degree n, and one batched
opening at {ζ, ωζ} through the univariate KZG's fflonk-style batch.  Proofs
equal the reference's byte for byte.

The prover keeps every column on the device in the field layer's digit form
(``int64[16, n]``) from the witness upload to the commitments.  What does
not depend on the witness is evaluated on the 4n coset once, in
``preprocess``, as halo2 keeps its fixed and permutation cosets in its
proving key: the five selectors, the three σ and L1.  ``z(ωX)`` on the coset
is ``z`` on the coset rotated by four rows (ω = ω_4n^4), so a prove runs six
NTTs of 4n points where the reference runs sixteen; the values are the
reference's, since every step is exact field arithmetic.
"""

from __future__ import annotations

import dataclasses
import itertools
import random
from typing import List, Sequence

import torch

from ..backend.circuit import PlonkishCircuit, PlonkishCircuitInfo
from ..backend.pcs_api import Evaluation
from ..fields import limb
from ..fields.host import Fp
from ..fields.spec import FieldSpec
from ..pcs.univariate_kzg import UnivariateKzg
from ..poly.ntt import coset_powers, d_coset_scale, d_ntt, root_of_unity
from ..poly.univariate import DUniPoly, powers_tensor
from ..utils.bh import BooleanHypercube
from ..utils import timer
from ..utils.timer import span
from ..utils.transcript import Keccak256Transcript

COSET_SHIFT = 19  # multiplicative shift for the extended domain (checked)
WIRE_COSETS = (1, 7, 13)  # k_j coset representatives for the three wires


@dataclasses.dataclass
class UnivariatePlonkProverParam:
    spec: FieldSpec
    k: int
    kzg_pp: object
    fixed_coeffs: List[torch.Tensor]  # 5 selector coefficient tensors [n, 8]
    sigma_coeffs: List[torch.Tensor]  # 3 permutation coefficient tensors
    fixed_comms: List[object]
    sigma_comms: List[object]
    sigma_evals: List[torch.Tensor]  # σ_j values on H (for the grand product)
    num_instances: int
    # the selectors, the σ and L1 on the 4n coset (filled by `coset_tables`)
    fixed_ext: List[torch.Tensor] = dataclasses.field(default_factory=list)
    sigma_ext: List[torch.Tensor] = dataclasses.field(default_factory=list)
    l1_ext: torch.Tensor = None


@dataclasses.dataclass
class UnivariatePlonkVerifierParam:
    spec: FieldSpec
    k: int
    kzg_vp: object
    fixed_comms: List[object]
    sigma_comms: List[object]
    num_instances: int


def instance_rows(k: int, m: int) -> List[int]:
    """The rows of H that the first m instances take:
    ``backend.hyperplonk.prover.row_mapping(k)[:m]`` without walking all 2^k
    steps of the hypercube."""
    n = 1 << k
    rows = list(itertools.islice(BooleanHypercube(k).iter(), 1, min(m, n - 1) + 1))
    return rows + [0] * (m - len(rows))


def extend(spec: FieldSpec, d_coeffs: torch.Tensor, n4: int) -> torch.Tensor:
    """Coefficient digits ``[16, n]`` -> their values on the coset
    COSET_SHIFT·H_n4, ``[16, n4]`` (the zero-padded NTT)."""
    n = d_coeffs.shape[1]
    pw = limb.unpack(coset_powers(spec, COSET_SHIFT, n4, d_coeffs.device)[:n])
    scaled = limb.d_mul(d_coeffs, pw, limb._consts(spec, d_coeffs.device))
    pad = torch.zeros((limb.D, n4 - n), dtype=scaled.dtype, device=scaled.device)
    return d_ntt(spec, torch.cat([scaled, pad], dim=1))


def coset_tables(pp: UnivariatePlonkProverParam) -> None:
    """Fill pp's coset values of the selectors, the σ and L1 (packed
    ``int32[4n, 8]``), from its coefficients."""
    spec, n = pp.spec, 1 << pp.k
    ext = lambda t: limb.pack(extend(spec, limb.unpack(t), 4 * n))  # noqa: E731
    pp.fixed_ext = [ext(c) for c in pp.fixed_coeffs]
    pp.sigma_ext = [ext(c) for c in pp.sigma_coeffs]
    device = pp.fixed_coeffs[0].device
    l1 = torch.zeros((limb.D, n), dtype=torch.int64, device=device)
    l1[:, :1] = limb._consts(spec, device)["one"]
    pp.l1_ext = limb.pack(extend(spec, d_ntt(spec, l1, inverse=True), 4 * n))


def _sigma_values(spec: FieldSpec, k: int, permutations, device) -> List[torch.Tensor]:
    """σ_j(ω^i) as Montgomery ``int32[n, 8]``: the identity k_j·ω^i where the
    cell is not copied, else the id of the next cell of its copy cycle
    (GWC19; reference permutation_polys, preprocessor.rs:172-203).  The
    identity table is built on the device; the cycles give one gather."""
    n = 1 << k
    wire_base = 1 + 5  # flat poly index of w_l
    src = list(range(3 * n))
    for cycle in permutations:
        cells = list(cycle)
        for (pa, ra), (pb, rb) in zip(cells, cells[1:] + cells[:1]):
            ja, jb = pa - wire_base, pb - wire_base
            assert 0 <= ja < 3 and 0 <= jb < 3, "copies must be on wires"
            src[ja * n + ra] = jb * n + rb
    c = limb._consts(spec, device)
    pw = limb.unpack(powers_tensor(spec, Fp(root_of_unity(spec, k), spec), n, device))
    ids = torch.cat([limb.d_mul(pw, limb.d_const(spec, kj, device), c) for kj in WIRE_COSETS],
                    dim=1)
    sigma = ids[:, torch.tensor(src, dtype=torch.int64, device=device)]
    return [limb.pack(sigma[:, j * n:(j + 1) * n]) for j in range(3)]


class UnivariatePlonk:
    """PlonkishBackend-shaped API for the univariate vanilla-PLONK system.
    Runs on the PCS's device (the card unless the PCS was given another)."""

    def __init__(self, pcs: UnivariateKzg | None = None):
        self.pcs = pcs or UnivariateKzg()
        self.field_spec = self.pcs.field_spec

    @property
    def device(self):
        return self.pcs.device

    # ------------------------------------------------------------- lifecycle
    def setup(self, circuit_info: PlonkishCircuitInfo, rng: random.Random):
        n = 1 << circuit_info.k
        return self.pcs.setup(4 * n, 1, rng)

    def preprocess(self, param, circuit_info: PlonkishCircuitInfo):
        spec = self.field_spec
        device = self.device
        k = circuit_info.k
        n = 1 << k
        assert len(circuit_info.num_instances) == 1
        assert len(circuit_info.preprocess_polys) == 5, "vanilla plonk only"
        assert sum(circuit_info.num_witness_polys) == 3
        for kj in WIRE_COSETS[1:]:
            assert pow(kj, n, spec.p) != 1, "coset rep lies in H"

        kzg_pp, kzg_vp = self.pcs.trim(param, 4 * n, 1)

        fixed_coeffs, fixed_comms = [], []
        with span("fixed"):
            for col in circuit_info.preprocess_polys:
                evals = limb.from_canonical_ints(spec, [v.v for v in col], device)
                coeffs = limb.pack(d_ntt(spec, limb.unpack(evals), inverse=True))
                fixed_coeffs.append(coeffs)
                fixed_comms.append(self.pcs.commit_coeffs(kzg_pp, coeffs))

        with span("sigma"):
            sigma_evals = _sigma_values(spec, k, circuit_info.permutations, device)
        sigma_coeffs, sigma_comms = [], []
        with span("sigma_commit"):
            for evals in sigma_evals:
                coeffs = limb.pack(d_ntt(spec, limb.unpack(evals), inverse=True))
                sigma_coeffs.append(coeffs)
                sigma_comms.append(self.pcs.commit_coeffs(kzg_pp, coeffs))

        pp = UnivariatePlonkProverParam(
            spec=spec, k=k, kzg_pp=kzg_pp,
            fixed_coeffs=fixed_coeffs, sigma_coeffs=sigma_coeffs,
            fixed_comms=fixed_comms, sigma_comms=sigma_comms,
            sigma_evals=sigma_evals,
            num_instances=circuit_info.num_instances[0],
        )
        with span("coset_tables"):
            coset_tables(pp)
        vp = UnivariatePlonkVerifierParam(
            spec=spec, k=k, kzg_vp=kzg_vp,
            fixed_comms=fixed_comms, sigma_comms=sigma_comms,
            num_instances=circuit_info.num_instances[0],
        )
        return pp, vp

    # ------------------------------------------------------------------ prove
    def prove(
        self,
        pp: UnivariatePlonkProverParam,
        circuit: PlonkishCircuit,
        transcript: Keccak256Transcript,
    ) -> None:
        spec = pp.spec
        device = pp.fixed_coeffs[0].device
        c = limb._consts(spec, device)
        k, n = pp.k, 1 << pp.k
        n4 = 4 * n
        w = root_of_unity(spec, k)
        instances = circuit.instances()[0]
        assert len(instances) == pp.num_instances
        for v in instances:
            transcript.common_field_element(v)

        mul = lambda a, b: limb.d_mul(a, b, c)  # noqa: E731
        add = lambda a, b: limb.d_add(a, b, c)  # noqa: E731
        const = lambda v: limb.d_const(spec, v, device)  # noqa: E731
        commit = lambda d: self.pcs.commit_coeffs(pp.kzg_pp, limb.pack(d))  # noqa: E731

        with span(f"univariate_plonk_prove-{k}"):
            witness = circuit.synthesize(0, [])
            assert len(witness) == 3
            wire_evals = [limb.unpack(limb.from_canonical_ints(spec, [v.v for v in col], device))
                          for col in witness]
            wire_coeffs = [d_ntt(spec, ev, inverse=True) for ev in wire_evals]
            with span("witness_commit"):
                for wc in wire_coeffs:
                    transcript.write_point(commit(wc))

            beta = transcript.squeeze_challenge()
            gamma = transcript.squeeze_challenge()

            # grand product z over rows (prefix product of ratios)
            with span("grand_product"):
                g = const(int(gamma))
                xs = limb.unpack(powers_tensor(spec, Fp(w, spec), n, device))
                num = den = None
                for j in range(3):
                    bid = mul(xs, const(int(beta) * WIRE_COSETS[j]))
                    term_n = add(wire_evals[j], add(bid, g))
                    bs = mul(limb.unpack(pp.sigma_evals[j]), const(int(beta)))
                    term_d = add(wire_evals[j], add(bs, g))
                    num = term_n if num is None else mul(num, term_n)
                    den = term_d if den is None else mul(den, term_d)
                del xs, bid, bs, term_n, term_d
                ratio = mul(num, limb.d_batch_inv(den, spec))
                del num, den
                prefix = limb.d_prefix_mul(ratio, c)  # inclusive
                z_evals = torch.cat([c["one"], prefix[:, :-1]], dim=1)
                del ratio, prefix
                z_coeffs = d_ntt(spec, z_evals, inverse=True)
                transcript.write_point(commit(z_coeffs))
            del wire_evals, z_evals

            alpha = transcript.squeeze_challenge()

            with span("quotient"):
                t_coeffs = self._quotient(pp, instances, wire_coeffs, z_coeffs,
                                          beta, gamma, alpha)
                # degree check on the device: one boolean read
                overflow = bool((t_coeffs[:, 3 * n:] != 0).any())
                timer.device_read(t_coeffs)
                if overflow:
                    raise AssertionError(
                        "quotient degree overflow — constraint system unsatisfied?")
                t_chunks = [t_coeffs[:, i * n:(i + 1) * n] for i in range(3)]
                for chunk in t_chunks:
                    transcript.write_point(commit(chunk))
                t_chunks = [limb.pack(chunk) for chunk in t_chunks]
                del t_coeffs

            zeta = transcript.squeeze_challenge()

            # evaluations and the batched opening at {ζ, ωζ}, on the device
            with span("open"):
                coeffs = (pp.fixed_coeffs + pp.sigma_coeffs
                          + [limb.pack(wc) for wc in wire_coeffs]
                          + [limb.pack(z_coeffs)] + t_chunks)
                del wire_coeffs, z_coeffs
                polys = [DUniPoly(spec, t) for t in coeffs]
                omega_zeta = zeta * Fp(w, spec)
                points = [zeta, omega_zeta]
                z_idx = 11
                values = _evaluate_many(spec, coeffs + [coeffs[z_idx]],
                                        [zeta] * len(coeffs) + [omega_zeta])
                evals = [Evaluation(i, 0, v) for i, v in enumerate(values[:-1])]
                evals.append(Evaluation(z_idx, 1, values[-1]))
                for e in evals:
                    transcript.write_field_element(e.value)
                self.pcs.batch_open(pp.kzg_pp, polys, None, points, evals, transcript)

    def _quotient(self, pp, instances, wire_coeffs, z_coeffs, beta, gamma, alpha):
        """The quotient's coefficients ``[16, 4n]`` on the coset: every
        column extended, combined and divided by Z_H, each intermediate freed
        after its last use."""
        spec = pp.spec
        device = z_coeffs.device
        c = limb._consts(spec, device)
        k, n = pp.k, 1 << pp.k
        n4 = 4 * n
        mul = lambda a, b: limb.d_mul(a, b, c)  # noqa: E731
        add = lambda a, b: limb.d_add(a, b, c)  # noqa: E731
        sub = lambda a, b: limb.d_sub(a, b, c)  # noqa: E731
        const = lambda v: limb.d_const(spec, v, device)  # noqa: E731
        ext = lambda d: extend(spec, d, n4)  # noqa: E731
        fixed = lambda i: limb.unpack(pp.fixed_ext[i])  # noqa: E731

        w_ext = [ext(wc) for wc in wire_coeffs]
        pi = torch.zeros((limb.D, n), dtype=torch.int64, device=device)
        if instances:
            rows = torch.tensor(instance_rows(k, len(instances)), device=device)
            pi[:, rows] = limb.unpack(limb.from_canonical_ints(
                spec, [v.v for v in instances], device))
        total = ext(d_ntt(spec, pi, inverse=True))
        del pi
        total = add(total, fixed(4))
        total = add(total, mul(fixed(0), w_ext[0]))
        total = add(total, mul(fixed(1), w_ext[1]))
        total = add(total, mul(fixed(2), mul(w_ext[0], w_ext[1])))
        total = add(total, mul(fixed(3), w_ext[2]))

        # coset points shift·ω4^i
        w4 = root_of_unity(spec, k + 2)
        x_ext = mul(limb.unpack(powers_tensor(spec, Fp(w4, spec), n4, device)),
                    const(COSET_SHIFT))
        g = const(int(gamma))
        z_ext = ext(z_coeffs)
        lhs = z_ext
        rhs = torch.roll(z_ext, -4, dims=1)  # z(ωX): ω = ω4^4
        for j in range(3):
            bid = mul(x_ext, const(int(beta) * WIRE_COSETS[j]))
            lhs = mul(lhs, add(w_ext[j], add(bid, g)))
            del bid
            bs = mul(limb.unpack(pp.sigma_ext[j]), const(int(beta)))
            rhs = mul(rhs, add(w_ext[j], add(bs, g)))
            del bs
        del x_ext, w_ext
        total = add(total, mul(sub(lhs, rhs), const(int(alpha))))
        del lhs, rhs
        l1_term = mul(limb.unpack(pp.l1_ext), sub(z_ext, c["one"]))
        del z_ext
        total = add(total, mul(l1_term, const(int(alpha * alpha))))
        del l1_term

        # Z_H on the coset: (shift·ω4^i)^n − 1 = shift^n·(ω4^n)^i − 1, four
        # values; row i takes value i mod 4
        mu = pow(w4, n, spec.p)  # primitive 4th root
        sh_n = pow(COSET_SHIFT, n, spec.p)
        zh_inv = [pow((sh_n * pow(mu, i, spec.p) - 1) % spec.p, spec.p - 2, spec.p)
                  for i in range(4)]
        zh_inv_t = torch.cat([const(v) for v in zh_inv], dim=1).repeat(1, n)
        t_ext = mul(total, zh_inv_t)
        del total, zh_inv_t
        return d_coset_scale(spec, d_ntt(spec, t_ext, inverse=True), COSET_SHIFT, invert=True)

    # ----------------------------------------------------------------- verify
    def verify(
        self,
        vp: UnivariatePlonkVerifierParam,
        instances,
        transcript: Keccak256Transcript,
    ) -> None:
        spec = vp.spec
        k, n = vp.k, 1 << vp.k
        w = root_of_unity(spec, k)
        insts = instances[0]
        assert len(insts) == vp.num_instances
        for v in insts:
            transcript.common_field_element(v)

        wire_comms = [transcript.read_point(self.pcs.curve) for _ in range(3)]
        beta = transcript.squeeze_challenge()
        gamma = transcript.squeeze_challenge()
        z_comm = transcript.read_point(self.pcs.curve)
        alpha = transcript.squeeze_challenge()
        t_comms = [transcript.read_point(self.pcs.curve) for _ in range(3)]
        zeta = transcript.squeeze_challenge()

        num_evals = 15 + 1
        vals = [transcript.read_field_element(spec) for _ in range(num_evals)]
        (ql, qr, qm, qo, qc, s1, s2, s3, a, b, c, z, t0, t1, t2, zw) = vals

        one = Fp.one(spec)
        zeta_n = zeta ** n
        zh = zeta_n - one
        # L1(ζ) = (ζ^n − 1) / (n (ζ − 1))
        l1 = zh * (Fp(n, spec) * (zeta - one)).inv()
        # PI(ζ) = Σ inst_j · L_{m_j}(ζ),  L_i(ζ) = ω^i (ζ^n−1) / (n (ζ−ω^i))
        rows = instance_rows(k, len(insts))
        pi = Fp.zero(spec)
        n_inv = Fp(n, spec).inv()
        for row, v in zip(rows, insts):
            wi = Fp(pow(w, row, spec.p), spec)
            li = wi * zh * n_inv * (zeta - wi).inv()
            pi = pi + v * li

        gate = ql * a + qr * b + qm * a * b + qo * c + qc + pi
        lhs = z
        rhs = zw
        for kj, (wv, sv) in zip(WIRE_COSETS, [(a, s1), (b, s2), (c, s3)]):
            lhs = lhs * (wv + beta * Fp(kj, spec) * zeta + gamma)
            rhs = rhs * (wv + beta * sv + gamma)
        perm = lhs - rhs
        total = gate + alpha * perm + alpha * alpha * (l1 * (z - one))
        t_at = t0 + zeta_n * t1 + zeta_n * zeta_n * t2
        if total != t_at * zh:
            raise ValueError("univariate plonk: quotient identity fails")

        comms = (
            vp.fixed_comms + vp.sigma_comms + wire_comms + [z_comm] + t_comms
        )
        omega_zeta = zeta * Fp(w, spec)
        points = [zeta, omega_zeta]
        evals = [Evaluation(i, 0, v) for i, v in enumerate(vals[:15])]
        evals.append(Evaluation(11, 1, zw))
        self.pcs.batch_verify(vp.kzg_vp, comms, points, evals, transcript)


def _evaluate_many(spec: FieldSpec, coeffs: Sequence[torch.Tensor], points: Sequence[Fp]):
    """f_i(x_i) for coefficient tensors ``[n, 8]`` of one length, with one
    powers table per distinct point and one read from the device."""
    device = coeffs[0].device
    c = limb._consts(spec, device)
    n = coeffs[0].shape[0]
    tables = {}
    sums = []
    for t, x in zip(coeffs, points):
        if int(x) not in tables:
            tables[int(x)] = limb.unpack(powers_tensor(spec, x, n, device))
        sums.append(limb.d_sum(limb.d_mul(limb.unpack(t), tables[int(x)], c), c))
    return [Fp(v, spec) for v in limb.to_canonical_ints(spec, limb.pack(torch.cat(sums, dim=1)))]
