"""Protostar accumulation (folding) for HyperPlonk constraint systems (port of
plonkish_tpu/accumulation/protostar.py).

Mirrors plonkish_backend/src/accumulation/protostar.rs and
protostar/hyperplonk/{preprocessor,prover}.rs + hyperplonk.rs:

- strategies: NoCompressing (= Sangria) and Compressing (2023/620 §3.5);
- prove_nark: phase commits -> θ' -> lookup m -> β' -> logUp h pair -> ζ ->
  powers-of-ζ -> α';
- prove_accumulation: absorb, evaluate cross terms (full polys or compressed
  sums + the closed-form ζ cross term), commit, squeeze r, fold;
- decider: permutation z polys + relaxed-expression sum-check with claimed
  sum = compressed_e_sum, batch open incl. e_poly.

Every polynomial lives on the PCS's device (``pcs.device``).  The cross
terms are whole-hypercube expression walks (``piop/evaluator.py``), the
commitments go through the MSM (K1, K2), the decider's sum-check through K3
and K4.  Every fold step is out of place: ``ProtostarAccumulator.init`` puts
one zero polynomial in every witness slot, as the reference does.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Any, List, Optional

import torch

from ..backend.hyperplonk import HyperPlonk, HyperPlonkProverParam, _powers
from ..backend.hyperplonk.preprocessor import div_ceil, permutation_constraints
from ..backend.hyperplonk.prover import (
    instance_polys,
    lookup_compressed_polys,
    lookup_m_polys,
    permutation_z_polys,
    prove_sum_check,
)
from ..backend.hyperplonk.verifier import verify_sum_check
from ..curves.host import AffinePoint
from ..fields import limb
from ..fields.host import Fp
from ..piop.evaluator import evaluate_on_hypercube
from ..poly.multilinear import MLPoly
from ..utils import expression as ex
from ..utils.bh import BooleanHypercube
from ..utils.expression import Challenge, Expression, Query, Rotation
from ..utils.relaxed import (
    PolynomialSet,
    cross_term_expressions,
    products,
    relaxed_expression,
)
from ..utils.timer import span
from ..utils.transcript import Keccak256Transcript


class ProtostarStrategy(enum.IntEnum):
    NoCompressing = 0  # aka Sangria
    Compressing = 1


# ---------------------------------------------------------------------------
# Accumulator
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ProtostarAccumulatorInstance:
    instances: List[List[Fp]]
    witness_comms: List[Any]
    challenges: List[Fp]
    u: Fp
    e_comm: Any
    compressed_e_sum: Optional[Fp]

    def claimed_sum(self, spec) -> Fp:
        return (
            self.compressed_e_sum
            if self.compressed_e_sum is not None
            else Fp.zero(spec)
        )

    def absorb_into(self, pcs, transcript: Keccak256Transcript) -> None:
        for col in self.instances:
            transcript.common_field_elements(col)
        for comm in self.witness_comms:
            _absorb_comm(transcript, comm)
        transcript.common_field_elements(self.challenges)
        transcript.common_field_element(self.u)
        _absorb_comm(transcript, self.e_comm)
        if self.compressed_e_sum is not None:
            transcript.common_field_element(self.compressed_e_sum)

    def clone(self) -> "ProtostarAccumulatorInstance":
        return ProtostarAccumulatorInstance(
            [list(c) for c in self.instances],
            list(self.witness_comms),
            list(self.challenges),
            self.u,
            self.e_comm,
            self.compressed_e_sum,
        )


def _absorb_comm(transcript, comm):
    """A point (the identity as 64 zero bytes), a list of them (Hyrax) or a
    32-byte hash."""
    if isinstance(comm, AffinePoint):
        transcript.common_point(comm)
    elif isinstance(comm, (list, tuple)):
        for c in comm:
            _absorb_comm(transcript, c)
    elif isinstance(comm, bytes):
        transcript.common_commitment_hash(comm)
    else:
        raise TypeError(f"unknown commitment type {type(comm)}")


@dataclasses.dataclass
class ProtostarAccumulator:
    instance: ProtostarAccumulatorInstance
    witness_polys: List[MLPoly]
    e_poly: MLPoly

    @classmethod
    def init(cls, spec, strategy, k, num_instances, num_witness_polys,
             num_challenges, dummy_comm, device):
        zero = MLPoly.zero(spec, k, device)
        return cls(
            instance=ProtostarAccumulatorInstance(
                instances=[[Fp.zero(spec)] * n for n in num_instances],
                witness_comms=[dummy_comm] * num_witness_polys,
                challenges=[Fp.zero(spec)] * num_challenges,
                u=Fp.zero(spec),
                e_comm=dummy_comm,
                compressed_e_sum=_zero_sum(spec, strategy),
            ),
            witness_polys=[zero] * num_witness_polys,
            e_poly=zero,
        )

    @classmethod
    def from_nark(cls, spec, strategy, k, nark, device):
        return cls(
            instance=ProtostarAccumulatorInstance(
                instances=nark.instances,
                witness_comms=nark.witness_comms,
                challenges=nark.challenges,
                u=Fp.one(spec),
                e_comm=nark.dummy_comm,
                compressed_e_sum=_zero_sum(spec, strategy),
            ),
            witness_polys=nark.witness_polys,
            e_poly=MLPoly.zero(spec, k, device),
        )


def _zero_sum(spec, strategy) -> Optional[Fp]:
    return Fp.zero(spec) if strategy == ProtostarStrategy.Compressing else None


@dataclasses.dataclass
class PlonkishNark:
    instances: List[List[Fp]]
    challenges: List[Fp]
    witness_comms: List[Any]
    witness_polys: List[MLPoly]
    dummy_comm: Any = None


# ---------------------------------------------------------------------------
# Params
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ProtostarProverParam:
    pp: HyperPlonkProverParam
    strategy: ProtostarStrategy
    num_theta_primes: int
    num_alpha_primes: int
    num_folding_witness_polys: int
    num_folding_challenges: int
    cross_term_expressions: List[Expression]


@dataclasses.dataclass
class ProtostarVerifierParam:
    vp: Any
    strategy: ProtostarStrategy
    num_theta_primes: int
    num_alpha_primes: int
    num_folding_witness_polys: int
    num_folding_challenges: int
    num_cross_terms: int


@dataclasses.dataclass
class ProtostarExpressions:
    """What protostar_preprocess derives from the circuit alone: the
    decider's expression (the one its sum-check runs), the cross terms and
    the counts of the folded witness and challenges."""
    expression: Expression
    cross_term_expressions: List[Expression]
    num_theta_primes: int
    num_alpha_primes: int
    num_folding_witness_polys: int
    num_folding_challenges: int
    num_permutation_z_polys: int


# ---------------------------------------------------------------------------
# Preprocessor (protostar/hyperplonk/preprocessor.rs)
# ---------------------------------------------------------------------------

def _max_degree(circuit_info, lookup_constraints_):
    if lookup_constraints_ is None:
        spec = circuit_info.field_spec
        n = max((len(l) for l in circuit_info.lookups), default=1)
        dummy = [ex.Constant(Fp.zero(spec))] * n
        lookup_constraints_ = _lookup_constraints(
            circuit_info, dummy, dummy[0]
        )[0]
    return max(
        [c.degree() for c in circuit_info.constraints]
        + [c.degree() for c in lookup_constraints_]
        + ([circuit_info.max_degree] if circuit_info.max_degree else [])
        + [2]
    )


def _folding_degree(preprocess_polys, expression) -> int:
    return expression.evaluate(
        lambda _: 0,
        lambda _: 0,
        lambda q: 0 if q.poly in preprocess_polys else 1,
        lambda _: 1,
        lambda a: a,
        max,
        lambda a, b: a + b,
        lambda a, _: a,
    )


def _lookup_constraints(circuit_info, theta_primes, beta_prime):
    """Protostar logUp constraints (preprocessor.rs:345-395):
    h_input·(input+β') = 1, h_table·(table+β') = m; Σ(h_input − h_table) = 0."""
    spec = circuit_info.field_spec
    one = ex.Constant(Fp.one(spec))
    m_offset = circuit_info.num_poly() + len(circuit_info.permutation_polys())
    h_offset = m_offset + len(circuit_info.lookups)
    constraints = []
    sum_checks = []
    for lookup_idx, lookup in enumerate(circuit_info.lookups):
        m = ex.Polynomial(Query(m_offset + lookup_idx, Rotation(0)))
        h_input = ex.Polynomial(Query(h_offset + 2 * lookup_idx, Rotation(0)))
        h_table = ex.Polynomial(Query(h_offset + 2 * lookup_idx + 1, Rotation(0)))

        def compress(exprs):
            acc = exprs[0]
            for e, theta in zip(exprs[1:], theta_primes):
                acc = acc + e * theta
            return acc

        inp = compress([i for i, _ in lookup])
        tbl = compress([t for _, t in lookup])
        constraints.append(h_input * (inp + beta_prime) - one)
        constraints.append(h_table * (tbl + beta_prime) - m)
        sum_checks.append(h_input - h_table)
    return constraints, sum_checks


def _powers_of_zeta_constraint(spec, zeta_idx: int, pow_poly: int) -> Expression:
    """preprocessor.rs:397-406."""
    l_0 = ex.lagrange(0)
    l_last = ex.lagrange(-1)
    one = ex.Constant(Fp.one(spec))
    zeta = Challenge(zeta_idx)
    pow_cur = ex.Polynomial(Query(pow_poly, Rotation(0)))
    pow_next = ex.Polynomial(Query(pow_poly, Rotation(1)))
    return pow_next - (
        l_0 + l_last * zeta + (one - (l_0 + l_last)) * pow_cur * zeta
    )


def protostar_batch_size(circuit_info, strategy) -> int:
    num_lookups = len(circuit_info.lookups)
    num_perm = len(circuit_info.permutation_polys())
    md = _max_degree(circuit_info, None)
    return (
        len(circuit_info.preprocess_polys)
        + num_perm
        + sum(circuit_info.num_witness_polys)
        + num_lookups
        + (1 if strategy == ProtostarStrategy.Compressing else 0)
        + 2 * num_lookups
        + div_ceil(num_perm, md - 1)
        + 1
    )


def protostar_expressions(circuit_info, strategy) -> ProtostarExpressions:
    """The symbolic half of preprocessor.rs:51-307, host work only."""
    spec = circuit_info.field_spec
    challenge_offset = sum(circuit_info.num_challenges)
    max_lookup_width = max((len(l) for l in circuit_info.lookups), default=0)
    num_theta_primes = max(max_lookup_width - 1, 0)
    theta_primes = [
        Challenge(challenge_offset + i) for i in range(num_theta_primes)
    ]
    beta_prime = Challenge(challenge_offset + num_theta_primes)

    lookup_cons, lookup_zero_checks = _lookup_constraints(
        circuit_info, theta_primes, beta_prime
    )
    md = _max_degree(circuit_info, lookup_cons)
    num_constraints = len(circuit_info.constraints) + len(lookup_cons)
    num_alpha_primes = max(num_constraints - 1, 0)

    witness_poly_offset = (
        len(circuit_info.num_instances) + len(circuit_info.preprocess_polys)
    )
    num_witness_polys = sum(circuit_info.num_witness_polys)
    num_permutation_z_polys = div_ceil(
        len(circuit_info.permutation_polys()), md - 1
    )

    compressing = strategy == ProtostarStrategy.Compressing
    if compressing:
        zeta_idx = challenge_offset + num_theta_primes + 1
        alpha_prime_offset = zeta_idx + 1
        num_builtin_witness_polys = 3 * len(circuit_info.lookups) + 1
    else:
        zeta_idx = None
        alpha_prime_offset = challenge_offset + num_theta_primes + 1
        num_builtin_witness_polys = 3 * len(circuit_info.lookups)
    builtin_witness_poly_offset = (
        witness_poly_offset
        + num_witness_polys
        + len(circuit_info.permutation_polys())
    )

    poly_set = PolynomialSet(
        preprocess=set(
            range(
                len(circuit_info.num_instances),
                len(circuit_info.num_instances)
                + len(circuit_info.preprocess_polys),
            )
        ),
        folding=(
            set(range(len(circuit_info.num_instances)))
            | set(
                range(witness_poly_offset, witness_poly_offset + num_witness_polys)
            )
            | set(
                range(
                    builtin_witness_poly_offset,
                    builtin_witness_poly_offset + num_builtin_witness_polys,
                )
            )
        ),
    )

    # constraint compression with alpha primes; highest-folding-degree
    # constraint first (preprocessor.rs:115-141)
    constraints = list(circuit_info.constraints) + lookup_cons
    degrees = sorted(
        ((i, _folding_degree(poly_set.preprocess, c)) for i, c in
         enumerate(constraints)),
        key=lambda t: -t[1],
    )
    if len(degrees) >= 2 and degrees[0][1] != degrees[1][1]:
        a = degrees[0][0]
        constraints[0], constraints[a] = constraints[a], constraints[0]

    compressed = constraints[0]
    for c, i in zip(constraints[1:], range(alpha_prime_offset, 10 ** 9)):
        compressed = compressed + c * Challenge(i)

    num_folding_challenges = alpha_prime_offset + num_alpha_primes
    u = num_folding_challenges

    if compressing:
        pow_poly = builtin_witness_poly_offset + 3 * len(circuit_info.lookups)
        compressed = compressed * ex.Polynomial(Query(pow_poly, Rotation(0)))
        compressed_products = products(spec, poly_set.preprocess, compressed)
        zeta_constraint = _powers_of_zeta_constraint(spec, zeta_idx, pow_poly)
        zeta_products = products(spec, poly_set.preprocess, zeta_constraint)

        cte = cross_term_expressions(
            spec, poly_set, compressed_products, num_folding_challenges
        )
        relaxed_compressed = relaxed_expression(spec, compressed_products, u)
        e_poly_idx = pow_poly + num_permutation_z_polys + 1
        relaxed_zeta = relaxed_expression(spec, zeta_products, u) - ex.Polynomial(
            Query(e_poly_idx, Rotation(0))
        )
        sum_check_exprs: List[Expression] = [relaxed_compressed]
        zero_check_on_every_row = relaxed_zeta
    else:
        compressed_products = products(spec, poly_set.preprocess, compressed)
        cte = cross_term_expressions(
            spec, poly_set, compressed_products, num_folding_challenges
        )
        e_poly_idx = (
            builtin_witness_poly_offset
            + 3 * len(circuit_info.lookups)
            + num_permutation_z_polys
        )
        zero_check_on_every_row = relaxed_expression(
            spec, compressed_products, u
        ) - ex.Polynomial(Query(e_poly_idx, Rotation(0)))
        sum_check_exprs = []

    beta = Challenge(num_folding_challenges + 1)
    gamma = Challenge(num_folding_challenges + 2)
    alpha = Challenge(num_folding_challenges + 3)
    _, perm_cons = permutation_constraints(
        circuit_info, md, beta, gamma, num_builtin_witness_polys
    )

    zero_check = ex.distribute_powers(
        [zero_check_on_every_row] + perm_cons, alpha
    ) * ex.eq_xy(0)
    expression = ex.distribute_powers(
        sum_check_exprs + lookup_zero_checks + [zero_check], alpha
    )
    return ProtostarExpressions(
        expression=expression,
        cross_term_expressions=cte,
        num_theta_primes=num_theta_primes,
        num_alpha_primes=num_alpha_primes,
        num_folding_witness_polys=num_witness_polys + num_builtin_witness_polys,
        num_folding_challenges=num_folding_challenges,
        num_permutation_z_polys=num_permutation_z_polys,
    )


def protostar_preprocess(backend, param, circuit_info, strategy):
    """preprocessor.rs:51-307."""
    exprs = protostar_expressions(circuit_info, strategy)
    pp, vp = backend.preprocess(param, circuit_info)
    bs = protostar_batch_size(circuit_info, strategy)
    pcs_pp, pcs_vp = backend.pcs.trim(param, 1 << circuit_info.k, bs)
    for p, pcs_param in ((pp, pcs_pp), (vp, pcs_vp)):
        p.pcs = pcs_param
        p.num_permutation_z_polys = exprs.num_permutation_z_polys
        p.expression = exprs.expression

    counts = dict(
        strategy=strategy,
        num_theta_primes=exprs.num_theta_primes,
        num_alpha_primes=exprs.num_alpha_primes,
        num_folding_witness_polys=exprs.num_folding_witness_polys,
        num_folding_challenges=exprs.num_folding_challenges,
    )
    return (
        ProtostarProverParam(
            pp=pp, cross_term_expressions=exprs.cross_term_expressions, **counts
        ),
        ProtostarVerifierParam(
            vp=vp, num_cross_terms=len(exprs.cross_term_expressions), **counts
        ),
    )


# ---------------------------------------------------------------------------
# Prover helpers (protostar/hyperplonk/prover.rs)
# ---------------------------------------------------------------------------

def protostar_lookup_h_polys(compressed, m_polys, beta: Fp):
    """h_input = 1/(β+input), h_table = m/(β+table) (prover.rs:16-72), one
    batch inversion a lookup."""
    out = []
    for (input_poly, table_poly), m_poly in zip(compressed, m_polys):
        spec = input_poly.spec
        b = limb.const(spec, int(beta), input_poly.device)
        both = torch.cat([
            limb.add(spec, input_poly.evals, b),
            limb.add(spec, table_poly.evals, b),
        ], dim=0)
        inv = limb.batch_inv(spec, both)
        n = len(input_poly)
        out.append((
            MLPoly(spec, inv[:n]),
            MLPoly(spec, limb.mont_mul(spec, inv[n:], m_poly.evals)),
        ))
    return out


def powers_of_zeta_poly(spec, num_vars: int, zeta: Fp, device) -> MLPoly:
    """ζ^i scattered into BH order (prover.rs:74-81): a prefix product of
    [1, ζ, ζ, ...] gathered by the hypercube's nth map."""
    n = 1 << num_vars
    base = torch.cat([
        limb.one(spec, (1,), device),
        limb.const(spec, int(zeta), device).expand(n - 1, limb.L),
    ], dim=0)
    pow_vec = limb.prefix_mul(spec, base)
    nth_map = torch.as_tensor(BooleanHypercube(num_vars).nth_map, device=device)
    return MLPoly(spec, pow_vec[nth_map])


def _cross_term_inputs(spec, pp, acc, incoming):
    """polys + challenges layout for cross-term evaluation
    (prover.rs:223-262): [preprocess, acc instances, acc witness, incoming
    instances, incoming witness]; [acc challenges, acc u, incoming
    challenges, incoming u]."""
    num_vars = pp.num_vars
    device = pp.preprocess_polys[0].device
    acc_inst = instance_polys(spec, num_vars, acc.instance.instances, device)
    inc_inst = instance_polys(spec, num_vars, incoming.instance.instances, device)
    polys = (
        [p.evals for p in pp.preprocess_polys]
        + [p.evals for p in acc_inst]
        + [p.evals for p in acc.witness_polys]
        + [p.evals for p in inc_inst]
        + [p.evals for p in incoming.witness_polys]
    )
    challenges = (
        list(acc.instance.challenges)
        + [acc.instance.u]
        + list(incoming.instance.challenges)
        + [incoming.instance.u]
    )
    return polys, challenges, device


def evaluate_cross_term_polys(spec, cte, pp, acc, incoming) -> List[MLPoly]:
    if not cte:
        return []
    polys, challenges, device = _cross_term_inputs(spec, pp, acc, incoming)
    return [
        MLPoly(spec, evaluate_on_hypercube(spec, e, pp.num_vars, polys, challenges, device))
        for e in cte
    ]


def evaluate_compressed_cross_term_sums(spec, cte, pp, acc, incoming) -> List[Fp]:
    """The d - 1 cross terms summed over the hypercube, with one read from
    the device for all of them."""
    if not cte:
        return []
    polys, challenges, device = _cross_term_inputs(spec, pp, acc, incoming)
    totals = [
        limb.sum_reduce(
            spec, evaluate_on_hypercube(spec, e, pp.num_vars, polys, challenges, device)
        )
        for e in cte
    ]
    vals = limb.to_canonical_ints(spec, torch.stack(totals, dim=0))
    return [Fp(v, spec) for v in vals]


def evaluate_zeta_cross_term_poly(spec, num_vars, zeta_nth_back, acc, incoming):
    """Closed-form degree-2 cross term of the ζ recurrence incl. boundary
    patches (prover.rs:176-221), with one read of the four boundary values."""
    acc_pow = acc.witness_polys[-1].evals
    inc_pow = incoming.witness_polys[-1].evals
    device = acc_pow.device
    acc_zeta = acc.instance.challenges[-1 - zeta_nth_back]
    inc_zeta = incoming.instance.challenges[-1 - zeta_nth_back]
    acc_u = acc.instance.u
    assert incoming.instance.u == 1

    bh = BooleanHypercube(num_vars)
    next_map = torch.as_tensor(bh.rotation_map(1), device=device)

    def cst(v):
        return limb.const(spec, int(v), device)

    cross = limb.sub(
        spec,
        limb.add(spec, acc_pow[next_map], limb.mont_mul(spec, inc_pow[next_map], cst(acc_u))),
        limb.add(
            spec,
            limb.mont_mul(spec, acc_pow, cst(inc_zeta)),
            limb.mont_mul(spec, inc_pow, cst(acc_zeta)),
        ),
    )

    b_0 = 0
    b_last = bh.rotate(1, -1)
    idx = torch.as_tensor([b_0, b_last], device=device)
    bvals = limb.to_canonical_ints(spec, torch.cat([acc_pow[idx], inc_pow[idx]], dim=0))
    acc0, acc_l, inc0, inc_l = (Fp(v, spec) for v in bvals)
    patch0 = acc0 * inc_zeta + inc0 * acc_zeta - acc_u.double()
    patch_last = acc_l * inc_zeta + inc_l * acc_zeta - acc_u * inc_zeta - acc_zeta
    # `cross` is a fresh tensor: the two patches write into nothing shared
    cross[b_0] = limb.add(spec, cross[b_0], cst(patch0))
    cross[b_last] = limb.add(spec, cross[b_last], cst(patch_last))
    return MLPoly(spec, cross)


# ---------------------------------------------------------------------------
# Folding (protostar.rs:135-309)
# ---------------------------------------------------------------------------

def _fold_instance_common(pcs, lhs, rhs, r: Fp):
    one = Fp.one(r.spec)
    for li, ri in zip(lhs.instances, rhs.instances):
        for j in range(len(li)):
            li[j] = li[j] + ri[j] * r
    lhs.witness_comms = [
        pcs.combine_commitments(None, [one, r], [lc, rc])
        for lc, rc in zip(lhs.witness_comms, rhs.witness_comms)
    ]
    lhs.challenges = [
        lc + rc * r for lc, rc in zip(lhs.challenges, rhs.challenges)
    ]
    lhs.u = lhs.u + rhs.u * r


def fold_uncompressed_instance(pcs, lhs, rhs, cross_term_comms, r: Fp):
    powers_of_r = _powers(r, len(cross_term_comms) + 2)
    _fold_instance_common(pcs, lhs, rhs, r)
    lhs.e_comm = pcs.combine_commitments(
        None,
        powers_of_r,
        [lhs.e_comm] + list(cross_term_comms) + [rhs.e_comm],
    )


def fold_compressed_instance(pcs, lhs, rhs, zeta_cross_term_comm,
                             compressed_cross_term_sums, r: Fp):
    powers_of_r = _powers(r, max(len(compressed_cross_term_sums), 1) + 2)
    _fold_instance_common(pcs, lhs, rhs, r)
    lhs.e_comm = pcs.combine_commitments(
        None,
        powers_of_r[:3],
        [lhs.e_comm, zeta_cross_term_comm, rhs.e_comm],
    )
    acc_sum = lhs.compressed_e_sum
    for p_r, v in zip(
        powers_of_r[1:],
        list(compressed_cross_term_sums) + [rhs.compressed_e_sum],
    ):
        acc_sum = acc_sum + p_r * v
    lhs.compressed_e_sum = acc_sum


def _fold_witness(spec, acc, rhs, e_polys, r: Fp):
    device = acc.e_poly.device

    def cst(v):
        return limb.const(spec, int(v), device)

    r_c = cst(r)
    acc.witness_polys = [
        MLPoly(spec, limb.add(spec, l.evals, limb.mont_mul(spec, rr.evals, r_c)))
        for l, rr in zip(acc.witness_polys, rhs.witness_polys)
    ]
    e = acc.e_poly.evals
    r_pow = r
    for poly in list(e_polys) + [rhs.e_poly]:
        e = limb.add(spec, e, limb.mont_mul(spec, poly.evals, cst(r_pow)))
        r_pow = r_pow * r
    acc.e_poly = MLPoly(spec, e)


# ---------------------------------------------------------------------------
# Scheme
# ---------------------------------------------------------------------------

class Protostar:
    """AccumulationScheme over HyperPlonk (accumulation.rs:17-126).  Runs on
    the PCS's device: ``Protostar(MultilinearKzg(device="cpu"))`` on the CPU,
    the card otherwise.  Spans (``utils/timer.py``): ``nark`` and
    ``accumulation`` a fold, ``decider`` a decider, each with its parts."""

    def __init__(self, pcs, strategy=ProtostarStrategy.Compressing):
        self.pcs = pcs
        self.backend = HyperPlonk(pcs)
        self.strategy = ProtostarStrategy(strategy)

    @property
    def device(self):
        return self.pcs.device

    # ------------------------------------------------------------- lifecycle
    def setup(self, circuit_info, rng):
        assert circuit_info.is_well_formed()
        return self.pcs.setup(
            1 << circuit_info.k,
            protostar_batch_size(circuit_info, self.strategy),
            rng,
        )

    def preprocess(self, param, circuit_info):
        assert circuit_info.is_well_formed()
        return protostar_preprocess(
            self.backend, param, circuit_info, self.strategy
        )

    def init_accumulator(self, pp: ProtostarProverParam):
        return ProtostarAccumulator.init(
            pp.pp.spec,
            pp.strategy,
            pp.pp.num_vars,
            pp.pp.num_instances,
            pp.num_folding_witness_polys,
            pp.num_folding_challenges,
            self.pcs.dummy_commitment(),
            self.device,
        )

    def init_accumulator_from_nark(self, pp, nark: PlonkishNark):
        nark.dummy_comm = self.pcs.dummy_commitment()
        return ProtostarAccumulator.from_nark(
            pp.pp.spec, pp.strategy, pp.pp.num_vars, nark, self.device
        )

    # ------------------------------------------------------------ prove nark
    def prove_nark(self, pp_: ProtostarProverParam, circuit,
                   transcript) -> PlonkishNark:
        pp = pp_.pp
        spec = pp.spec
        device = self.device
        instances = circuit.instances()
        for num_instances, column in zip(pp.num_instances, instances):
            if len(column) != num_instances:
                raise ValueError("instance column length mismatch")
            for v in column:
                transcript.common_field_element(v)

        witness_polys: List[MLPoly] = []
        witness_comms = []
        challenges: List[Fp] = []
        for round_, (nw, nc) in enumerate(
            zip(pp.num_witness_polys, pp.num_challenges)
        ):
            with span(f"witness_collector-{round_}"):
                columns = circuit.synthesize(round_, challenges)
                polys = [MLPoly.from_fps(spec, col, device) for col in columns]
            assert len(polys) == nw
            with span(f"witness_commit-{round_}"):
                witness_comms.extend(
                    self.pcs.batch_commit_and_write(pp.pcs, polys, transcript)
                )
            witness_polys.extend(polys)
            challenges.extend(transcript.squeeze_challenges(nc))

        # Round n: theta primes + lookup m
        theta0 = transcript.squeeze_challenge()
        theta_primes = _powers(theta0, pp_.num_theta_primes + 1)[1:]

        inst_polys = instance_polys(spec, pp.num_vars, instances, device)
        polys = inst_polys + pp.preprocess_polys + witness_polys
        thetas = [Fp.one(spec)] + theta_primes
        with span(f"lookup_m_polys-{len(pp.lookups)}"):
            lookup_compressed = lookup_compressed_polys(
                spec, pp.lookups, polys, challenges, thetas
            )
            m_polys = lookup_m_polys(lookup_compressed)
            m_comms = self.pcs.batch_commit_and_write(pp.pcs, m_polys, transcript)

        # Round n+1: beta prime + h pair
        beta_prime = transcript.squeeze_challenge()
        with span(f"lookup_h_polys-{len(pp.lookups)}"):
            h_pairs = protostar_lookup_h_polys(
                lookup_compressed, m_polys, beta_prime
            )
            h_polys = [p for pair in h_pairs for p in pair]
            h_comms = self.pcs.batch_commit_and_write(pp.pcs, h_polys, transcript)

        # Round n+2: zeta + powers of zeta
        if pp_.strategy == ProtostarStrategy.Compressing:
            zeta = transcript.squeeze_challenge()
            with span("powers_of_zeta"):
                pow_zeta_poly = powers_of_zeta_poly(spec, pp.num_vars, zeta, device)
                pow_zeta_comm = self.pcs.commit_and_write(
                    pp.pcs, pow_zeta_poly, transcript
                )
            zeta_list, pow_polys, pow_comms = [zeta], [pow_zeta_poly], [pow_zeta_comm]
        else:
            zeta_list, pow_polys, pow_comms = [], [], []

        # Round n+3: alpha primes
        alpha0 = transcript.squeeze_challenge()
        alpha_primes = _powers(alpha0, pp_.num_alpha_primes + 1)[1:]

        return PlonkishNark(
            instances=[list(c) for c in instances],
            challenges=challenges + theta_primes + [beta_prime] + zeta_list
            + alpha_primes,
            witness_comms=witness_comms + m_comms + h_comms + pow_comms,
            witness_polys=witness_polys + m_polys + h_polys + pow_polys,
        )

    # ---------------------------------------------------------- accumulation
    def prove_accumulation(self, pp_: ProtostarProverParam, accumulator,
                           incoming, transcript,
                           is_incoming_absorbed: bool = True):
        pp = pp_.pp
        spec = pp.spec
        accumulator.instance.absorb_into(self.pcs, transcript)
        if not is_incoming_absorbed:
            incoming.instance.absorb_into(self.pcs, transcript)

        if pp_.strategy == ProtostarStrategy.NoCompressing:
            with span(f"cross_terms-{len(pp_.cross_term_expressions)}"):
                cross_polys = evaluate_cross_term_polys(
                    spec, pp_.cross_term_expressions, pp, accumulator, incoming
                )
            with span(f"cross_term_commit-{len(cross_polys)}"):
                cross_comms = self.pcs.batch_commit_and_write(
                    pp.pcs, cross_polys, transcript
                )
            r = transcript.squeeze_challenge()
            with span("fold_instance"):
                fold_uncompressed_instance(
                    self.pcs, accumulator.instance, incoming.instance,
                    cross_comms, r,
                )
            with span("fold_witness"):
                _fold_witness(spec, accumulator, incoming, cross_polys, r)
        else:
            with span(f"cross_terms-{len(pp_.cross_term_expressions)}"):
                zeta_cross = evaluate_zeta_cross_term_poly(
                    spec, pp.num_vars, pp_.num_alpha_primes, accumulator, incoming
                )
                sums = evaluate_compressed_cross_term_sums(
                    spec, pp_.cross_term_expressions, pp, accumulator, incoming
                )
            with span("cross_term_commit-1"):
                zeta_cross_comm = self.pcs.commit_and_write(
                    pp.pcs, zeta_cross, transcript
                )
            transcript.write_field_elements(sums)
            r = transcript.squeeze_challenge()
            with span("fold_instance"):
                fold_compressed_instance(
                    self.pcs, accumulator.instance, incoming.instance,
                    zeta_cross_comm, sums, r,
                )
            with span("fold_witness"):
                _fold_witness(spec, accumulator, incoming, [zeta_cross], r)

    def prove_accumulation_from_nark(self, pp, accumulator, circuit, transcript):
        with span("nark"):
            nark = self.prove_nark(pp, circuit, transcript)
        incoming = self.init_accumulator_from_nark(pp, nark)
        with span("accumulation"):
            self.prove_accumulation(
                pp, accumulator, incoming, transcript, is_incoming_absorbed=True
            )

    def verify_accumulation_from_nark(self, vp_: ProtostarVerifierParam,
                                      accumulator, instances, transcript):
        vp = vp_.vp
        spec = vp.spec
        for num_instances, column in zip(vp.num_instances, instances):
            if len(column) != num_instances:
                raise ValueError("instance column length mismatch")
            for v in column:
                transcript.common_field_element(v)

        witness_comms = []
        challenges: List[Fp] = []
        for nw, nc in zip(vp.num_witness_polys, vp.num_challenges):
            witness_comms.extend(
                self.pcs.read_commitments(vp.pcs, nw, transcript)
            )
            challenges.extend(transcript.squeeze_challenges(nc))

        theta0 = transcript.squeeze_challenge()
        theta_primes = _powers(theta0, vp_.num_theta_primes + 1)[1:]
        m_comms = self.pcs.read_commitments(vp.pcs, vp.num_lookups, transcript)

        beta_prime = transcript.squeeze_challenge()
        h_comms = self.pcs.read_commitments(
            vp.pcs, 2 * vp.num_lookups, transcript
        )

        if vp_.strategy == ProtostarStrategy.Compressing:
            zeta = transcript.squeeze_challenge()
            pow_comms = self.pcs.read_commitments(vp.pcs, 1, transcript)
            zeta_list = [zeta]
        else:
            pow_comms, zeta_list = [], []

        alpha0 = transcript.squeeze_challenge()
        alpha_primes = _powers(alpha0, vp_.num_alpha_primes + 1)[1:]

        incoming = ProtostarAccumulatorInstance(
            instances=[list(c) for c in instances],
            witness_comms=witness_comms + m_comms + h_comms + pow_comms,
            challenges=challenges + theta_primes + [beta_prime] + zeta_list
            + alpha_primes,
            u=Fp.one(spec),
            e_comm=self.pcs.dummy_commitment(),
            compressed_e_sum=_zero_sum(spec, vp_.strategy),
        )
        accumulator.absorb_into(self.pcs, transcript)

        if vp_.strategy == ProtostarStrategy.NoCompressing:
            cross_comms = self.pcs.read_commitments(
                vp.pcs, vp_.num_cross_terms, transcript
            )
            r = transcript.squeeze_challenge()
            fold_uncompressed_instance(
                self.pcs, accumulator, incoming, cross_comms, r
            )
        else:
            zeta_cross_comm = self.pcs.read_commitments(vp.pcs, 1, transcript)[0]
            sums = transcript.read_field_elements(vp_.num_cross_terms)
            r = transcript.squeeze_challenge()
            fold_compressed_instance(
                self.pcs, accumulator, incoming, zeta_cross_comm, sums, r
            )

    # --------------------------------------------------------------- decider
    def prove_decider(self, pp_: ProtostarProverParam, accumulator, transcript):
        with span("decider"):
            self._prove_decider(pp_, accumulator, transcript)

    def _prove_decider(self, pp_: ProtostarProverParam, accumulator, transcript):
        pp = pp_.pp
        spec = pp.spec
        accumulator.instance.absorb_into(self.pcs, transcript)

        beta = transcript.squeeze_challenge()
        gamma = transcript.squeeze_challenge()

        builtin_offset = sum(pp.num_witness_polys)
        inst_polys = instance_polys(
            spec, pp.num_vars, accumulator.instance.instances, self.device
        )
        polys = (
            inst_polys
            + pp.preprocess_polys
            + accumulator.witness_polys[:builtin_offset]
            + [poly for _, poly in pp.permutation_polys]
        )
        with span(f"permutation_z_polys-{len(pp.permutation_polys)}"):
            z_polys = permutation_z_polys(
                pp.num_permutation_z_polys, pp.permutation_polys, polys, beta, gamma
            )
            z_comms = self.pcs.batch_commit_and_write(pp.pcs, z_polys, transcript)

        alpha = transcript.squeeze_challenge()
        y = transcript.squeeze_challenges(pp.num_vars)

        all_polys = (
            polys
            + accumulator.witness_polys[builtin_offset:]
            + z_polys
            + [accumulator.e_poly]
        )
        challenges = (
            list(accumulator.instance.challenges)
            + [accumulator.instance.u]
            + [beta, gamma, alpha]
        )
        with span("sum_check"):
            points, evals = prove_sum_check(
                len(pp.num_instances),
                pp.expression,
                accumulator.instance.claimed_sum(spec),
                all_polys,
                challenges,
                y,
                transcript,
            )

        dummy_comm = self.pcs.dummy_commitment()
        comms = (
            [dummy_comm] * len(pp.num_instances)
            + pp.preprocess_comms
            + accumulator.instance.witness_comms[:builtin_offset]
            + pp.permutation_comms
            + accumulator.instance.witness_comms[builtin_offset:]
            + z_comms
            + [accumulator.instance.e_comm]
        )
        with span(f"pcs_batch_open-{len(evals)}"):
            self.pcs.batch_open(pp.pcs, all_polys, comms, points, evals, transcript)

    def prove_decider_with_last_nark(self, pp, accumulator, circuit, transcript):
        self.prove_accumulation_from_nark(pp, accumulator, circuit, transcript)
        self.prove_decider(pp, accumulator, transcript)

    def verify_decider(self, vp_: ProtostarVerifierParam, accumulator,
                       transcript):
        vp = vp_.vp
        spec = vp.spec
        accumulator.absorb_into(self.pcs, transcript)

        beta = transcript.squeeze_challenge()
        gamma = transcript.squeeze_challenge()
        z_comms = self.pcs.read_commitments(
            vp.pcs, vp.num_permutation_z_polys, transcript
        )
        alpha = transcript.squeeze_challenge()
        y = transcript.squeeze_challenges(vp.num_vars)

        challenges = (
            list(accumulator.challenges)
            + [accumulator.u]
            + [beta, gamma, alpha]
        )
        points, evals = verify_sum_check(
            spec,
            vp.num_vars,
            vp.expression,
            accumulator.claimed_sum(spec),
            accumulator.instances,
            challenges,
            y,
            transcript,
        )

        builtin_offset = sum(vp.num_witness_polys)
        dummy_comm = self.pcs.dummy_commitment()
        comms = (
            [dummy_comm] * len(vp.num_instances)
            + vp.preprocess_comms
            + accumulator.witness_comms[:builtin_offset]
            + [comm for _, comm in vp.permutation_comms]
            + accumulator.witness_comms[builtin_offset:]
            + z_comms
            + [accumulator.e_comm]
        )
        self.pcs.batch_verify(vp.pcs, comms, points, evals, transcript)

    def verify_decider_with_last_nark(self, vp, accumulator, instances,
                                      transcript):
        self.verify_accumulation_from_nark(vp, accumulator, instances, transcript)
        self.verify_decider(vp, accumulator, transcript)


def Sangria(pcs):
    """Sangria = Protostar with NoCompressing (sangria.rs:11-20)."""
    return Protostar(pcs, ProtostarStrategy.NoCompressing)
