"""Classic sum-check PIOP on torch tensors (port of plonkish_tpu/piop/sum_check.py).

Protocol semantics are those of the reference's host-transcript path
(sum_check.py:327-357 and :854-897): per round the prover sends the round
polynomial's evaluations at t = 0..d (``EvaluationsProver``) or its
coefficients (``CoefficientsProver``, the degree-2 batch-open rounds), the
verifier squeezes a challenge on the host transcript, and every live table is
folded with fix_var.

On the card, with ``config.device_fs()`` on (the default), the transcript's
sponge runs on the device instead (``DeviceFsRun``, piop/fiat_shamir.py): each
round enqueues K3 -> K6 -> K4 with no host read and no blocking upload, the
round messages come back in one transfer, and the host transcript is replayed
from them (reference sum_check.py:1276-1495).  With ``config.fused_rounds()``
on as well (the default), an Evaluations sum-check's rounds from
``FUSED_MAX_PAIRS`` pairs down run as one launch of K7
(``kernels.sumcheck.fused_rounds``) instead (reference sum_check.py:1359).
On the CPU the host loop stays the default.

All live tables of a prove are one stacked Montgomery tensor ``int32[T, n, 8]``
(natural hypercube order, sorted table keys as in the reference's jax path):
the zero-check round message is one call of K3 (``kernels.sumcheck.round_evals``)
over a compiled expression tape, and the fold of every table is one call of K4
(``kernels.sumcheck.fold``).  The degree-2 rounds are plain torch over the
field layer.  Host functions below the state (verifier algebra, barycentric
interpolation, round messages) are copied from the reference.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import torch

from .. import config, parallel
from ..fields import limb
from ..fields.host import Fp, batch_invert
from ..fields.spec import FieldSpec
from ..kernels import sumcheck as ksc
from ..kernels import sumcheck_gen
from ..parallel import sharded
from ..poly.multilinear import MLPoly, eq_xy_evals
from ..utils.bh import BooleanHypercube
from ..utils.expression import (
    CommonPoly,
    EqXY,
    Expression,
    Identity,
    Lagrange,
    Polynomial,
    Query,
)
from ..utils.timer import span
from ..utils.transcript import Keccak256Transcript
from . import fiat_shamir as fs
from . import tape as tape_mod


# ---------------------------------------------------------------------------
# Virtual polynomial
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class VirtualPolynomial:
    expression: Expression
    polys: List[MLPoly]
    challenges: List[Fp]
    ys: List[List[Fp]]


# ---------------------------------------------------------------------------
# Verifier-side final evaluation helpers (sum_check.rs:60-125)
# ---------------------------------------------------------------------------

def lagrange_eval(x: Sequence[Fp], b: int) -> Fp:
    assert len(x) > 0
    spec = x[0].spec
    acc = Fp.one(spec)
    for idx, x_i in enumerate(x):
        acc = acc * (x_i if (b >> idx) & 1 else Fp.one(spec) - x_i)
    return acc


def eq_xy_eval(x: Sequence[Fp], y: Sequence[Fp]) -> Fp:
    assert len(x) == len(y) and len(x) > 0
    spec = x[0].spec
    acc = Fp.one(spec)
    for x_i, y_i in zip(x, y):
        acc = acc * ((x_i * y_i).double() + Fp.one(spec) - x_i - y_i)
    return acc


def identity_eval(x: Sequence[Fp]) -> Fp:
    spec = x[0].spec
    acc = Fp.zero(spec)
    for i, x_i in enumerate(x):
        acc = acc + x_i * (1 << i)
    return acc


def evaluate(
    expression: Expression,
    num_vars: int,
    evals: Dict[Query, Fp],
    challenges: Sequence[Fp],
    ys: Sequence[Sequence[Fp]],
    x: Sequence[Fp],
) -> Fp:
    """Evaluate the expression at point x given query evals (host)."""
    assert num_vars > 0
    assert expression.max_used_rotation_distance() <= num_vars
    identity = identity_eval(x)
    bh = BooleanHypercube(num_vars)
    order = bh.iter_array
    lagranges = {}
    for i in expression.used_lagrange():
        b = int(order[i % (1 << num_vars)])
        lagranges[i] = lagrange_eval(x, b)
    eq_xys = [eq_xy_eval(x, y) for y in ys]

    def common(cp):
        if isinstance(cp, Identity):
            return identity
        if isinstance(cp, Lagrange):
            return lagranges[cp.i]
        if isinstance(cp, EqXY):
            return eq_xys[cp.idx]
        raise TypeError(cp)

    return expression.evaluate(
        lambda c: c,
        common,
        lambda q: evals[q],
        lambda idx: challenges[idx],
        lambda a: -a,
        lambda a, b: a + b,
        lambda a, b: a * b,
        lambda a, s: a * s,
    )


# ---------------------------------------------------------------------------
# Barycentric interpolation over points 0..d (arithmetic.rs:108-136)
# ---------------------------------------------------------------------------

def barycentric_weights(points: List[Fp]) -> List[Fp]:
    spec = points[0].spec
    weights = []
    for j, pj in enumerate(points):
        w = Fp.one(spec)
        for i, pi in enumerate(points):
            if i != j:
                w = w * (pj - pi)
        weights.append(w)
    return batch_invert(weights)


def barycentric_interpolate(
    weights: List[Fp], points: List[Fp], evals: List[Fp], x: Fp
) -> Fp:
    spec = x.spec
    coeffs = batch_invert([x - p for p in points])
    coeffs = [c * w for c, w in zip(coeffs, weights)]
    sum_inv = sum(coeffs, Fp.zero(spec)).inv()
    acc = Fp.zero(spec)
    for c, e in zip(coeffs, evals):
        acc = acc + c * e
    return acc * sum_inv




# ---------------------------------------------------------------------------
# Prover state
# ---------------------------------------------------------------------------

class ProverState:
    """Live tables of the classic sum-check prover (classic.rs:25-150), with
    dense Lagrange one-hots and rotations materialised by a BH gather at
    round 0, stacked into one tensor.

    Under a mesh (``parallel.row_block``) ``stacked`` holds only this rank's
    block of rows (reference sum_check.py:302-308): every table is built from
    the whole polynomial, which every rank holds, and then cut, so a rotated
    block is ``poly[rmap[block]]``.  ``row0`` is the global index of the
    block's first row in the current (folded) tables.  Once a fold leaves
    one row a rank, the ranks' rows are all-gathered and the last log2(world)
    rounds run replicated."""

    def __init__(self, spec: FieldSpec, num_vars: int, sum_: Fp,
                 virtual_poly: VirtualPolynomial):
        assert num_vars > 0
        assert virtual_poly.expression.max_used_rotation_distance() <= num_vars
        self.spec = spec
        self.num_vars = num_vars
        self.expression = virtual_poly.expression
        self.degree = virtual_poly.expression.degree()
        self.sum = sum_
        self.challenges = virtual_poly.challenges
        self.round = 0
        self.identity_offset = Fp.zero(spec)

        device = virtual_poly.polys[0].device
        self.device = device
        bh = BooleanHypercube(num_vars)
        n = 1 << num_vars
        block = parallel.row_block(n)
        self.mesh = None if block is None else block.mesh
        lo, hi = (0, n) if block is None else (block.start, block.stop)
        self.row0 = lo
        if self.mesh is not None:
            self.mesh.taken["sum_check"] += 1
        tables = {}
        for i in self.expression.used_lagrange():
            vec = limb.zeros((hi - lo,), device)
            b = int(bh.iter_array[i % n])
            if lo <= b < hi:
                vec[b - lo] = limb.one(spec, (), device)
            tables[("lagrange", i)] = vec
        for i, y in enumerate(virtual_poly.ys):
            tables[("eq_xy", i)] = eq_xy_evals(spec, y, device)[lo:hi]
        for idx, poly in enumerate(virtual_poly.polys):
            tables[("poly", idx, 0)] = poly.evals[lo:hi]
        for query in self.expression.used_query():
            rot = query.rotation.value
            if rot != 0 and ("poly", query.poly, rot) not in tables:
                rmap = torch.as_tensor(bh.rotation_map(rot)[lo:hi], device=device)
                tables[("poly", query.poly, rot)] = virtual_poly.polys[query.poly].evals[rmap]
        self.table_keys = tuple(sorted(tables))
        self.stacked = torch.stack([tables[k] for k in self.table_keys], dim=0)

    @property
    def size(self) -> int:
        return 1 << (self.num_vars - self.round - 1)

    def table(self, key) -> torch.Tensor:
        return self.stacked[self.table_keys.index(key)]

    def all_reduce(self, sums: torch.Tensor) -> torch.Tensor:
        """The round's sums over every rank's pairs (Montgomery [m, 8]); the
        sums themselves when the rows are whole here."""
        if self.mesh is None:
            return sums
        return sharded.all_reduce_field(self.spec, self.mesh, sums)

    def next_round(self, sum_: Fp, challenge: Fp) -> None:
        self.sum = sum_
        self.identity_offset = self.identity_offset + challenge * (1 << self.round)
        self.fold(limb.const(self.spec, int(challenge), self.device))

    def fold(self, challenge: torch.Tensor) -> None:
        """K4 at a Montgomery challenge on the device; the round advances.
        The host's sum and identity offset are the caller's to advance."""
        self.stacked = ksc.fold(self.spec, self.stacked, challenge)
        self.round += 1
        self.row0 //= 2
        if self.mesh is not None and self.stacked.shape[1] == 1:
            self.stacked = sharded.all_gather_cat(self.mesh, self.stacked, 1)
            self.mesh, self.row0 = None, 0

    def pair0_schedule(self) -> List[int]:
        """The global index of this rank's first pair in every round, from a
        fresh state, as ``fold`` will move it (``identity_params``'s pair0)."""
        out, row0, rows, mesh = [], self.row0, self.stacked.shape[1], self.mesh is not None
        for _ in range(self.num_vars):
            out.append(row0 // 2)
            rows, row0 = rows // 2, row0 // 2
            if mesh and rows == 1:
                mesh, row0 = False, 0
        return out

    def into_evals(self) -> List[Fp]:
        """Final evaluations of each input poly at the challenge point."""
        assert self.round == self.num_vars
        rows = [i for i, k in enumerate(self.table_keys) if k[0] == "poly" and k[2] == 0]
        vals = limb.to_canonical_ints(self.spec, self.stacked[rows])
        return [Fp(v, self.spec) for v in vals]


def identity_params(spec: FieldSpec, round_: int, offset: Fp, device, pair0: int = 0):
    """(mul, base, step) of the identity leaf at this round, as the rows of
    one int32[3, 8] (one upload): value at pair i and t is
    offset + 2^r + i * 2^(r+1) + (t - 1) * 2^r (eval.rs:233-236).  `pair0`
    is the global index of the first pair of a rank's block: its pair i is
    pair pair0 + i of the whole table."""
    mul = ((1 << (round_ + 1)) * spec.r2_mod_p) % spec.p
    base = spec.to_mont((int(offset) + (1 << round_) + pair0 * (1 << (round_ + 1))) % spec.p)
    step = spec.to_mont((1 << round_) % spec.p)
    return limb.from_ints([mul, base, step], device)


def identity_stack(spec: FieldSpec, pair0s: Sequence[int], device) -> torch.Tensor:
    """K6's identity rows, one upload for a whole sum-check: row r is
    (mul, base_add, step) of round r (a last row past the rounds closes the
    stack), base_add = 2^r + pair0 * 2^(r+1) in Montgomery form, so that
    round r's base is the device's offset + base_add (identity_params)."""
    vals = []
    for r in range(len(pair0s) + 1):
        pair0 = pair0s[r] if r < len(pair0s) else 0
        vals += [((1 << (r + 1)) * spec.r2_mod_p) % spec.p,
                 spec.to_mont(((1 << r) + pair0 * (1 << (r + 1))) % spec.p),
                 spec.to_mont((1 << r) % spec.p)]
    return limb.from_ints(vals, device).reshape(len(pair0s) + 1, 3, limb.L)


# ---------------------------------------------------------------------------
# Round messages
# ---------------------------------------------------------------------------

class Evaluations:
    """Round poly as evals at t=0..d (classic/eval.rs:22-68)."""

    def __init__(self, values: List[Fp]):
        self.values = values

    def write(self, transcript: Keccak256Transcript) -> None:
        transcript.write_field_elements(self.values)

    @staticmethod
    def read(degree: int, transcript: Keccak256Transcript) -> "Evaluations":
        return Evaluations(transcript.read_field_elements(degree + 1))

    def sum(self) -> Fp:
        return self.values[0] + self.values[1]

    @staticmethod
    def auxiliary(degree: int, spec: FieldSpec):
        points = [Fp(i, spec) for i in range(degree + 1)]
        return (barycentric_weights(points), points)

    def evaluate(self, aux, challenge: Fp) -> Fp:
        weights, points = aux
        return barycentric_interpolate(weights, points, self.values, challenge)


class Coefficients:
    """Round poly as coefficients (classic/coeff.rs:16-39)."""

    def __init__(self, values: List[Fp]):
        self.values = values

    def write(self, transcript: Keccak256Transcript) -> None:
        transcript.write_field_elements(self.values)

    @staticmethod
    def read(degree: int, transcript: Keccak256Transcript) -> "Coefficients":
        return Coefficients(transcript.read_field_elements(degree + 1))

    def sum(self) -> Fp:
        acc = self.values[0].double()
        for c in self.values[1:]:
            acc = acc + c
        return acc

    @staticmethod
    def auxiliary(degree: int, spec: FieldSpec):
        return None

    def evaluate(self, aux, challenge: Fp) -> Fp:
        acc = Fp.zero(challenge.spec)
        for c in reversed(self.values):
            acc = acc * challenge + c
        return acc




# ---------------------------------------------------------------------------
# EvaluationsProver (zero-check rounds: kernels K3 + K4)
# ---------------------------------------------------------------------------

class EvaluationsProver:
    """General-degree prover: the round polynomial's evaluations at t = 1..d
    from one K3 call over the expression tape."""

    def __init__(self, state: ProverState):
        spec = state.spec
        self.expr = state.expression.simplified(state.challenges)
        t = tape_mod.compile_tape(self.expr, spec)
        instrs = t.remapped(state.table_keys)
        self.tape = t
        self.instrs = instrs
        self.consts = t.const_rows(spec, state.device)
        if state.stacked.is_cuda:  # build K3 for this tape now, not in round 0
            sumcheck_gen.kernel(instrs, t.num_regs, t.out_reg, len(state.table_keys),
                                state.degree)

    def round_sums(self, state: ProverState, ids: torch.Tensor) -> torch.Tensor:
        """K3 at this round, summed over every rank: Montgomery [d, 8]."""
        return state.all_reduce(ksc.round_evals(
            state.spec, state.stacked, self.instrs, self.consts, self.tape.num_regs,
            self.tape.out_reg, state.degree, ids,
        ))

    def prove_round(self, state: ProverState) -> Evaluations:
        spec = state.spec
        ids = identity_params(spec, state.round, state.identity_offset, state.device,
                              state.row0 // 2)
        vals = limb.to_canonical_ints(spec, self.round_sums(state, ids))
        evals = [Fp.zero(spec)] + [Fp(v, spec) for v in vals]
        evals[0] = state.sum - evals[1]
        return Evaluations(evals)


# ---------------------------------------------------------------------------
# CoefficientsProver (degree-2 batch-open rounds, plain torch)
# ---------------------------------------------------------------------------

class CoefficientsProver:
    """Flattens the expression to constant + sum scalar * eq_xy * poly and
    runs the karatsuba round (coeff.rs:66-208)."""

    def __init__(self, state: ProverState):
        spec = state.spec
        challenges = state.challenges

        def constant(c):
            return (c, [])

        def common(cp):
            return (Fp.zero(spec), [(Fp.one(spec), [CommonPoly(cp)])])

        def poly(q):
            return (Fp.zero(spec), [(Fp.one(spec), [Polynomial(q)])])

        def challenge(idx):
            return (challenges[idx], [])

        def negated(v):
            c, prods = v
            return (-c, [(-s, ps) for s, ps in prods])

        def sum_(a, b):
            return (a[0] + b[0], a[1] + b[1])

        def product(a, b):
            (ca, pa), (cb, pb) = a, b
            out = []
            if ca != 0:
                out.extend((ca * s, ps) for s, ps in pb)
            if cb != 0:
                out.extend((cb * s, ps) for s, ps in pa)
            for (sa, psa) in pa:
                for (sb, psb) in pb:
                    out.append((sa * sb, psa + psb))
            return (ca * cb, out)

        def scaled(v, s):
            c, prods = v
            return (c * s, [(x * s, ps) for x, ps in prods])

        self.constant, self.flattened = state.expression.evaluate(
            constant, common, poly, challenge, negated, sum_, product, scaled
        )
        assert all(len(ps) == 2 for _, ps in self.flattened), (
            "CoefficientsProver supports degree-2 eq_xy * poly expressions"
        )

    def term_triples(self):
        """(eq_idx, poly_idx, scalar int) per flattened term (coeff.rs:157-167)."""
        out = []
        for scalar, prods in self.flattened:
            lhs, rhs = prods
            if isinstance(lhs, CommonPoly):
                eq_idx, query = lhs.poly.idx, rhs.query
            else:
                eq_idx, query = rhs.poly.idx, lhs.query
            assert query.rotation.value == 0
            out.append((eq_idx, query.poly, int(scalar)))
        return out

    def scalar_digits(self, state: ProverState) -> torch.Tensor:
        """The flattened terms' scalars as Montgomery digits [16, terms] on
        the state's device (one upload)."""
        scalars = [scalar for *_, scalar in self.term_triples()]
        return limb.unpack(limb.from_canonical_ints(state.spec, scalars)).to(state.device)

    def round_sums(self, state: ProverState, scalars: torch.Tensor) -> torch.Tensor:
        """The karatsuba sums (v0, v2) of this round over every rank,
        Montgomery [2, 8]: v0 = sum of s * eq_lo * p_lo, v2 = sum of
        s * (eq_hi - eq_lo) * (p_hi - p_lo) over the terms."""
        c = limb._consts(state.spec, state.device)
        acc0 = acc2 = None
        for j, (eq_idx, poly_idx, _) in enumerate(self.term_triples()):
            eq = limb.unpack(state.table(("eq_xy", eq_idx)))
            p = limb.unpack(state.table(("poly", poly_idx, 0)))
            eq_lo, eq_hi = eq[:, 0::2], eq[:, 1::2]
            p_lo, p_hi = p[:, 0::2], p[:, 1::2]
            s = scalars[:, j: j + 1]
            lo = limb.d_sum(limb.d_mul(eq_lo, p_lo, c), c)
            diff = limb.d_mul(limb.d_sub(eq_hi, eq_lo, c), limb.d_sub(p_hi, p_lo, c), c)
            hi = limb.d_sum(diff, c)
            t0, t2 = limb.d_mul(lo, s, c), limb.d_mul(hi, s, c)
            acc0 = t0 if acc0 is None else limb.d_add(acc0, t0, c)
            acc2 = t2 if acc2 is None else limb.d_add(acc2, t2, c)
        return state.all_reduce(limb.pack(torch.cat([acc0, acc2], 1)))

    def prove_round(self, state: ProverState) -> Coefficients:
        spec = state.spec
        size = state.size
        c0 = Fp(size, spec) * self.constant
        c2 = Fp.zero(spec)
        if self.flattened:
            sums = self.round_sums(state, self.scalar_digits(state))
            v0, v2 = limb.to_canonical_ints(spec, sums)
            c0 = c0 + Fp(v0, spec)
            c2 = c2 + Fp(v2, spec)
        c1 = state.sum - c0.double() - c2
        return Coefficients([c0, c1, c2])


# ---------------------------------------------------------------------------
# Device-resident Fiat-Shamir (reference sum_check.py:1276-1580)
# ---------------------------------------------------------------------------

# The handover H of the fused rounds: K7 takes an Evaluations sum-check's
# rounds from the first whose pair count is at most this (None: every round);
# the rounds above keep K3 -> K6 -> K4.  Chosen on the card (PERF.md, K7).
FUSED_MAX_PAIRS = None


def device_fs_eligible(prover) -> bool:
    """The provers with a device-FS path: every EvaluationsProver, and a
    CoefficientsProver with terms (reference sum_check.py:1242-1257)."""
    if isinstance(prover, EvaluationsProver):
        return True
    return isinstance(prover, CoefficientsProver) and bool(prover.flattened)


def device_fs_selected(state: ProverState, prover) -> bool:
    """The device FS runs where the state is on the card and
    ``config.device_fs()`` is on (the reference's ``not limb.IS_CPP and
    config.device_fs()``, sum_check.py:1241)."""
    return state.stacked.is_cuda and config.device_fs() and device_fs_eligible(prover)


class DeviceFsRun:
    """One sum-check with its transcript's sponge on the state's device.

    The constructor makes every upload the rounds need, before the first
    launch: the sponge (from the host transcript), the claimed sum and the
    identity offset, the Lagrange constants and the identity stack (an
    Evaluations sum-check), or the terms' scalars and each round's c0 base (a
    Coefficients one), and the buffers K6 writes.  ``enqueue`` then launches
    each round's K3 (or the plain-torch (v0, v2) sums), K6 and K4 with no host
    read and no blocking upload, and under ``config.fused_rounds()`` hands an
    Evaluations sum-check's rounds from the handover on to one launch of K7;
    ``replay`` brings every message and challenge back in one transfer and
    replays them into the host transcript."""

    def __init__(self, state: ProverState, prover, transcript: Keccak256Transcript):
        assert state.round == 0, "a device-FS run starts from a fresh state"
        spec, dev, k = state.spec, state.device, state.num_vars
        self.state, self.prover = state, prover
        self.coeff = isinstance(prover, CoefficientsProver)
        self.fused = not self.coeff and config.fused_rounds()
        self.message_cls = Coefficients if self.coeff else Evaluations
        self.width = 3 if self.coeff else state.degree + 1  # message elements
        self.sponge = fs.sponge_words(transcript, dev)
        limb._consts(spec, dev)  # the field layer's constants, before the rounds
        if self.coeff:
            self.scal = limb.const(spec, int(state.sum), dev)
            self.scalars = prover.scalar_digits(state)
            sizes = [1 << (k - r - 1) for r in range(k)]
            self.c0_base = limb.from_ints(
                [spec.to_mont(int(Fp(size, spec) * prover.constant)) for size in sizes], dev)
        else:
            pair0s = state.pair0_schedule()
            self.scal = limb.from_ints([spec.to_mont(int(state.sum)),
                                        spec.to_mont(int(state.identity_offset))], dev)
            self.fixed = fs.lagrange_constants(spec, state.degree, dev)
            self.rows = identity_stack(spec, pair0s, dev)
            self.ids = identity_params(spec, 0, state.identity_offset, dev, pair0s[0])
        self.out = torch.empty((k, self.width + 1, limb.L), dtype=torch.int32, device=dev)
        self.ch_mont = torch.empty((limb.L,), dtype=torch.int32, device=dev)

    def enqueue(self) -> None:
        """Every round, each a K3 (or (v0, v2)) -> K6 -> K4 launch sequence,
        or, fused, K7 from the first round at or below the handover whose rows
        are whole here (not sharded over a mesh) to the last."""
        state, prover, spec = self.state, self.prover, self.state.spec
        for r in range(state.num_vars):
            if (self.fused and state.mesh is None
                    and (FUSED_MAX_PAIRS is None or state.size <= FUSED_MAX_PAIRS)):
                t = prover.tape
                state.stacked = ksc.fused_rounds(
                    spec, state.stacked, prover.instrs, prover.consts, t.num_regs, t.out_reg,
                    state.degree, self.ids, self.rows, self.sponge, self.scal, self.fixed,
                    self.out, self.ch_mont, r, state.num_vars - r)
                state.round = state.num_vars
                return
            if self.coeff:
                fs.coeff_message(spec, prover.round_sums(state, self.scalars), self.scal,
                                 self.sponge, self.c0_base[r], self.out[r], self.ch_mont)
            else:
                fs.round_message(spec, state.degree, prover.round_sums(state, self.ids),
                                 self.scal, self.sponge, self.fixed, self.rows[r: r + 2],
                                 self.out[r], self.ch_mont, self.ids)
            state.fold(self.ch_mont)

    def replay(self, aux, transcript: Keccak256Transcript) -> List[Fp]:
        """One device-to-host transfer of every message and challenge, then
        the host transcript replayed from them; a host challenge that differs
        from the device's raises ``ValueError`` (an unverifiable proof
        otherwise).  The host's sum and identity offset advance as the host
        loop advances them."""
        state, spec, w = self.state, self.state.spec, self.width
        vals = limb.to_ints(self.out)
        challenges: List[Fp] = []
        for round_ in range(state.num_vars):
            row = vals[round_ * (w + 1): (round_ + 1) * (w + 1)]
            msg = self.message_cls([Fp(v, spec) for v in row[:w]])
            if config.sanity_checks():
                assert msg.sum() == state.sum, (
                    f"sum-check round {round_}: message sum "
                    f"{msg.sum()} != claimed {state.sum}"
                )
            msg.write(transcript)
            challenge = transcript.squeeze_challenge()
            if int(challenge) != row[w]:
                raise ValueError(
                    f"device Fiat-Shamir diverged from host transcript at round {round_}")
            challenges.append(challenge)
            state.sum = msg.evaluate(aux, challenge)
            state.identity_offset = state.identity_offset + challenge * (1 << round_)
        return challenges


# ---------------------------------------------------------------------------
# ClassicSumCheck driver
# ---------------------------------------------------------------------------

class ClassicSumCheck:
    """prove/verify loop (classic.rs:197-264)."""

    def __init__(self, prover_cls, message_cls):
        self.prover_cls = prover_cls
        self.message_cls = message_cls

    @classmethod
    def evaluations(cls):
        return cls(EvaluationsProver, Evaluations)

    @classmethod
    def coefficients(cls):
        return cls(CoefficientsProver, Coefficients)

    def prove(
        self,
        spec: FieldSpec,
        num_vars: int,
        virtual_poly: VirtualPolynomial,
        sum_: Fp,
        transcript: Keccak256Transcript,
    ) -> Tuple[List[Fp], List[Fp]]:
        with span(f"sum_check_prove-{num_vars}-{virtual_poly.expression.degree()}"):
            state = ProverState(spec, num_vars, sum_, virtual_poly)
            prover = self.prover_cls(state)
            aux = self.message_cls.auxiliary(state.degree, spec)
            if device_fs_selected(state, prover):
                run = DeviceFsRun(state, prover, transcript)
                run.enqueue()
                return run.replay(aux, transcript), state.into_evals()
            challenges = []
            for round_ in range(num_vars):
                msg = prover.prove_round(state)
                if config.sanity_checks():
                    # reference `sanity-check` feature (classic/eval.rs debug
                    # assertions): the round polynomial carries the claimed sum
                    assert msg.sum() == state.sum, (
                        f"sum-check round {round_}: message sum "
                        f"{msg.sum()} != claimed {state.sum}"
                    )
                msg.write(transcript)
                challenge = transcript.squeeze_challenge()
                challenges.append(challenge)
                state.next_round(msg.evaluate(aux, challenge), challenge)
        return challenges, state.into_evals()

    def verify(
        self,
        spec: FieldSpec,
        num_vars: int,
        degree: int,
        sum_: Fp,
        transcript: Keccak256Transcript,
    ) -> Tuple[Fp, List[Fp]]:
        msgs, challenges = [], []
        for _ in range(num_vars):
            msgs.append(self.message_cls.read(degree, transcript))
            challenges.append(transcript.squeeze_challenge())
        aux = self.message_cls.auxiliary(degree, spec)
        current = sum_
        for round_, (msg, challenge) in enumerate(zip(msgs, challenges)):
            if current != msg.sum():
                raise ValueError(
                    f"sum-check consistency failure at round {round_}"
                )
            current = msg.evaluate(aux, challenge)
        return current, challenges
