"""HyperPlonk prover helpers (port of plonkish_tpu/backend/hyperplonk/prover.py).

Every O(2^k) phase is torch over the field layer on the polynomials' device:

- lookup compression: one whole-hypercube expression evaluation per column;
- lookup m: sort-based counting (``torch.unique``) instead of a hash map;
- lookup h: constant add and one batch inversion;
- permutation z: chunk products, one batch inversion, then the running
  product over the BH order as a log-depth prefix-product scan and one
  gather back to natural order (the reference's sequential running
  product, prover.rs:307-323); under a mesh the products and the inversion
  run on this rank's block of rows, and the products are all-gathered
  before the scan (the BH order crosses blocks), so the memory peaks at
  the whole products' size on every rank;
- zero-check: the sum-check of piop/sum_check.py (kernels K3 + K4).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from ... import config, parallel
from ...fields import limb
from ...fields.host import Fp
from ...fields.spec import FieldSpec
from ...parallel import sharded
from ...piop.evaluator import evaluate_on_hypercube, identity_digits
from ...piop.sum_check import ClassicSumCheck, VirtualPolynomial
from ...poly.multilinear import MLPoly, evaluate_for_rotations
from ...utils.bh import BooleanHypercube
from ...utils.expression import Expression
from ...utils.transcript import Keccak256Transcript
from ..pcs_api import Evaluation
from .verifier import pcs_query, point_offset, points


def row_mapping(k: int) -> List[int]:
    """Witness encoding: instances at BH positions 1.. (hyperplonk.rs:365-369)."""
    bh = BooleanHypercube(k)
    order = list(bh.iter())
    return order[1:] + [0]


def instance_polys(
    spec: FieldSpec, num_vars: int, instances: Sequence[Sequence[Fp]], device
) -> List[MLPoly]:
    mapping = row_mapping(num_vars)
    out = []
    for column in instances:
        vals = [0] * (1 << num_vars)
        for b, value in zip(mapping, column):
            vals[b] = int(value)
        out.append(MLPoly.from_ints(spec, vals, device))
    return out


def lookup_compressed_polys(
    spec: FieldSpec,
    lookups: List[List[Tuple[Expression, Expression]]],
    polys: List[MLPoly],
    challenges: List[Fp],
    betas: List[Fp],
) -> List[Tuple[MLPoly, MLPoly]]:
    """beta-powers-compressed input/table columns (prover.rs:50-137)."""
    if not lookups:
        return []
    num_vars = polys[0].num_vars
    device = polys[0].device
    tables = [p.evals for p in polys]
    out = []
    for lookup in lookups:
        compressed = []
        for exprs in ([inp for inp, _ in lookup], [tbl for _, tbl in lookup]):
            acc = None
            for beta_pow, expr in zip(betas, exprs):
                col = evaluate_on_hypercube(spec, expr, num_vars, tables, challenges, device)
                col = limb.mont_mul(spec, col, limb.const(spec, int(beta_pow), device))
                acc = col if acc is None else limb.add(spec, acc, col)
            compressed.append(MLPoly(spec, acc))
        out.append((compressed[0], compressed[1]))
    return out


def lookup_m_polys(compressed_polys: List[Tuple[MLPoly, MLPoly]]) -> List[MLPoly]:
    """Multiplicity polynomials (prover.rs:139-192): every input value's
    count lands on the first table row holding that value.  Montgomery form
    is a bijection, so rows compare as raw limbs."""
    out = []
    for input_poly, table_poly in compressed_polys:
        spec = input_poly.spec
        device = input_poly.device
        n = len(input_poly)
        both = torch.cat([table_poly.evals, input_poly.evals], dim=0)
        _, inv = torch.unique(both, dim=0, return_inverse=True)
        tbl_ids, inp_ids = inv[:n], inv[n:]
        num_ids = int(inv.max().item()) + 1
        first_row = torch.full((num_ids,), n, dtype=torch.int64, device=device)
        first_row.scatter_reduce_(
            0, tbl_ids, torch.arange(n, device=device), reduce="amin"
        )
        counts = torch.bincount(inp_ids, minlength=num_ids)
        if bool(((first_row == n) & (counts > 0)).any()):
            raise ValueError("Invalid lookup input")
        hit = counts > 0
        m = torch.zeros(n, dtype=torch.int64, device=device)
        m[first_row[hit]] = counts[hit]
        raw = torch.zeros((n, limb.L), dtype=torch.int32, device=device)
        raw[:, 0] = m.to(torch.int32)
        out.append(MLPoly(spec, limb.to_mont(spec, raw)))
    return out


def lookup_h_polys(
    compressed_polys: List[Tuple[MLPoly, MLPoly]],
    m_polys: List[MLPoly],
    gamma: Fp,
) -> List[MLPoly]:
    """h = 1/(gamma+input) - m/(gamma+table), one batch inversion
    (prover.rs:194-250)."""
    out = []
    for (input_poly, table_poly), m_poly in zip(compressed_polys, m_polys):
        spec = input_poly.spec
        g = limb.const(spec, int(gamma), input_poly.device)
        both = torch.cat([
            limb.add(spec, input_poly.evals, g.expand_as(input_poly.evals)),
            limb.add(spec, table_poly.evals, g.expand_as(table_poly.evals)),
        ], dim=0)
        inv = limb.batch_inv(spec, both)
        n = len(input_poly)
        h = limb.sub(spec, inv[:n], limb.mont_mul(spec, inv[n:], m_poly.evals))
        if config.sanity_checks():
            # reference `sanity-check` feature: the h polys sum to 0 (prover.rs:245-247)
            if limb.to_canonical_ints(spec, limb.sum_reduce(spec, h)[None])[0] != 0:
                raise AssertionError("sanity: lookup h polys do not sum to 0")
        out.append(MLPoly(spec, h))
    return out


def permutation_z_polys(
    num_chunks: int,
    permutation_polys: List[Tuple[int, MLPoly]],
    polys: List[MLPoly],
    beta: Fp,
    gamma: Fp,
) -> List[MLPoly]:
    """Grand-product z polynomials (prover.rs:252-345): per chunk
    prod(w_i + beta*id_i + gamma) / prod(w_i + beta*sigma_i + gamma), one
    global batch inversion, then the running product over the BH order.
    Under a mesh the quotients are formed on this rank's block of rows
    (reference prover.py:250-300 shards the σ and witness stacks) and then
    gathered; the z polys come out whole on every rank."""
    if not permutation_polys:
        return []
    first = polys[permutation_polys[0][0]]
    spec = first.spec
    device = first.device
    num_vars = first.num_vars
    n = 1 << num_vars
    nc = num_chunks
    chunk_size = -(-len(permutation_polys) // nc)
    c = limb._consts(spec, device)
    beta_c = limb.d_const(spec, int(beta), device)
    gamma_c = limb.d_const(spec, int(gamma), device)
    ident = identity_digits(spec, num_vars, device)
    block = parallel.row_block(n)
    lo, hi = (0, n) if block is None else (block.start, block.stop)
    if block is not None:
        block.mesh.taken["permutation_z"] += 1
        ident = ident[:, lo:hi]

    numers, denoms = [], []
    for ch in range(nc):
        chunk = permutation_polys[ch * chunk_size: (ch + 1) * chunk_size]
        numer = denom = None
        for j, (poly_idx, perm_poly) in enumerate(chunk):
            w = limb.unpack(polys[poly_idx].evals[lo:hi])
            sigma = limb.unpack(perm_poly.evals[lo:hi])
            d_term = limb.d_add(limb.d_add(limb.d_mul(sigma, beta_c, c), gamma_c, c), w, c)
            # id poly for column g: value g*2^k + b at row b
            g = ch * chunk_size + j
            offset = limb.d_const(spec, (g << num_vars) % spec.p, device)
            id_vals = limb.d_add(ident, offset.expand_as(ident), c)
            n_term = limb.d_add(limb.d_add(limb.d_mul(id_vals, beta_c, c), gamma_c, c), w, c)
            denom = d_term if denom is None else limb.d_mul(denom, d_term, c)
            numer = n_term if numer is None else limb.d_mul(numer, n_term, c)
        numers.append(numer)
        denoms.append(denom)
    denom_inv = limb.d_batch_inv(torch.cat(denoms, dim=1), spec)
    products = limb.d_mul(torch.cat(numers, dim=1), denom_inv, c)
    if block is not None:
        whole = sharded.all_gather_cat(block.mesh, limb.pack(products, (nc, hi - lo)), 1)
        products = limb.unpack(whole)
    products = products.reshape(limb.D, nc, n)

    bh = BooleanHypercube(num_vars)
    order = torch.as_tensor(bh.iter_array, device=device)  # nth -> b
    # v[t] = products[t % nc][order[1 + t // nc]] for t in 0 .. nc*n - nc - 2
    seq = products[:, :, order[1:]]  # [16, nc, n-1]
    seq_full = seq.permute(0, 2, 1).reshape(limb.D, (n - 1) * nc)
    seq = seq_full[:, : nc * n - nc - 1]
    cum = limb.d_prefix_mul(seq, c)
    if config.sanity_checks():
        # reference `sanity-check` feature: the grand product over every
        # chunk and row closes to 1 (prover.rs:325-331)
        last = limb.d_mul(cum[:, -1:], seq_full[:, -1:], c)
        if limb.to_canonical_ints(spec, limb.pack(last))[0] != 1:
            raise AssertionError("sanity: permutation grand product != 1")
    z_flat = torch.cat([
        torch.zeros((limb.D, nc), dtype=torch.int64, device=device),
        c["one"],
        cum,
    ], dim=1)  # [16, nc*n]
    nth = torch.as_tensor(bh.nth_map, device=device)  # b -> nth
    return [MLPoly(spec, limb.pack(z_flat[:, nth * nc + ch])) for ch in range(nc)]


def prove_zero_check(
    num_instance_poly: int,
    expression: Expression,
    polys: List[MLPoly],
    challenges: List[Fp],
    y: List[Fp],
    transcript: Keccak256Transcript,
) -> Tuple[List[List[Fp]], List[Evaluation]]:
    spec = polys[0].spec
    return prove_sum_check(
        num_instance_poly, expression, Fp.zero(spec), polys, challenges, y,
        transcript,
    )


def prove_sum_check(
    num_instance_poly: int,
    expression: Expression,
    sum_: Fp,
    polys: List[MLPoly],
    challenges: List[Fp],
    y: List[Fp],
    transcript: Keccak256Transcript,
) -> Tuple[List[List[Fp]], List[Evaluation]]:
    """Run zero/sum-check then emit per-query rotation evals
    (prover.rs:347-409)."""
    spec = polys[0].spec
    num_vars = polys[0].num_vars
    vp = VirtualPolynomial(expression, polys, challenges, [y])
    x, evals = ClassicSumCheck.evaluations().prove(spec, num_vars, vp, sum_, transcript)

    queries = pcs_query(expression, num_instance_poly)
    offsets = point_offset(queries)

    # the rotated queries' partial evaluations, one batch per rotation
    rotated = {}
    for rotation in {q.rotation for q in queries if q.rotation.value != 0}:
        group = [q for q in queries if q.rotation == rotation]
        values = evaluate_for_rotations([polys[q.poly] for q in group], x, rotation)
        rotated.update(zip(group, values))
    out_evals = []
    for query in queries:
        if query.rotation.value == 0:
            rotation_evals = [evals[query.poly]]
        else:
            rotation_evals = rotated[query]
        for i, eval_ in enumerate(rotation_evals):
            out_evals.append(Evaluation(query.poly, offsets[query.rotation] + i, eval_))
    transcript.write_field_elements([e.value for e in out_evals])
    return points(queries, x), out_evals
