"""The Brakedown commit's kernels (csrc/brakedown.cu, csrc/merkle.cu), built
for the host with g++ (csrc/cpu_twin.cpp) and launched through the
wrappers' own launch logic (kernels/brakedown.py), against the plain torch
paths: the code's encoding (each matrix's ``dot_plain``) and the column hashes and
Merkle levels (utils/keccak_device.py), for Spec 6 at k = 10 and the test
spec at k = 5.  Then the port's Spec-6 commit root on the CPU against the
benchmark's plain reference (proofbench/reference/brakedown.py), and the
openings read from the tree's one host array against a list of the nodes'
bytes, as the commitment held them before."""

import ctypes
import dataclasses
import random

import numpy as np
import pytest
import torch

from plonkish_tpu_torch.fields import limb
from plonkish_tpu_torch.fields.spec import BN254_FR
from plonkish_tpu_torch.kernels import brakedown as kbrakedown
from plonkish_tpu_torch.kernels import build
from plonkish_tpu_torch.pcs import brakedown
from plonkish_tpu_torch.pcs.brakedown_code import (BRAKEDOWN_SPEC_6, BRAKEDOWN_SPEC_TEST,
                                                   Brakedown)
from plonkish_tpu_torch.poly.multilinear import MLPoly
from plonkish_tpu_torch.utils import keccak_device
from plonkish_tpu_torch.utils.transcript import Keccak256Transcript

torch.set_num_threads(1)

CASES = {"spec6_k10": (BRAKEDOWN_SPEC_6, 10), "test_k5": (BRAKEDOWN_SPEC_TEST, 5)}


@pytest.fixture(scope="module")
def twin():
    try:
        path = build.build_cpu_twin()
    except FileNotFoundError as e:
        pytest.skip(f"no host C++ compiler: {e}")
    lib = ctypes.CDLL(str(path))
    return (build.bind(lib.twin_brakedown_dot, kbrakedown.DOT_ARGS),
            build.bind(lib.twin_keccak_messages, kbrakedown.HASH_ARGS))


def _code(case):
    bspec, k = CASES[case]
    return Brakedown.new_multilinear(BN254_FR, bspec, k, min(20, (1 << k) - 1),
                                     random.Random(11))


def _rows(count, length, seed):
    """count x length random Montgomery elements, 0, 1 and p - 1 first."""
    rng = random.Random(seed)
    values = [rng.randrange(BN254_FR.p) for _ in range(count * length)]
    values[:3] = [0, 1, BN254_FR.p - 1]
    return limb.from_canonical_ints(BN254_FR, values).reshape(count, length, limb.L)


@pytest.mark.parametrize("rows", [1, 3])
@pytest.mark.parametrize("case", list(CASES))
def test_encode_twin_equals_plain(twin, case, rows):
    code = _code(case)
    batch = _rows(rows, code.row_len, seed=rows)
    dot = lambda mat, x, out: kbrakedown.dot_launch(  # noqa: E731
        twin[0], None, BN254_FR, mat.by_output, x, out)
    got = code.encode_columns(batch, dot=dot)
    assert got.shape == (code.codeword_len, rows, limb.L) and got.is_contiguous()
    assert torch.equal(got.transpose(0, 1), code.encode(batch))


@pytest.mark.parametrize("case", list(CASES))
def test_dot_twin_takes_row_major_inputs(twin, case):
    """Each matrix, the base case's too, on a [rows, n, 8] tensor as
    SparseMatrix.dot takes it."""
    code = _code(case)
    for i, mat in enumerate(code.a + code.b + [code.rs]):
        x = _rows(2, mat.dimension.n, seed=i)
        out = torch.empty((2, mat.dimension.m, limb.L), dtype=torch.int32)
        kbrakedown.dot_launch(twin[0], None, BN254_FR, mat.by_output, x, out)
        assert torch.equal(out, mat.dot_plain(x))


def test_kernel_takes_the_card_and_its_fields_only():
    """The encoding goes through csrc/brakedown.cu on the card in BN254 Fr or
    Fq, and through each matrix's dot_plain on the CPU or in another field;
    a matrix drawn on the CPU keeps no layout by output until one is read."""
    from plonkish_tpu_torch.fields.spec import BLS12_381_FR, BN254_FQ

    assert kbrakedown.takes(BN254_FR, "cuda") and kbrakedown.takes(BN254_FQ, torch.device("cuda"))
    assert not kbrakedown.takes(BLS12_381_FR, "cuda") and not kbrakedown.takes(BN254_FR, "cpu")
    code = _code("test_k5")
    assert all("by_output" not in vars(m) for m in code.a + code.b + [code.rs])


@pytest.mark.parametrize("case", list(CASES))
def test_hash_twin_equals_plain(twin, case):
    code = _code(case)
    canon = limb.from_mont(BN254_FR, code.encode_columns(_rows(2, code.row_len, seed=5)))
    nodes = kbrakedown.column_hashes_launch(twin[1], None, canon)
    kbrakedown.merkle_levels_launch(twin[1], None, nodes)
    want = brakedown._column_hashes(canon)
    brakedown._merkle_levels(want)
    assert torch.equal(nodes, want)
    width = kbrakedown.tree_width(code.codeword_len)
    assert nodes.shape == (2 * width - 1, limb.L)
    assert not nodes[code.codeword_len:width].any() and nodes[:code.codeword_len].any(1).all()


def test_commit_root_equals_reference():
    from proofbench.reference import brakedown as reference

    k, code_seed = 10, 3
    pcs = brakedown.MultilinearBrakedown(BN254_FR, BRAKEDOWN_SPEC_6, device="cpu")
    pp = pcs.setup(1 << k, 1, random.Random(code_seed))
    code = reference.draw_code(k, code_seed)
    assert (code.num_rows, code.row_len, code.codeword_len) == (
        pp.num_rows, pp.code.row_len, pp.code.codeword_len)
    g = torch.Generator().manual_seed(2**31 + 99)
    polys = []
    for _ in range(2):
        evals = torch.randint(-(1 << 31), 1 << 31, (1 << k, 8), dtype=torch.int32, generator=g)
        evals[:, 7] = torch.randint(0, BN254_FR.p >> 224, (1 << k,), dtype=torch.int32,
                                    generator=g)
        polys.append(evals)
    roots = [pcs.commit(pp, MLPoly(BN254_FR, e)).root for e in polys]
    assert roots[0] != roots[1]
    assert [reference.commit_root(code, e.numpy()) for e in polys] == roots


def _old_nodes(canon):
    """The tree as a list of each node's bytes, leaves first, the root last:
    the commitment's form before the one host array."""
    cw, rows, _ = canon.shape
    words = (canon.to(torch.int64) & keccak_device.M32).reshape(cw, rows * 8).T
    cur = keccak_device.keccak256_fixed(words, 32 * rows)
    width = kbrakedown.tree_width(cw)
    cur = torch.cat([cur, torch.zeros((8, width - cw), dtype=cur.dtype)], 1)
    levels = [cur]
    while cur.shape[1] > 1:
        cur = keccak_device.keccak256_fixed(torch.cat([cur[:, 0::2], cur[:, 1::2]], 0), 64)
        levels.append(cur)
    return keccak_device.digests_to_bytes(torch.cat(levels, dim=1))


def test_openings_from_host_array_equal_list_of_bytes():
    from plonkish_tpu_torch.fields.host import Fp

    k = 6
    pcs = brakedown.MultilinearBrakedown(BN254_FR, BRAKEDOWN_SPEC_TEST, device="cpu")
    pp = pcs.setup(1 << k, 1, random.Random(4))
    rng = random.Random(8)
    poly = MLPoly.from_ints(BN254_FR, [rng.randrange(BN254_FR.p) for _ in range(1 << k)], "cpu")
    comm = pcs.commit(pp, poly)
    canon = limb.from_mont(BN254_FR, pp.code.encode_columns(
        poly.evals.reshape(pp.num_rows, pp.code.row_len, limb.L)))
    old = _old_nodes(canon)
    assert isinstance(comm.intermediate_hashes.nodes, np.ndarray)
    assert list(comm.intermediate_hashes) == old[:-1] and comm.root == old[-1]
    point = [Fp(rng.randrange(BN254_FR.p), BN254_FR) for _ in range(k)]
    value = poly.evaluate(point)
    proofs = []
    for c in (comm, dataclasses.replace(comm, intermediate_hashes=old[:-1])):
        tr = Keccak256Transcript(BN254_FR)
        pcs.open(pp, poly, c, point, value, tr)
        proofs.append(tr.into_proof())
    assert proofs[0] == proofs[1]
    pcs.verify(pp, brakedown.BrakedownCommitment(root=comm.root), point, value,
               Keccak256Transcript.from_proof(BN254_FR, proofs[0]))
