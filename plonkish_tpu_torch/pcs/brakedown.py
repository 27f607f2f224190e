"""Multilinear Brakedown PCS [GLSTW21] (port of plonkish_tpu/pcs/brakedown.py).

Protocol mirrors plonkish_backend/src/pcs/multilinear/
brakedown.rs: commit = reshape evals to a [num_rows, row_len] matrix, encode
every row on the device, hash columns, merklize; open = proximity rows +
t0-combined row in clear + spot-checked column openings with merkle paths.

On the card the commit encodes every row with csrc/brakedown.cu, leaves
Montgomery form with csrc/convert.cu, hashes the columns and every Merkle
level with csrc/merkle.cu, and reads the codeword and the tree back in one
copy each, into page-locked buffers; on the CPU it takes the plain versions
(the hashes by ``utils/keccak_device.py``, as the reference's
``_merklize_device``).  The verifier hashes its openings' paths with the
native batch hasher (``ops/keccak_batch.py``).  No elliptic curves anywhere.
"""

from __future__ import annotations

import dataclasses
import random
from collections.abc import Sequence as SequenceABC
from typing import List, Sequence, Tuple

import numpy as np
import torch

from .. import parallel, resolve_device
from ..fields import limb
from ..fields.host import Fp
from ..fields.spec import FieldSpec
from ..kernels import brakedown as kbrakedown
from ..ops.keccak_batch import keccak256_many
from ..parallel import sharded
from ..poly.multilinear import MLPoly, eq_xy
from ..utils import keccak_device, timer
from ..utils.transcript import Keccak256Transcript
from .additive import weighted_sum
from .brakedown_code import BRAKEDOWN_SPEC_6, Brakedown, BrakedownSpec

ZERO_HASH = b"\x00" * 32


@dataclasses.dataclass
class BrakedownParams:
    num_vars: int
    num_rows: int
    code: Brakedown

    @property
    def spec(self) -> FieldSpec:
        return self.code.spec


class MerkleNodes(SequenceABC):
    """Every node of a commitment's Merkle tree but the root, leaves first,
    level after level, held as one host array uint8[n, 32]; node i is read
    as its 32 bytes."""

    def __init__(self, nodes: np.ndarray):
        self.nodes = nodes

    def __len__(self) -> int:
        return len(self.nodes)

    def __getitem__(self, i: int) -> bytes:
        return self.nodes[i].tobytes()


@dataclasses.dataclass
class BrakedownCommitment:
    root: bytes
    rows: np.ndarray | None = None  # canonical limbs [num_rows, cw, 8] int32, on the host
    intermediate_hashes: MerkleNodes | None = None


class MultilinearBrakedown:
    """PCS object; field spec + Brakedown spec are constructor params."""

    def __init__(self, spec: FieldSpec, bspec: BrakedownSpec = BRAKEDOWN_SPEC_6, device=None):
        self.field_spec = spec
        self.bspec = bspec
        self.device = resolve_device(device)

    # ------------------------------------------------------------- lifecycle
    def setup(self, poly_size: int, batch_size: int, rng: random.Random):
        assert poly_size & (poly_size - 1) == 0
        num_vars = poly_size.bit_length() - 1
        n_0 = min(20, (1 << num_vars) - 1)
        code = Brakedown.new_multilinear(
            self.field_spec, self.bspec, num_vars, n_0, rng, self.device
        )
        return BrakedownParams(
            num_vars=num_vars,
            num_rows=(1 << num_vars) // code.row_len,
            code=code,
        )

    def trim(self, param: BrakedownParams, poly_size: int, batch_size: int):
        if poly_size != 1 << param.num_vars:
            raise ValueError("cannot trim Brakedown params to different size")
        return param, param

    def dummy_commitment(self):
        return BrakedownCommitment(root=ZERO_HASH)

    # ----------------------------------------------------------------- commit
    def commit(self, pp: BrakedownParams, poly: MLPoly) -> BrakedownCommitment:
        assert poly.num_vars == pp.num_vars
        k, dev = pp.num_vars, poly.evals.device
        code = pp.code
        # stages, not spans that synchronise: a commit's time on the card is
        # read from their events
        with timer.span(f"brakedown_commit-{k}", sync=False, device=dev, request=True):
            matrix = poly.evals.reshape(pp.num_rows, code.row_len, limb.L)
            # rows encode independently: under a mesh each rank encodes its
            # block of rows (reference brakedown.py:88-94), and the columns
            # are hashed on every rank once the encoded rows are gathered
            block = parallel.row_block(pp.num_rows)
            with timer.span(f"brakedown_encode-{k}", sync=False, device=dev):
                if block is None:
                    columns = code.encode_columns(matrix)  # [cw, num_rows, 8]
                else:
                    block.mesh.taken["brakedown_commit"] += 1
                    columns = sharded.all_gather_cat(
                        block.mesh, code.encode_columns(block.take(matrix)), 1)
            with timer.span(f"brakedown_from_mont-{k}", sync=False, device=dev):
                canon = limb.from_mont(pp.spec, columns)
            del columns
            with timer.span(f"brakedown_columns-{k}", sync=False, device=dev):
                nodes = _column_hashes(canon)
            with timer.span(f"brakedown_merkle-{k}", sync=False, device=dev):
                _merkle_levels(nodes)
            with timer.span(f"brakedown_readback-{k}", sync=False, device=dev):
                rows, tree = _read_back(canon, nodes)
        return BrakedownCommitment(root=tree[-1].tobytes(), rows=rows.transpose(1, 0, 2),
                                   intermediate_hashes=MerkleNodes(tree[:-1]))

    def batch_commit(self, pp, polys):
        return [self.commit(pp, p) for p in polys]

    def commit_and_write(self, pp, poly, transcript: Keccak256Transcript):
        comm = self.commit(pp, poly)
        transcript.write_commitment_hash(comm.root)
        return comm

    def batch_commit_and_write(self, pp, polys, transcript):
        comms = self.batch_commit(pp, polys)
        for c in comms:
            transcript.write_commitment_hash(c.root)
        return comms

    def read_commitments(self, vp, n, transcript) -> List[BrakedownCommitment]:
        return [
            BrakedownCommitment(root=transcript.read_commitment_hash())
            for _ in range(n)
        ]

    # ------------------------------------------------------------------- open
    def open(
        self,
        pp: BrakedownParams,
        poly: MLPoly,
        comm: BrakedownCommitment,
        point: Sequence[Fp],
        eval_: Fp,
        transcript: Keccak256Transcript,
    ) -> None:
        spec = pp.spec
        code = pp.code
        row_len = code.row_len
        cw = code.codeword_len
        t_0, t_1 = _point_to_tensor(spec, pp.num_rows, point)

        matrix = poly.evals.reshape(pp.num_rows, row_len, limb.L)

        def combine(coeffs: Sequence[Fp]) -> List[Fp]:
            total = weighted_sum(spec, list(matrix), coeffs)  # [row_len, 8]
            return [Fp(v, spec) for v in limb.to_canonical_ints(spec, total)]

        if pp.num_rows > 1:
            for _ in range(code.num_proximity_testing):
                coeffs = transcript.squeeze_challenges(pp.num_rows)
                transcript.write_field_elements(combine(coeffs))
            t0_combined = combine(t_0)
        else:
            t0_combined = poly.to_fps()
        transcript.write_field_elements(t0_combined)

        # sanity: <t_0 row, t_1> == eval
        acc = Fp.zero(spec)
        for a, b in zip(t0_combined, t_1):
            acc = acc + a * b
        assert acc == eval_, "brakedown open: consistency sanity check failed"

        depth = (cw - 1).bit_length()
        for _ in range(code.num_column_opening):
            column = _squeeze_challenge_idx(transcript, cw)
            for r in range(pp.num_rows):
                transcript.write_field_element(
                    Fp(int.from_bytes(comm.rows[r, column].astype("<i4").tobytes(), "little"),
                       spec)
                )
            offset = 0
            for idx in range(depth):
                width = 1 << (depth - idx)
                neighbor = (column >> idx) ^ 1
                transcript.write_commitment_hash(
                    comm.intermediate_hashes[offset + neighbor]
                )
                offset += width

    def batch_open(self, pp, polys, comms, points, evals, transcript):
        for e in evals:
            self.open(
                pp, polys[e.poly], comms[e.poly], points[e.point], e.value,
                transcript,
            )

    # ----------------------------------------------------------------- verify
    def verify(
        self,
        vp: BrakedownParams,
        comm: BrakedownCommitment,
        point: Sequence[Fp],
        eval_: Fp,
        transcript: Keccak256Transcript,
    ) -> None:
        spec = vp.spec
        code = vp.code
        row_len = code.row_len
        cw = code.codeword_len
        t_0, t_1 = _point_to_tensor(spec, vp.num_rows, point)

        combined_rows: List[Tuple[List[Fp], List[Fp]]] = []

        def encode_row(row: List[Fp]) -> List[int]:
            tensor = limb.from_canonical_ints(spec, [int(v) for v in row], self.device)
            return limb.to_canonical_ints(spec, code.encode_single(tensor))

        if vp.num_rows > 1:
            for _ in range(code.num_proximity_testing):
                coeffs = transcript.squeeze_challenges(vp.num_rows)
                row = transcript.read_field_elements(row_len)
                combined_rows.append((coeffs, encode_row(row)))
        row = transcript.read_field_elements(row_len)
        t0_combined_row = row
        combined_rows.append((t_0, encode_row(row)))

        depth = (cw - 1).bit_length()
        # read every opening first (same transcript order), then verify
        # hashes/proximity in BATCH: the per-column loop made
        # num_column_opening*(depth+1) serial hasher calls and a Python
        # Fp multiply per (opening, row) — thousands of each per proof
        openings = []
        for _ in range(code.num_column_opening):
            column = _squeeze_challenge_idx(transcript, cw)
            items = transcript.read_field_elements(vp.num_rows)
            path = [transcript.read_commitment_hash() for _ in range(depth)]
            openings.append((column, items, path))

        # proximity: combined[o] = Σ_r coeffs[r]·items[o][r], vectorized
        items_mat = limb.from_canonical_ints(
            spec, [int(v) for (_, items, _) in openings for v in items], self.device
        ).reshape(len(openings), vp.num_rows, limb.L)
        for coeffs, encoded in combined_rows:
            if vp.num_rows > 1:
                combined = weighted_sum(
                    spec, [items_mat[:, r] for r in range(vp.num_rows)], coeffs
                )  # [n_open, 8]
            else:
                combined = items_mat[:, 0]
            got = limb.to_canonical_ints(spec, combined)
            for (column, _, _), item in zip(openings, got):
                if item != encoded[column]:
                    raise ValueError("Proximity failure")

        # merkle paths: batch each level's 64-byte messages
        outputs = keccak256_many(
            [
                b"".join(it.to_repr() for it in items)
                for (_, items, _) in openings
            ]
        )
        for idx in range(depth):
            blobs = []
            for (column, _, path), output in zip(openings, outputs):
                neighbor = path[idx]
                if (column >> idx) & 1 == 0:
                    blobs.append(output + neighbor)
                else:
                    blobs.append(neighbor + output)
            outputs = keccak256_many(blobs)
        for output in outputs:
            if output != comm.root:
                raise ValueError("Invalid merkle tree opening")

        acc = Fp.zero(spec)
        for a, b in zip(t0_combined_row, t_1):
            acc = acc + a * b
        if acc != eval_:
            raise ValueError("Consistency failure")

    def batch_verify(self, vp, comms, points, evals, transcript):
        for e in evals:
            self.verify(vp, comms[e.poly], points[e.point], e.value, transcript)


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def _point_to_tensor(spec, num_rows: int, point: Sequence[Fp]):
    """(t_0 over high vars [num_rows], t_1 over low vars [row_len])
    (brakedown.rs:419-425)."""
    assert num_rows & (num_rows - 1) == 0
    split = len(point) - (num_rows.bit_length() - 1)
    lo_vars, hi_vars = list(point[:split]), list(point[split:])
    t_0 = eq_xy(spec, hi_vars, "cpu").to_fps() if hi_vars else [Fp.one(spec)]
    t_1 = eq_xy(spec, lo_vars, "cpu").to_fps() if lo_vars else [Fp.one(spec)]
    return t_0, t_1


def _squeeze_challenge_idx(transcript: Keccak256Transcript, cap: int) -> int:
    challenge = transcript.squeeze_challenge()
    return int.from_bytes(challenge.to_repr()[:4], "little") % cap


def _column_hashes(canon: torch.Tensor) -> torch.Tensor:
    """The tree's nodes, int32[2 * width - 1, 8] (kernels/brakedown.py), with
    the leaves filled: column j's digest, its message the rows' 32-byte
    little-endian canonical values, row after row (brakedown.rs:152-190, the
    reference's _merklize_device), then zero hashes up to width, a power of
    two."""
    if canon.is_cuda:
        return kbrakedown.column_hashes_cuda(canon)
    return _column_hashes_plain(canon)


def _column_hashes_plain(canon: torch.Tensor) -> torch.Tensor:
    """``_column_hashes`` by utils/keccak_device.py, on any device."""
    cw, rows, _ = canon.shape
    width = kbrakedown.tree_width(cw)
    nodes = torch.zeros((2 * width - 1, limb.L), dtype=torch.int32, device=canon.device)
    words = (canon.to(torch.int64) & keccak_device.M32).reshape(cw, rows * limb.L).T
    nodes[:cw] = _signed(keccak_device.keccak256_fixed(words, 32 * rows).T)
    return nodes


def _merkle_levels(nodes: torch.Tensor) -> None:
    """Every level above the leaves, in place: each node the digest of its
    children's 64 bytes, the root last."""
    if nodes.is_cuda:
        kbrakedown.merkle_levels_cuda(nodes)
    else:
        _merkle_levels_plain(nodes)


def _merkle_levels_plain(nodes: torch.Tensor) -> None:
    """``_merkle_levels`` by utils/keccak_device.py, on any device."""
    width, offset = (nodes.shape[0] + 1) // 2, 0
    while width > 1:
        words = (nodes[offset:offset + width].to(torch.int64) & keccak_device.M32)
        digests = keccak_device.keccak256_fixed(words.reshape(width // 2, 16).T, 64)
        nodes[offset + width:offset + width + width // 2] = _signed(digests.T)
        offset += width
        width //= 2


def _signed(words: torch.Tensor) -> torch.Tensor:
    """int64 words below 2^32 as the int32 of the same bits."""
    return (words - ((words >> 31) << 32)).to(torch.int32)


def _read_back(canon: torch.Tensor, nodes: torch.Tensor):
    """The canonical codeword [cw, rows, 8] int32 and the nodes uint8[n, 32]
    on the host.  From the card, one copy each into page-locked buffers of
    PyTorch's host allocator: a buffer is reused only once the arrays that
    view it are gone, so no two live commitments share one."""
    if not canon.is_cuda:
        return canon.numpy(), nodes.numpy().view(np.uint8)
    host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True) for t in (canon, nodes)]
    for h, t in zip(host, (canon, nodes)):
        h.copy_(t, non_blocking=True)
    torch.cuda.current_stream(canon.device).synchronize()
    timer.device_read(canon)
    return host[0].numpy(), host[1].numpy().view(np.uint8)
