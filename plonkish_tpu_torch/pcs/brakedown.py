"""Multilinear Brakedown PCS [GLSTW21] (port of plonkish_tpu/pcs/brakedown.py).

Protocol mirrors plonkish_backend/src/pcs/multilinear/
brakedown.rs: commit = reshape evals to a [num_rows, row_len] matrix, encode
every row on the device, hash columns, merklize; open = proximity rows +
t0-combined row in clear + spot-checked column openings with merkle paths.

The commit hashes the columns and every Merkle level on the device
(``utils/keccak_device.py``, the reference's ``_merklize_device``); the
verifier hashes its openings' paths with the native batch hasher
(``ops/keccak_batch.py``).  No elliptic curves anywhere.
"""

from __future__ import annotations

import dataclasses
import random
from typing import List, Sequence, Tuple

import numpy as np
import torch

from .. import parallel, resolve_device
from ..fields import limb
from ..fields.host import Fp
from ..fields.spec import FieldSpec
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


@dataclasses.dataclass
class BrakedownCommitment:
    root: bytes
    rows: np.ndarray | None = None  # canonical limbs [num_rows, cw, 8] int32, on the host
    intermediate_hashes: List[bytes] | None = None


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
        spec = pp.spec
        code = pp.code
        matrix = poly.evals.reshape(pp.num_rows, code.row_len, limb.L)
        # rows encode independently: under a mesh each rank encodes its block
        # of rows (reference brakedown.py:88-94), and the columns are hashed
        # on every rank once the encoded rows are gathered
        block = parallel.row_block(pp.num_rows)
        if block is None:
            encoded = code.encode(matrix)
        else:
            block.mesh.taken["brakedown_commit"] += 1
            encoded = sharded.all_gather_cat(block.mesh, code.encode(block.take(matrix)), 0)
        canon = limb.from_mont(spec, encoded)  # [num_rows, cw, 8]
        hashes, root = _merklize_device(canon, code.codeword_len)
        rows = canon.cpu().numpy()
        timer.device_read(canon)
        return BrakedownCommitment(root=root, rows=rows, intermediate_hashes=hashes)

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


def _merklize_device(canon: torch.Tensor, codeword_len: int):
    """Column hashes and every Merkle level on the device
    (brakedown.rs:152-190, the reference's _merklize_device): column j's
    message is the rows' 32-byte little-endian canonical values, row after
    row; the leaves are padded to 2^depth with zero hashes, and each level
    hashes the 64-byte pairs of the one below.  Returns (every node but the
    root, level after level, as bytes; the root)."""
    rows, cw, _ = canon.shape
    words = (canon.to(torch.int64) & keccak_device.M32).permute(0, 2, 1).reshape(rows * 8, cw)
    cur = keccak_device.keccak256_fixed(words, 32 * rows)  # [8, cw]
    depth = (codeword_len - 1).bit_length()
    width = 1 << depth
    if cw < width:  # ZERO_HASH leaves: all-zero words
        cur = torch.cat([cur, torch.zeros((8, width - cw), dtype=cur.dtype, device=cur.device)], 1)
    levels = [cur]
    while cur.shape[1] > 1:
        cur = keccak_device.keccak256_fixed(torch.cat([cur[:, 0::2], cur[:, 1::2]], 0), 64)
        levels.append(cur)
    blobs = keccak_device.digests_to_bytes(torch.cat(levels, dim=1))
    return blobs[:-1], blobs[-1]
