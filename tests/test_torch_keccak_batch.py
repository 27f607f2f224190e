"""Keccak-256 of the port against its pure-Python hasher: the native batch
hasher (ops/keccak_batch.py, built with g++ into plonkish_tpu_torch/_build/),
the batched torch version (utils/keccak_device.py) that Brakedown's commit
runs on the device, and the transcript's streaming hasher, at lengths around
the 136-byte rate; and the Merkle tree of Brakedown's commit against the
reference's host tree."""

import random

import pytest
import torch

from plonkish_tpu_torch.ops import _keccak_native
from plonkish_tpu_torch.ops.keccak_batch import keccak256_many
from plonkish_tpu_torch.utils import keccak, keccak_device

LENGTHS = [0, 1, 135, 136, 137, 4096]


def _blobs(length, count=3, seed=0):
    rng = random.Random(length + seed)
    return [bytes(rng.randrange(256) for _ in range(length)) for _ in range(count)]


@pytest.mark.parametrize("length", LENGTHS)
def test_native_batch(length):
    blobs = _blobs(length)
    assert keccak256_many(blobs) == [keccak.keccak256(b) for b in blobs]


@pytest.mark.parametrize("length", LENGTHS)
def test_device_batch(length):
    blobs = _blobs(length)
    words = keccak_device.words_from_bytes(blobs)
    got = keccak_device.digests_to_bytes(keccak_device.keccak256_fixed(words, length))
    assert got == [keccak.keccak256(b) for b in blobs]


def test_known_digest():
    # Keccak-256 of the empty string (Ethereum's padding, not NIST SHA3-256)
    want = bytes.fromhex("c5d2460186f7233c927e7db2dcc703c0e500b653ca82273b7bfad8045d85a470")
    assert keccak256_many([b""]) == [want] and keccak.keccak256(b"") == want


def test_transcript_hasher_is_native_and_streams():
    assert keccak.Keccak256 is keccak._NativeKeccak256
    parts = _blobs(50, 5, 1) + _blobs(137, 2, 2)
    h, ref = keccak.Keccak256(), keccak._PyKeccak256()
    for p in parts:
        h.update(p)
        ref.update(p)
    assert h.export_state() == ref.export_state()
    assert h.finalize_reset() == ref.digest() == keccak.keccak256(b"".join(parts))
    assert h.digest() == keccak.keccak256(b"")


def test_build_is_cached_in_the_build_directory():
    path = _keccak_native._build()
    assert path.parent.name == "_build" and path.exists()
    assert _keccak_native._build() == path


def test_merkle_tree_matches_reference():
    """Column hashes and every level, padded with zero hashes, as the
    reference's host _merklize computes them: the port's tree of nodes
    (_column_hashes, _merkle_levels) read as the commitment reads it."""
    import numpy as np
    from plonkish_tpu.pcs.brakedown import _column_bytes, _hash_many, _merklize
    from plonkish_tpu_torch.fields import limb
    from plonkish_tpu_torch.fields.spec import BN254_FR
    from plonkish_tpu_torch.pcs.brakedown import MerkleNodes, _column_hashes, _merkle_levels

    rows, cw = 3, 37
    rng = random.Random(5)
    vals = [rng.randrange(BN254_FR.p) for _ in range(rows * cw)]
    canon = limb.from_ints(vals).reshape(rows, cw, 8)
    digits = torch.stack([canon & 0xFFFF, (canon >> 16) & 0xFFFF], -1).reshape(rows, cw, 16)
    want = _merklize(cw, _hash_many(_column_bytes(digits.numpy())))
    nodes = _column_hashes(canon.transpose(0, 1).contiguous())
    _merkle_levels(nodes)
    tree = nodes.numpy().view(np.uint8)
    assert (list(MerkleNodes(tree[:-1])), tree[-1].tobytes()) == want
