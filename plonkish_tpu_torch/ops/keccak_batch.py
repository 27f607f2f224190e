"""Batched Keccak-256 for commitment-sized work (port of
plonkish_tpu/ops/keccak_batch.py).

Brakedown's verifier hashes thousands of columns and Merkle nodes
(brakedown.rs:152-184), IPA's setup one candidate point per basis element.
The native C++ hasher of ``ops/_keccak_native.py`` does the work; unlike the
reference, a missing compiler raises instead of falling back to pure Python.
"""

from __future__ import annotations

from typing import List

from . import _keccak_native


def keccak256_many(blobs: List[bytes]) -> List[bytes]:
    return _keccak_native.keccak256_many(blobs)
