# Copied from plonkish_tpu/backend/pcs_api.py; imports resolve inside plonkish_tpu_torch.
"""PCS-facing shared types (reference pcs.rs:132-177)."""

from __future__ import annotations

import dataclasses

from ..fields.host import Fp


@dataclasses.dataclass
class Evaluation:
    """A claimed evaluation: poly index, point index, value."""

    poly: int
    point: int
    value: Fp
