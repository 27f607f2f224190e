from .host import Fp, batch_invert
from .spec import BN254_FQ, BN254_FR, FieldSpec

__all__ = ["Fp", "batch_invert", "FieldSpec", "BN254_FR", "BN254_FQ"]
