"""plonkish_tpu_torch: the PyTorch/CUDA port of plonkish_tpu.

The JAX package stays the reference; this package imports torch, numpy and
the standard library only.  Entry points run on the CUDA card unless the
caller passes ``device="cpu"``, where every kernel takes its plain version.
"""

import torch

__version__ = "0.1.0"


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller says
    otherwise.  Never falls back to the CPU on its own."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run on the CPU"
            )
        return torch.device("cuda")
    return torch.device(device)
