"""Which device the package's entry points put their tensors on.

The package is written for an NVIDIA GPU: an entry point called without a
device uses the card, and fails where there is none. A caller that wants
the CPU (the parity tests do) says so.
"""
from __future__ import annotations

import torch


def resolve(device=None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means ``cuda`` and
    raises where CUDA is not available — there is no quiet step down to
    the CPU."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no device was given and CUDA is not available: "
            "etol_tpu_torch runs on the card by default; pass "
            "device='cpu' to run on the CPU"
        )
    return torch.device("cuda")
