"""PyTorch + CUDA port of the ``repro`` serving stack, for NVIDIA Hopper.

Mirrors ``repro``'s layout (``configs/``, ``kernels/``, ``models/``,
``serve/``, ``launch/``).  Imports ``torch`` and numpy only: nothing of
JAX and nothing of ``repro`` (what it needs of ``repro``'s jax-free
modules it keeps as its own copies).

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
without CUDA and without an explicit CPU request they raise instead of
carrying on silently on the host (``resolve_device``).
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the card: raise when CUDA is missing rather than
    fall back to the CPU.  Anything else is taken as the caller asked."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on a CUDA device by default and none is "
                "available; pass device='cpu' to run the plain versions "
                "on the host")
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is unavailable")
    return dev
