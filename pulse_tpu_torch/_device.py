"""Device resolution for the port's entry points: CUDA unless the caller
explicitly asks for another device."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """`None` means the card. Without CUDA that raises: the CPU runs only the
    plain versions of the kernels, so it must be asked for by name."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run the plain "
                "PyTorch versions of the kernels on the CPU"
            )
        if dev.index is None:   # name the card, so devices compare equal to tensors'
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
