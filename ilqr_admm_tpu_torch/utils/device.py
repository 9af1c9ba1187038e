"""Where the port's entry points run."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device of an entry point: the CUDA card unless the caller names
    another (the CPU runs the plain torch versions of the kernels).

    Raises RuntimeError for a CUDA device when no card is present, so that
    a solver built without a `device` never quietly runs on the CPU.
    """
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the plain "
            "torch versions of the kernels on the CPU"
        )
    return device
