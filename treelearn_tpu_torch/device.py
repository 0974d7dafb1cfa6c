"""Device selection for the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller passes
    another one.  Raises when CUDA is asked for (explicitly or by default)
    and no card is present — the port never drops to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "treelearn_tpu_torch: CUDA is not available; pass device='cpu' "
            "to run the plain PyTorch versions of the kernels")
    return dev
