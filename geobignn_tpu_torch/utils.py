"""Device selection shared by the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for
    another.  Raises when CUDA is asked for (the default) and no GPU is
    present — the port never moves to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "geobignn_tpu_torch runs on CUDA by default and no GPU is "
            "available; pass device='cpu' to run the plain PyTorch versions"
        )
    return dev
