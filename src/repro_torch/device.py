"""Device selection shared by the port's entry points."""
from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """The ``torch.device`` an entry point runs on.

    Defaults to the CUDA card and raises when there is none: a caller that
    wants the CPU (the tests do) says so with ``device="cpu"``, so a run
    that silently lost its GPU never reports CPU numbers as the card's.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the "
            "CPU")
    return dev
