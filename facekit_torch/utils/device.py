"""Device selection for every entry point of the port."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``device`` (default ``"cuda"``) as a ``torch.device``.

    Raises when CUDA is asked for and there is none: an entry point never
    drops to the CPU on its own; a caller who wants the CPU says so.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run on the CPU")
    return dev
