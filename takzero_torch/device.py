"""Device selection shared by the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means ``cuda``; raise when CUDA is asked for but missing.

    There is no silent CPU fallback: a caller that wants the CPU (the
    tests) says so with ``device="cpu"``.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "takzero_torch: CUDA device requested but torch.cuda.is_available() "
            "is False (pass device='cpu' to run on the CPU)"
        )
    return dev
