"""Device selection shared by every entry point of the port."""

from __future__ import annotations

import torch


def resolve_device(name: str = "cuda") -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller
    asks for ``cpu``. Asking for ``cuda`` on a machine without a card
    raises; nothing falls back to the CPU quietly."""
    dev = torch.device(name)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {name!r} was asked for but torch finds no CUDA "
                "device; pass device='cpu' (CLI: --device cpu) to run on "
                "the CPU"
            )
        # The port computes in float32 and is held against the JAX
        # package at float32 tolerances. TF32 products keep only ~3
        # decimal digits, so both matmul and cuDNN TF32 stay off.
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {name!r}; use 'cuda' or 'cpu'")
    return dev
