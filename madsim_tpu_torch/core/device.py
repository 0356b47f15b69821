"""Where the port's entry points run: CUDA unless the caller names
another device."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device a runtime runs on: CUDA unless the caller names another.
    With no GPU present and no device named, raise instead of moving to
    the CPU silently."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available: madsim_tpu_torch runs on the "
                "GPU by default; pass device='cpu' to run on the CPU")
        return torch.device("cuda")
    return torch.device(device)
