"""Mask guards shared by the effect helpers (the counterpart of
`madsim_tpu.utils.maskutil`).

Every effect runs under a `when` mask so a handler's emissions have a
static count. The JAX package lets a helper skip a masked block whose
mask is a concrete all-False value; under `jit` every mask is a tracer,
so the simulator never skips one. This package's step is eager, so a
tensor mask is never skipped either, even when it is all False: reading
it would wait for the device (and break a CUDA-graph capture), and
skipping would drop emissions, changing the emission count and with it
the network keys' split. Only host constants (a Python bool, a numpy
value) that are all False may be skipped — the same rule as
`core/api.py` `_statically_false`.
"""

from __future__ import annotations

import numpy as np
import torch


def needed(mask) -> bool:
    """Guard for a masked block of handler logic: False only for a host
    constant that is all False; always True for a tensor."""
    return not statically_false(mask)


def statically_false(mask) -> bool:
    """True iff `mask` is a host constant (Python or numpy, never a
    tensor) that is all False: the effect provably does nothing."""
    if isinstance(mask, torch.Tensor):
        return False
    if isinstance(mask, bool):
        return not mask
    try:
        return not bool(np.asarray(mask).any())
    except (TypeError, ValueError):
        return False
