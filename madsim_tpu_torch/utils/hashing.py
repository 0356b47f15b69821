"""Per-trajectory state fingerprints (the counterpart of
`madsim_tpu.utils.hashing`).

Every replay-domain leaf of a lane is folded into one uint32 with the
JAX package's FNV rule, so fingerprints computed by the two packages for
the same state are equal:

    for leaf i (in jax tree order), words w[0..n) as uint32:
        lh = sum_k w[k] * (k * 2654435761 + 2i + 1)      (mod 2^32)
        h  = (h ^ lh) * 16777619                         (mod 2^32)

starting from h = 2166136261. Leaves are ordered as `jax.tree.leaves`
orders a dict: sorted by field name, nested dicts (node_state, ext)
sorted by key. float32 leaves contribute their bit patterns, everything
else its value cast to int32. The flight-recorder and other
observation-plane fields (TRACE_FIELDS) are left out.
"""

from __future__ import annotations

import torch

from ..core.prng import MASK32, to_u64
from ..core.state import TRACE_FIELDS, SimState

FNV_OFFSET = 2166136261
FNV_PRIME = 16777619
_GOLDEN = 2654435761

_OBSERVATION_FIELDS = frozenset(TRACE_FIELDS)


def _sorted_leaves(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _sorted_leaves(tree[k])
    else:
        yield tree


def _words(leaf: torch.Tensor) -> torch.Tensor:
    """[B, ...] leaf -> [B, n] uint32 words (as int64 in [0, 2^32))."""
    if leaf.dtype == torch.float32:
        w = leaf.contiguous().view(torch.int32)
    else:
        w = leaf.to(torch.int32)
    return to_u64(w.reshape(w.shape[0], -1))


def fingerprint(state: SimState) -> torch.Tensor:
    """uint32 fingerprint of every lane of a batched state, as int64 [B]
    in [0, 2^32) (the JAX package's `vmap(fingerprint)`)."""
    fields = sorted(f for f in SimState.field_names()
                    if f not in _OBSERVATION_FIELDS)
    leaves = [x for f in fields for x in _sorted_leaves(getattr(state, f))]
    B = state.now.shape[0]
    h = torch.full((B,), FNV_OFFSET, dtype=torch.int64,
                   device=state.now.device)
    for i, leaf in enumerate(leaves):
        w = _words(leaf)
        n = w.shape[1]
        if n:
            mix = (torch.arange(n, dtype=torch.int64, device=w.device)
                   * _GOLDEN + (2 * i + 1)) & MASK32
            # w * mix < 2^64 can leave int64; split w in 16-bit halves so
            # every partial product and the sums stay exact
            lo = ((w & 0xFFFF) * mix) & MASK32
            hi = ((((w >> 16) * mix) & 0xFFFF) << 16)
            lh = ((lo + hi) & MASK32).sum(-1) & MASK32
        else:
            lh = torch.zeros_like(h)
        h = ((h ^ lh) * FNV_PRIME) & MASK32
    return h


# the JAX package's name for the batched form; every function here is
# batched already
batch_fingerprints = fingerprint
