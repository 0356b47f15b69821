"""Checkpoint / resume: snapshot whole seed batches (the counterpart of
`madsim_tpu.runtime.checkpoint`'s batch snapshot).

A checkpoint is an .npz archive with one entry `leaf_{i}` a state leaf,
in the JAX package's flatten order (`interop.state_leaves`) and with its
dtypes (uint32 for keys and hashes), plus a `__treedef__` entry that
lists the leaf paths and is never read. `load` reads only the `leaf_{i}`
entries, so a file written by either package loads in the other. The
lane checkpoints (`LaneCheckpoint`, `checkpoint_lane`, `seed_batch_from`)
wait for ROADMAP P11.8.
"""

from __future__ import annotations

import numpy as np

from ..core.state import SimState
from ..interop import leaf_dtype, state_from_numpy, state_leaves, \
    state_to_numpy


def save(path: str, state: SimState) -> None:
    """Write a batched SimState to an .npz archive."""
    leaves = state_to_numpy(state)
    np.savez_compressed(
        path, __treedef__=np.frombuffer(
            "\n".join(leaves).encode(), dtype=np.uint8),
        **{f"leaf_{i}": a for i, a in enumerate(leaves.values())})


def load(path: str, like: SimState) -> SimState:
    """Read a SimState saved by `save` (by this package or the JAX
    package) onto `like`'s device. `like` supplies the structure (build
    it from the same Runtime, e.g. rt.init_batch(...)); shapes and dtypes
    are checked leaf by leaf."""
    ref = state_leaves(like)
    with np.load(path) as z:
        n = len([k for k in z.files if k.startswith("leaf_")])
        if n != len(ref):
            raise ValueError(
                f"checkpoint has {n} leaves, runtime expects "
                f"{len(ref)} — different config/programs?")
        leaves = {}
        for i, (p, t) in enumerate(ref.items()):
            arr = z[f"leaf_{i}"]
            want = leaf_dtype(p, t)
            if arr.shape != tuple(t.shape) or arr.dtype != want:
                raise ValueError(
                    f"checkpoint leaf {i}: {arr.shape}/{arr.dtype} != "
                    f"expected {tuple(t.shape)}/{want}")
            leaves[p] = arr
    return state_from_numpy(leaves, like.now.device)
