"""Shared runs of the replicated KV store and the bank for the
tests/test_torch_raft_kv*.py and test_torch_bank.py parity tests: one
configuration built by both packages from the same arguments, run from
the same seeds (the JAX side once, on the non-partitionable stream), its
final states as {leaf path: numpy array}.
"""

from __future__ import annotations

import numpy as np

import madsim_tpu as J
import madsim_tpu_torch as P
from _torch_parity import jax_leaves, reference_stream
from madsim_tpu_torch import interop


def chaos(mod, n_raft, kills, first_ms, every_ms):
    """`kills` kill_random/restart_random pairs among the servers, the
    restart 500 ms after each kill (the reference tests' chaos, without
    their partition)."""
    sc = mod.Scenario()
    for t in range(kills):
        sc.at(mod.ms(first_ms + every_ms * t)).kill_random(
            among=range(n_raft))
        sc.at(mod.ms(first_ms + 500 + every_ms * t)).restart_random(
            among=range(n_raft))
    return sc


def run_both(make, seeds, max_steps, chunk):
    """make(package, device keywords) -> runtime. Returns (reference
    leaves, port leaves, port final state)."""
    seeds = np.asarray(seeds, np.uint32)
    with reference_stream():
        jrt = make(J, {})
        s, _ = jrt.run(jrt.init_batch(seeds), max_steps, chunk)
        ref = jax_leaves(s)
    rt = make(P, dict(device="cpu"))
    t, _ = rt.run(rt.init_batch(seeds), max_steps, chunk)
    return ref, interop.state_to_numpy(t), t
