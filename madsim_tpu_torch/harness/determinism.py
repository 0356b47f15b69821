"""Nondeterminism detection and localization (the counterpart of
`madsim_tpu.harness.determinism`).

The reference's rand-log checker hashes every RNG draw and panics at the
first divergent draw on replay (rand.rs:72-96, runtime/mod.rs:144-187,
MADSIM_TEST_CHECK_DETERMINISM). Because the whole cluster is a tensor
state, the analog is stronger and simpler: run two replicas of the same
seed in lockstep, fingerprint the full state, and bisect to the first
divergent STEP, then show the event that was dispatched there.
"""

from __future__ import annotations

import numpy as np


def find_divergence(rt, seed: int, max_steps: int, probe: int = 64):
    """Run seed twice in lockstep; return None if identical, else a dict
    {step, event} locating the first step whose post-state fingerprints
    differ (event=None when the divergence does not reproduce from the
    window's start, where the JAX package reports the same).

    `rt` needs `init_single(seed)`, `run_exact(state, steps,
    collect_events=True)` (exactly `steps` steps, the input left as it
    is; events [steps, B, ...] numpy arrays) and `fingerprints(state)`.
    Windows of `probe` steps, bisected in power-of-two halves."""

    def runner(state, steps):
        return rt.run_exact(state, steps, collect_events=True)

    def same(x, y):
        return np.asarray(rt.fingerprints(x))[0] \
            == np.asarray(rt.fingerprints(y))[0]

    s1 = rt.init_single(seed)
    s2 = rt.init_single(seed)
    step = 0
    while step < max_steps:
        n1, _ = runner(s1, probe)
        n2, _ = runner(s2, probe)
        if not same(n1, n2):
            # invariant: (a1, a2) identical after `lo` window steps, the
            # divergence within the next hi - lo
            a1, a2 = s1, s2
            lo, hi = 0, probe
            while hi - lo > 1:
                half = (hi - lo) // 2
                m1, _ = runner(a1, half)
                m2, _ = runner(a2, half)
                if not same(m1, m2):
                    hi = lo + half     # diverges in the first half
                else:
                    a1, a2, lo = m1, m2, lo + half
            # confirm: nondeterminism may not reproduce on re-execution
            # from the snapshot; then report the window with event=None
            f1, e1 = runner(a1, 1)
            f2, _ = runner(a2, 1)
            if same(f1, f2):
                return dict(step=step + lo, event=None)
            ev = {k: np.asarray(v)[0, 0] for k, v in e1.items()}
            return dict(step=step + lo, event=ev)
        s1, s2 = n1, n2
        step += probe
        if bool(n1.halted.all()):
            break
    return None
