"""Time travel: exact-step advance (the counterpart of
`madsim_tpu.obs.timetravel`).

Only `advance_exact` is ported, the loop behind `Runtime.state_at`. The
rest of the JAX module (CheckpointLog, lane checkpoints, window replay,
`divergence_report`, the replay behind `explain_crash(replay=True)`)
waits for ROADMAP P11.8.
"""

from __future__ import annotations


def advance_exact(rt, state, steps: int, chunk: int = 512):
    """Advance a batched state by EXACTLY `steps` dispatches per live lane,
    in power-of-two pieces of at most `chunk` (the JAX package's `state_at`
    discipline). Halted lanes freeze; an all-halted batch stops early."""
    remaining = int(steps)
    while remaining > 0:
        c = min(int(chunk), 1 << (remaining.bit_length() - 1))
        state, _ = rt.run_exact(state, c)
        remaining -= c
        if bool(state.halted.all()):
            break
    return state
