"""PCT-style priority perturbation over the event scheduler's tie-breaks.

The counterpart of `madsim_tpu.search.pct`. The scheduler's only free
decision is the tie-break among earliest-deadline events; a nonzero
`SimState.prio_nudge` replaces that uniform draw with a deterministic
priority order keyed on (nudge, slot identity) — the nudged path of the
select kernel (csrc/sched_pick.cu). One nudge value is one tie-breaking
policy, and a whole batch of policies runs as one sweep. `prio_nudge ==
0` is bit-identical to the hook's absence, and (seed, nudge) is a
complete repro handle.
"""

from __future__ import annotations

import numpy as np
import torch

from ..parallel import stats


def with_prio_nudge(state, nudge):
    """Set the per-lane PCT nudge on a batched state. `nudge` is a scalar
    (applied to every lane) or an int32[B] array."""
    if not isinstance(nudge, torch.Tensor):
        nudge = np.asarray(nudge, np.int32)
    nudge = torch.as_tensor(nudge, dtype=torch.int32,
                            device=state.prio_nudge.device)
    return state.replace(prio_nudge=torch.broadcast_to(
        nudge, state.prio_nudge.shape).contiguous())


def pct_sweep(rt, seed: int, nudges, max_steps: int, chunk: int = 512,
              fused: bool = True, knobs: dict | None = None, plan=None):
    """Run ONE seed under many tie-break policies in one batch: lane i
    replays `seed` with prio_nudge = nudges[i]. `knobs` (one lane's fuzz
    knob vector, with its KnobPlan) replays a mutant under the sweep; its
    own prio_nudge is overridden per lane.

    Returns a dict with per-lane u64 schedule hashes, the distinct count,
    and {nudge: crash_code} for lanes that crashed."""
    nudges = np.asarray(nudges, np.int32).reshape(-1)
    B = nudges.shape[0]
    state = rt.init_batch(np.full(B, seed, np.uint32))
    if knobs is not None:
        from .mutate import apply_repro_knobs
        state, plan = apply_repro_knobs(rt, state, knobs, plan)
    state = with_prio_nudge(state, nudges)
    if fused:
        state = rt.run_fused(state, max_steps, chunk)
    else:
        state, _ = rt.run(state, max_steps, chunk)
    hashes = stats.sched_hash_u64(state)
    crashed = state.crashed.cpu().numpy()
    codes = state.crash_code.cpu().numpy()
    return dict(
        hashes=hashes,
        distinct_schedules=int(len(np.unique(hashes))),
        crashed_by_nudge={int(nudges[i]): int(codes[i])
                          for i in np.nonzero(crashed)[0]},
    )
