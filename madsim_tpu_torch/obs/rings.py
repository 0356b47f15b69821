"""Read the on-device flight-recorder ring out of a final SimState (the
counterpart of `madsim_tpu.obs.rings`).

The ring is written inside the step (the epilogue of the `emit_write`
kernel, gated on cfg.trace_cap > 0 and the per-lane `trace_on` sampling
mask set by `Runtime.init_batch(trace_lanes=...)`): the last trace_cap
FIRED events per sampled lane, with `trace_pos` counting every event ever
recorded, so `pos > cap` means the ring wrapped and the oldest
`pos - cap` records were overwritten. The ring rides in the state, so it
works with `run_fused`, which returns no per-step records.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.state import TRACE_FIELDS

# record columns = the tr_* schema fields, names sans prefix
_COLS = tuple(f[3:] for f in TRACE_FIELDS if f.startswith("tr_"))


def _host(t) -> np.ndarray:
    """An owned numpy copy: the caller may keep it while the state's
    buffers are reused by a later run."""
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().numpy().copy()
    return np.array(t, copy=True)


def sampled_lanes(state) -> np.ndarray:
    """Indices of the lanes whose rings recorded (the `trace_lanes` the
    batch was initialized with, as observed from the state itself)."""
    return np.nonzero(np.atleast_1d(_host(state.trace_on)))[0]


def ring_records(state, lane: int = 0) -> dict:
    """One lane's ring, unwrapped into chronological order (host-side).

    Returns {now, step, kind, node, src, tag, parent, lamport: int32[n],
    total: int, dropped: int} where n = min(total, trace_cap), `total` is
    every event the lane ever recorded and `dropped` counts ring-wrap
    overwrites (oldest first). Zero-size columns (planes compiled out)
    are absent. Raises if the runtime compiled the ring out or the lane
    was not sampled — a silent empty trace would read as "nothing
    happened"."""
    if state.tr_now.shape[-1] == 0:
        raise ValueError("trace ring is compiled out (cfg.trace_cap == 0)")
    cols = {k: _host(getattr(state, f"tr_{k}")) for k in _COLS
            if getattr(state, f"tr_{k}").shape[-1] > 0}
    pos = _host(state.trace_pos)
    on = _host(state.trace_on)
    cap_arr = _host(state.trace_cap)
    if cols["now"].ndim == 2:          # batched state: select the lane
        cols = {k: v[lane] for k, v in cols.items()}
        pos, on = pos[lane], on[lane]
        cap_arr = cap_arr[lane] if cap_arr.ndim else cap_arr
    cap = int(cap_arr)
    if not bool(on):
        raise ValueError(
            f"lane {lane} was not sampled (init_batch trace_lanes mask); "
            f"sampled lanes: {sampled_lanes(state).tolist()}")
    total = int(pos)
    n = min(total, cap)
    # oldest surviving record sits at pos % cap once wrapped, at 0 before
    start = total % cap if total > cap else 0
    order = (start + np.arange(n)) % cap
    out = {k: v[order] for k, v in cols.items()}
    out["total"] = total
    out["dropped"] = total - n
    return out
