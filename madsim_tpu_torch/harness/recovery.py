"""Recovery invariants: failing to heal as a crash code (the counterpart
of `madsim_tpu.harness.recovery`).

The windowed series plane (cfg.series_windows) records when things
happened in simulated time; `recovery_invariant(p99_le=..., qhw_le=...,
within=R)` builds a `Runtime(invariant=)` callable over the lanes'
series leaves that crashes a lane which still misses its steady-state
envelope once R windows have passed after its last disruptive fault
window, with `CRASH_RECOVERY`, so search and minimisation inherit the
verdict. Installing one makes the series plane part of that runtime's
replay domain; keep every lane's series recording on, since a
`series_lanes`-masked lane never fills a window and its oracle can never
fire.

Windowing (core/step.py, the obs_fold kernel): a dispatch at `now` lands
in window min(now // max(window_len, 1), W - 1); a window w is judged
only once complete ((w + 1) * window_len <= now); only the SRF_DISRUPT
bits (kill, partition, net, gray, conn) start the recovery clock.

The check is all-integer torch over the state's leaves, with no host
value and no host sync, so it runs inside a CUDA-graph capture
(`run_fused`) as it does in the eager step, and fires on the same
dispatch in every replay.
"""

from __future__ import annotations

import torch

from ..core import types as T
from ..parallel.stats import bucket_lower_edge

_I32 = torch.int32


def recovery_invariant(p99_le: int | None = None,
                       qhw_le: int | None = None, *,
                       within: int = 2, min_count: int = 1,
                       code: int = T.CRASH_RECOVERY):
    """Build a `Runtime(invariant=)` callable that crashes a lane which
    fails to return to its steady-state envelope after faults stop.

    Args:
      p99_le: each judged window's e2e p99 estimate must be at or under
        this many ticks (needs cfg.latency_hist > 0 and complete_kinds).
      qhw_le: each judged window's queue high-water must be at or under
        this occupancy. Give either threshold or both.
      within: grace windows after the last disruptive fault window;
        judging starts at window last_fault + within.
      min_count: a window's p99 is judged only once it folded at least
        this many completions; the qhw_le check has no such guard.
      code: the crash code reported (default CRASH_RECOVERY).

    A lane with no disruptive fault window never fires. Windows that
    never completed are never judged. The p99 estimate is the bucket-CDF
    lower bound. Requires cfg.series_windows > 0 (raises at the first
    step otherwise); the p99_le form also the latency plane.
    """
    if p99_le is None and qhw_le is None:
        raise ValueError("recovery_invariant needs p99_le= or qhw_le= "
                         "(or both)")
    if int(within) < 1:
        raise ValueError("within must be >= 1 window of grace")
    within_i = int(within)
    min_count_i = int(min_count)

    def check(state):
        sf = state.sr_fault                                  # [B, W]
        W = sf.shape[-1]
        if W == 0:
            raise ValueError(
                "recovery_invariant needs the windowed telemetry plane "
                "compiled in — set SimConfig(series_windows=...) > 0")
        if p99_le is not None and (state.sr_lat.shape[-2] == 0
                                   or state.sr_lat.shape[-1] == 0):
            raise ValueError(
                "recovery_invariant(p99_le=) needs the latency plane — "
                "set SimConfig(latency_hist=...) > 0 and declare "
                "complete_kinds (use qhw_le= for a queue-only oracle)")
        wl = torch.clamp(state.window_len, min=1)[:, None]   # [B, 1]
        # the window indices (int32, so the products wrap as the JAX
        # package's do), made on the state's device: no host copy
        widx = torch.arange(W, dtype=_I32, device=sf.device)[None, :]
        complete = (widx + 1) * wl <= state.now[:, None]
        fault_w = (sf & T.SRF_DISRUPT) != 0
        has_fault = fault_w.any(-1)
        # the last disruptive window (garbage where there is none: the
        # verdict is gated on has_fault)
        last = (W - 1) - torch.argmax(
            torch.flip(fault_w, (-1,)).to(_I32), -1).to(_I32)
        judged = complete & (widx >= last[:, None] + within_i)
        bad_w = torch.zeros_like(fault_w)
        if qhw_le is not None:
            bad_w = bad_w | (state.sr_qhw > int(qhw_le))
        if p99_le is not None:
            counts = state.sr_lat.to(_I32)                   # [B, W, LB]
            total = counts.sum(-1).to(_I32)                  # [B, W]
            cdf = torch.cumsum(counts, -1).to(_I32)
            need = torch.clamp((total * 99 + 99) // 100, min=1)
            b = torch.argmax((cdf >= need[..., None]).to(_I32), -1).to(_I32)
            edge = torch.where(total > 0, bucket_lower_edge(b), 0)
            bad_w = bad_w | ((total >= min_count_i) & (edge > int(p99_le)))
        bad = state.sr_on & has_fault & (judged & bad_w).any(-1)
        return bad, torch.full_like(state.now, code)

    return check
