"""Heartbeat failure detection as reusable state-machine helpers (the
counterpart of `madsim_tpu.utils.detector`).

Fixed-shape helpers a `Program` calls from its handlers, so any protocol
gains a timeout-based suspect list (suspect after `timeout` of silence,
rehabilitate on any message) without hand-rolling the bookkeeping.

State contract — embed via `detector_state(n_nodes)` in the state spec:
  fd_last  int32[N]  virtual time a heartbeat/message was last seen from
                     each peer (self entry is refreshed by `saw` on a tick)
  fd_susp  int32[N]  1 while a peer is suspected

Inside a handler every leaf carries the lane axis ([B, N]), `now` and
`src` are [B], and `when` is a Python bool or a [B] mask. Usage:
    init:       `reset(st, ctx.now)`; arm a periodic tick; `beat(ctx, N)`
    on_message: `saw(st, src, ctx.now)` on ANY message
    on_timer:   `st["fd_susp"] = suspects(st, ctx.now, timeout)`; re-arm
"""

from __future__ import annotations

import torch

TAG_HEARTBEAT = (1 << 29) | 0x5EA7  # above the 29-bit service-tag space

_I32 = torch.int32


def _col(x):
    """A per-lane [B] tensor as a [B, 1] column; a Python value as is."""
    return x.unsqueeze(-1) if isinstance(x, torch.Tensor) else x


def _where(when, a, b):
    """`where(when, a, b)` for a [B, 1] mask or a Python bool."""
    if isinstance(when, torch.Tensor):
        return torch.where(when, a, b)
    return a if when else b


def detector_state(n_nodes: int):
    """State-spec fragment: merge into the program's spec dict."""
    return dict(
        fd_last=torch.zeros((n_nodes,), dtype=_I32),
        fd_susp=torch.zeros((n_nodes,), dtype=_I32),
    )


def reset(st, now, *, when=True):
    """Boot/restart grace period: count every peer as just-seen at `now`
    (a RESTARTED node then measures silence from its rebirth)."""
    w = _col(when)
    st["fd_last"] = _where(w, torch.zeros_like(st["fd_last"]) + _col(now),
                           st["fd_last"])
    st["fd_susp"] = _where(w, torch.zeros_like(st["fd_susp"]),
                           st["fd_susp"])
    return st


def saw(st, src, now, *, when=True):
    """Record proof of life from `src` at `now` (call on ANY message)."""
    last = st["fd_last"]
    oh = torch.arange(last.shape[-1], dtype=_I32,
                      device=last.device) == _col(src)
    st["fd_last"] = torch.where(oh & _col(when),
                                torch.maximum(last, _col(now)), last)
    return st


def beat(ctx, n_nodes: int, *, when=True):
    """Broadcast a heartbeat to every peer (skips self)."""
    for d in range(n_nodes):
        ctx.send(d, TAG_HEARTBEAT, when=when & (ctx.node != d))


def suspects(st, now, timeout):
    """-> int32 [B, N] suspicion mask: 1 where `timeout` has elapsed since
    a peer's last proof of life (int32 arithmetic, wrapping as in the
    reference)."""
    return (_col(now) - st["fd_last"] > timeout).to(_I32)
