"""Handler-side API: what protocol code can do inside a transition.

A protocol is a state machine whose handlers (`init`, `on_message`,
`on_timer`) receive a `Ctx` and record their effects — sends, timers,
timer cancels, a state update, crash and halt requests — functionally.
In this package every handler runs for a whole batch of lanes at once:
`ctx.node`, `ctx.now` and every leaf of `ctx.state` carry a leading [B]
lane axis, and conditional behaviour is the `when=` mask, a [B] bool
tensor. The number of `send`/`set_timer` calls in a handler is static
(plain Python), exactly as in `madsim_tpu.core.api`.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from . import prng
from . import types as T


def _lanes(x, B: int, dtype, device) -> torch.Tensor:
    """A value broadcast to one entry per lane: [B]. Host values become a
    device-side fill (a tensor built from a host value would be a copy
    that waits for the device)."""
    if isinstance(x, torch.Tensor):
        return x.to(dtype).expand(B)
    return torch.full((B,), np.asarray(x).item(), dtype=dtype,
                      device=device)


def as_payload(payload, n_words: int, B: int, device) -> torch.Tensor:
    """Coerce None / a list of per-lane words / a [B, k] tensor into an
    int32 [B, n_words] payload, zero-padded on the right."""
    if payload is None:
        return torch.zeros((B, n_words), dtype=torch.int32, device=device)
    if isinstance(payload, (list, tuple)):
        assert len(payload) <= n_words, \
            "payload too wide for cfg.payload_words"
        if not payload:
            return torch.zeros((B, n_words), dtype=torch.int32,
                               device=device)
        arr = torch.stack([_lanes(x, B, torch.int32, device)
                           for x in payload], dim=-1)
    else:
        arr = torch.as_tensor(payload, device=device).to(torch.int32)
        if arr.ndim == 1:
            arr = arr.expand(B, arr.shape[0])
    assert arr.ndim == 2 and arr.shape[1] <= n_words, \
        f"payload shape {tuple(arr.shape)} too wide for {n_words} words"
    if arr.shape[1] < n_words:
        arr = torch.nn.functional.pad(arr, (0, n_words - arr.shape[1]))
    return arr


def _statically_false(when) -> bool:
    """True iff `when` is a host constant (Python / numpy, never a tensor)
    that is all False: such an effect is skipped outright, as the JAX
    package skips it at trace time. A tensor mask is never skipped, even
    when all False — that keeps the emission count, and with it the
    network-key split, the same as the reference's."""
    if isinstance(when, torch.Tensor):
        return False
    return not bool(np.asarray(when).any())


class Ctx:
    """Effect-collecting handler context for one event in each of B lanes.

    Attributes:
      node:  int32 [B] — the acting node of each lane
      now:   int32 [B] — the node's local virtual time
      state: dict — the node's protocol state, leaves [B, ...]; REASSIGN
             it (``ctx.state = new_state``) to update.
    """

    def __init__(self, cfg: T.SimConfig, node, now, key, state,
                 hash_base=None, draws: dict | None = None):
        self.cfg = cfg
        self.node = node
        self.now = now
        self.state = state
        self._key = key
        self._hash_base = hash_base
        # draw memo shared by the step's handler contexts: every context
        # starts from the same key, so equal draw sequences (the same key
        # object split, the same key drawn with the same constant bounds)
        # are computed once; the values are those of a fresh draw
        self._draws = draws if draws is not None else {}
        self._B = node.shape[0]
        self._dev = node.device
        self._sends: list[dict[str, Any]] = []
        self._timers: list[dict[str, Any]] = []
        self._cancels: list[dict[str, Any]] = []
        self._crash = torch.zeros(self._B, dtype=torch.bool,
                                  device=self._dev)
        self._crash_code = torch.zeros(self._B, dtype=torch.int32,
                                       device=self._dev)
        self._halt = torch.zeros(self._B, dtype=torch.bool,
                                 device=self._dev)

    def _mask(self, when) -> torch.Tensor:
        return _lanes(when, self._B, torch.bool, self._dev)

    def _i32(self, x) -> torch.Tensor:
        return _lanes(x, self._B, torch.int32, self._dev)

    # -- randomness (draws are replay-stable per event) --------------------
    def rand_key(self) -> torch.Tensor:
        memo = ("split", id(self._key))
        hit = self._draws.get(memo)
        if hit is None:
            ks = prng.split(self._key)
            # the source key rides along so its id stays unique while cached
            hit = self._draws[memo] = (self._key, ks[:, 0], ks[:, 1])
        _, self._key, k = hit
        return k

    def randint(self, lo, hi) -> torch.Tensor:
        """Uniform int32 in [lo, hi] inclusive, per lane."""
        k = self.rand_key()
        if not (isinstance(lo, int) and isinstance(hi, int)):
            return prng.randint(k, lo, hi)
        memo = ("randint", id(k), lo, hi)
        hit = self._draws.get(memo)
        if hit is None:
            hit = self._draws[memo] = (k, prng.randint(k, lo, hi))
        return hit[1]

    def uniform(self) -> torch.Tensor:
        return prng.uniform(self.rand_key())

    def bernoulli(self, p) -> torch.Tensor:
        return prng.bernoulli(self.rand_key(), p)

    # -- per-node deterministic hash streams -------------------------------
    def hash_key(self, stream=0) -> torch.Tensor:
        """This node's hash-seed key for `stream`: a pure function of
        (lane seed, node, stream); consumes nothing."""
        if self._hash_base is None:
            raise ValueError(
                "hash_key() needs the runtime's seed-derived hash base — "
                "this Ctx was built without one; pass "
                "hash_base=SimState.hash_base")
        return prng.node_hash_key(self._hash_base, self.node, stream)

    def hash_randint(self, lo, hi, stream=0) -> torch.Tensor:
        return prng.randint(self.hash_key(stream), lo, hi)

    # -- effects -----------------------------------------------------------
    def send(self, dst, tag, payload=None, *, when=True) -> None:
        """Queue a message: delivered at now + a latency draw, subject to
        loss and the clog matrix."""
        if _statically_false(when):
            return
        self._sends.append(dict(
            m=self._mask(when), dst=self._i32(dst), tag=self._i32(tag),
            payload=as_payload(payload, self.cfg.payload_words, self._B,
                               self._dev)))

    def set_timer(self, delay, tag, payload=None, *, when=True) -> None:
        """Schedule on_timer(tag, payload) at now + delay ticks."""
        if _statically_false(when):
            return
        self._timers.append(dict(
            m=self._mask(when),
            delay=torch.clamp(self._i32(delay), min=0),
            tag=self._i32(tag),
            payload=as_payload(payload, self.cfg.payload_words, self._B,
                               self._dev)))

    def cancel_timer(self, tag, *, when=True) -> None:
        """Drop all of this node's pending timers carrying `tag`; applied
        before any of the same invocation's set_timer emissions."""
        if _statically_false(when):
            return
        self._cancels.append(dict(m=self._mask(when), tag=self._i32(tag)))

    def defer(self, tag, payload=None, *, when=True) -> None:
        """A zero-delay timer: the continuation lands at the current
        deadline and races other same-time events through the tie-break."""
        self.set_timer(0, tag, payload, when=when)

    def crash_if(self, cond, code: int) -> None:
        """Assert: where `cond` holds, the lane crashes with user code > 0."""
        cond = self._mask(cond)
        first = cond & ~self._crash
        self._crash_code = torch.where(first, int(code), self._crash_code)
        self._crash = self._crash | cond

    def halt_if(self, cond=True) -> None:
        """Request the normal end of simulation where `cond` holds."""
        self._halt = self._halt | self._mask(cond)


class Program:
    """A node program: an explicit state machine. Subclass and override;
    every method operates on whole [B] batches of lanes with torch ops,
    no data-dependent Python control flow."""

    def init(self, ctx: Ctx) -> None:
        """Node boot / restart: set initial state, arm initial timers."""

    def on_message(self, ctx: Ctx, src, tag, payload) -> None:
        """A message addressed to this node arrived."""

    def on_timer(self, ctx: Ctx, tag, payload) -> None:
        """A timer armed with set_timer fired."""
