"""Two-phase commit (the counterpart of `madsim_tpu.models.
two_phase_commit`).

Coordinator (node 0) drives a sequence of transactions over participants
1..N-1: PREPARE -> votes -> COMMIT iff every vote is yes, else ABORT ->
acks. Votes and decisions are write-ahead state (the engine's persist
mask), so a crashed coordinator re-drives its persisted decision after
restart.

The global invariant is atomicity: no transaction may be COMMITted on
one node and ABORTed on another, and a participant that voted NO must
never see COMMIT. `early_decide_quorum` re-introduces the classic bug
(deciding before every vote arrived) so a sweep can find it.
"""

from __future__ import annotations

import torch

from ..core.api import Ctx, Program
from ..core.types import ms
from ..ops.select import put_row, take1

# message tags
PREPARE, VOTE, DECIDE, ACK = 1, 2, 3, 4
# timer tags
T_TICK = 1
# decision encoding
NONE, COMMIT, ABORT = 0, 1, 2

CRASH_DIVERGED = 401        # same tx committed here, aborted there
CRASH_NO_VOTE_COMMIT = 402  # committed against a NO vote

_I32 = torch.int32


def state_spec(n_nodes: int, n_tx: int):
    z = torch.tensor(0, dtype=_I32)
    return dict(
        # persisted write-ahead state
        voted=torch.zeros((n_tx,), dtype=_I32),    # NONE/COMMIT/ABORT
        decided=torch.zeros((n_tx,), dtype=_I32),  # NONE/COMMIT/ABORT
        # coordinator volatile driving state
        tx=z, phase=z,                             # 0 idle, 1 vote, 2 decide
        votes_mask=z, no_seen=z, acks_mask=z,      # participant bitmasks
    )


def persist_spec():
    return dict(voted=True, decided=True, tx=False, phase=False,
                votes_mask=False, no_seen=False, acks_mask=False)


def _const(value, like):
    return torch.full_like(like, value)


class TwoPhaseCommit(Program):
    def __init__(self, n_nodes: int, n_tx: int = 6, p_yes: float = 0.85,
                 tick=ms(30), early_decide_quorum: int | None = None):
        assert n_nodes <= 31
        self.n = n_nodes
        self.tx_count = n_tx
        self.p_yes = p_yes
        self.tick = tick
        # BUG KNOB: decide once this many votes arrived (None = all)
        self.early_quorum = early_decide_quorum
        self.all_mask = 0
        for p in range(1, n_nodes):
            self.all_mask |= 1 << p

    # -- coordinator ------------------------------------------------------
    def init(self, ctx: Ctx):
        ctx.set_timer(ctx.randint(0, self.tick), T_TICK,
                      when=ctx.node == 0)

    def on_timer(self, ctx: Ctx, tag, payload):
        st = dict(ctx.state)
        is_tick = (tag == T_TICK) & (ctx.node == 0)
        running = st["tx"] < self.tx_count
        t = torch.clamp(st["tx"], 0, self.tx_count - 1)

        # idle -> start the next transaction
        start = is_tick & running & (st["phase"] == 0)
        st["phase"] = torch.where(start, 1, st["phase"])
        st["votes_mask"] = torch.where(start, 0, st["votes_mask"])
        st["no_seen"] = torch.where(start, 0, st["no_seen"])
        st["acks_mask"] = torch.where(start, 0, st["acks_mask"])

        # voting phase: (re)send PREPARE to participants lacking a vote
        voting = is_tick & running & ((st["phase"] == 1) | start)
        n_votes = _popcount(st["votes_mask"], self.n)
        need = (self.n - 1 if self.early_quorum is None
                else self.early_quorum)
        complete = voting & (n_votes >= need)
        # recovery rule: a persisted decision is final — a restarted
        # coordinator re-drives it rather than re-deciding
        dec_t = take1(st["decided"], t)
        decision = torch.where(
            dec_t != NONE, dec_t,
            torch.where(st["no_seen"] != 0, _const(ABORT, dec_t),
                        _const(COMMIT, dec_t)))
        st["decided"] = put_row(st["decided"], t,
                                torch.where(complete, decision, dec_t))
        st["phase"] = torch.where(complete, 2, st["phase"])

        # decide phase: (re)send DECIDE to un-acked participants
        deciding = is_tick & running & (st["phase"] == 2)
        dec_t = take1(st["decided"], t)
        tag_out = torch.where(deciding, _const(DECIDE, t),
                              _const(PREPARE, t))
        for p in range(1, self.n):
            bit = 1 << p
            ctx.send(p, tag_out, [t, dec_t],
                     when=(voting & ~complete
                           & ((st["votes_mask"] & bit) == 0))
                     | (deciding & ((st["acks_mask"] & bit) == 0)))

        # all acked -> next transaction
        done = deciding & ((st["acks_mask"] & self.all_mask)
                           == self.all_mask)
        st["tx"] = st["tx"] + done
        st["phase"] = torch.where(done, 0, st["phase"])

        ctx.set_timer(self.tick, T_TICK, when=is_tick & running)
        ctx.halt_if((ctx.node == 0) & (st["tx"] >= self.tx_count))
        ctx.state = st

    # -- both roles -------------------------------------------------------
    def on_message(self, ctx: Ctx, src, tag, payload):
        st = dict(ctx.state)
        t = torch.clamp(payload[:, 0], 0, self.tx_count - 1)

        # participant: PREPARE -> vote once (persisted), resend same vote
        is_prep = (tag == PREPARE) & (ctx.node != 0)
        voted_t = take1(st["voted"], t)
        fresh = is_prep & (voted_t == NONE)
        vote = torch.where(ctx.bernoulli(self.p_yes), _const(COMMIT, t),
                           _const(ABORT, t))
        st["voted"] = put_row(st["voted"], t,
                              torch.where(fresh, vote, voted_t))
        voted_t = take1(st["voted"], t)
        ctx.send(src, VOTE, [t, voted_t, ctx.node], when=is_prep)

        # participant: DECIDE -> record + ack; atomicity asserts
        is_dec = (tag == DECIDE) & (ctx.node != 0)
        d = payload[:, 1]
        ctx.crash_if(is_dec & (voted_t == ABORT) & (d == COMMIT),
                     CRASH_NO_VOTE_COMMIT)
        dec_t = take1(st["decided"], t)
        st["decided"] = put_row(
            st["decided"], t,
            torch.where(is_dec & (dec_t == NONE), d, dec_t))
        ctx.send(src, ACK, [t, ctx.node], when=is_dec)

        # coordinator: collect votes / acks
        cur = torch.clamp(st["tx"], 0, self.tx_count - 1)
        is_vote = (tag == VOTE) & (ctx.node == 0) & (t == cur)
        voter_bit = 1 << torch.clamp(payload[:, 2], 0, 30)
        st["votes_mask"] = torch.where(is_vote,
                                       st["votes_mask"] | voter_bit,
                                       st["votes_mask"])
        st["no_seen"] = torch.where(is_vote & (payload[:, 1] == ABORT),
                                    st["no_seen"] | voter_bit,
                                    st["no_seen"])
        # ACKs are tx-guarded like votes: a stale duplicate ACK from the
        # previous transaction must not pre-mark a participant as acked
        is_ack = (tag == ACK) & (ctx.node == 0) & (t == cur)
        ack_bit = 1 << torch.clamp(payload[:, 1], 0, 30)
        st["acks_mask"] = torch.where(is_ack, st["acks_mask"] | ack_bit,
                                      st["acks_mask"])
        ctx.state = st


def _popcount(x, n_bits):
    """Set bits among the low `n_bits` of int32 `x` [B], in int32 (the
    shifts and the sum stay 32-bit: ROADMAP F2)."""
    sh = torch.arange(n_bits, dtype=_I32, device=x.device)
    bits = (x.unsqueeze(-1) >> sh) & 1
    return bits.sum(-1, dtype=_I32)


def tpc_invariant(n_nodes: int, n_tx: int):
    """Atomicity: a transaction never COMMITs on one node and ABORTs on
    another (checked across all nodes after every event)."""
    def invariant(state):
        dec = state.node_state["decided"]            # [B, N, TX]
        committed = (dec == COMMIT).any(1)
        aborted = (dec == ABORT).any(1)
        bad = (committed & aborted).any(-1)
        return bad, torch.full(bad.shape, CRASH_DIVERGED, dtype=_I32,
                               device=bad.device)
    return invariant


def make_tpc_runtime(n_nodes=5, n_tx=6, scenario=None, cfg=None,
                     device=None, **kw):
    from ..core.types import SimConfig, sec
    from ..runtime.runtime import Runtime
    if cfg is None:
        cfg = SimConfig(n_nodes=n_nodes, event_capacity=128,
                        time_limit=sec(20))
    prog = TwoPhaseCommit(n_nodes, n_tx, **kw)
    return Runtime(cfg, [prog], state_spec(n_nodes, n_tx),
                   scenario=scenario, invariant=tpc_invariant(n_nodes, n_tx),
                   persist=persist_spec(), device=device)
