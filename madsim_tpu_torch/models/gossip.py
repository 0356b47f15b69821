"""Epidemic broadcast: push gossip with anti-entropy digests (the
counterpart of `madsim_tpu.models.gossip`).

Node 0 originates a set of rumors; every infected node pushes its rumor
digest to `fanout` random peers a tick, and a receiver holding rumors the
pusher lacks pushes its own digest back (anti-entropy in the reverse
direction). Full dissemination despite loss, partitions and churn is the
liveness property (`all_infected` halts the lane).
"""

from __future__ import annotations

import torch

from ..core.api import Ctx, Program
from ..core.types import ms

PUSH, PUSH_BACK = 1, 2
T_GOSSIP = 1

RUMOR_BITS = 30


def state_spec():
    i32 = torch.int32
    return dict(have=torch.tensor(0, dtype=i32),
                infected_at=torch.tensor(-1, dtype=i32),
                booted=torch.tensor(0, dtype=i32))


class Gossip(Program):
    def __init__(self, n_nodes: int, n_rumors: int = 4, fanout: int = 2,
                 tick=ms(20)):
        assert n_rumors <= RUMOR_BITS
        self.n = n_nodes
        self.rumors = n_rumors
        self.fanout = fanout
        self.tick = tick
        self.full = (1 << n_rumors) - 1

    def init(self, ctx: Ctx):
        st = dict(ctx.state)
        seeded = ctx.node == 0
        zero = torch.zeros_like(st["have"])
        st["have"] = torch.where(seeded, zero + self.full, zero)
        st["infected_at"] = torch.where(seeded, ctx.now, zero - 1)
        st["booted"] = torch.ones_like(st["booted"])
        ctx.set_timer(ctx.randint(0, self.tick), T_GOSSIP, [0])
        ctx.state = st

    def on_timer(self, ctx: Ctx, tag, payload):
        st = ctx.state
        is_tick = tag == T_GOSSIP
        infected = st["have"] != 0
        for _ in range(self.fanout):
            peer = ctx.randint(0, self.n - 1)
            # push our digest + bits; peers pull what they miss
            ctx.send(peer, PUSH, [st["have"]],
                     when=is_tick & infected & (peer != ctx.node))
        ctx.set_timer(self.tick, T_GOSSIP, [0], when=is_tick)

    def on_message(self, ctx: Ctx, src, tag, payload):
        st = dict(ctx.state)
        theirs = payload[:, 0]
        newly = (tag == PUSH) | (tag == PUSH_BACK)
        gained = newly & ((theirs & ~st["have"]) != 0)
        st["infected_at"] = torch.where(gained & (st["infected_at"] < 0),
                                        ctx.now, st["infected_at"])
        st["have"] = torch.where(newly, st["have"] | theirs, st["have"])
        # anti-entropy: if the pusher lacks rumors we hold, push back
        ctx.send(src, PUSH_BACK, [st["have"]],
                 when=(tag == PUSH) & ((st["have"] & ~theirs) != 0))
        ctx.state = st


def all_infected(n_rumors: int, require_all_alive: bool = False):
    """Completion predicate. By default dead nodes are excused (a
    permanently killed node must not block the run); recovery scenarios
    set require_all_alive=True so the run only completes once every
    victim has restarted and been re-infected."""
    full = (1 << n_rumors) - 1

    def check(state):
        ns = state.node_state
        # booted gate: until every node's t=0 INIT has fired, un-booted
        # nodes must not be mistaken for dead ones
        started = (ns["booted"] == 1).all(-1)
        done = ns["have"] == full
        if not require_all_alive:
            done = done | ~state.alive
        else:
            done = done & state.alive
        return started & done.all(-1)
    return check


def make_gossip_runtime(n_nodes=8, n_rumors=4, fanout=2, scenario=None,
                        cfg=None, require_all_alive=False, device=None,
                        **kw):
    from ..core.types import SimConfig, sec
    from ..runtime.runtime import Runtime
    if cfg is None:
        cfg = SimConfig(n_nodes=n_nodes, event_capacity=192,
                        time_limit=sec(20))
    prog = Gossip(n_nodes, n_rumors, fanout, **kw)
    return Runtime(cfg, [prog], state_spec(), scenario=scenario,
                   halt_when=all_infected(n_rumors, require_all_alive),
                   device=device)
