"""Ping-pong workload (the counterpart of `madsim_tpu.models.pingpong`).

Node 0 pings peers round-robin with a retry timer (so packet loss and
partitions cannot deadlock it), peers pong back, and the lane halts once
`target` pongs have been acknowledged.
"""

from __future__ import annotations

import torch

from ..core.api import Ctx, Program
from ..core.types import ms

TAG_PING = 1
TAG_PONG = 2
TIMER_RETRY = 1


def state_spec():
    z = torch.tensor(0, dtype=torch.int32)
    return dict(seq=z, acked=z, pings_got=z, pongs_sent=z)


class PingPong(Program):
    def __init__(self, n_nodes: int, target: int = 10, retry=ms(20)):
        self.n = n_nodes
        self.target = target
        self.retry = retry

    def _dst(self, seq):
        # round-robin over peers 1..N-1 (single-node: self-ping)
        if self.n == 1:
            return torch.zeros_like(seq)
        return 1 + seq % (self.n - 1)

    def init(self, ctx: Ctx):
        # only node 0 drives; jittered kick-off for schedule diversity
        ctx.set_timer(ctx.randint(0, ms(1)), TIMER_RETRY,
                      when=ctx.node == 0)

    def on_timer(self, ctx: Ctx, tag, payload):
        st = ctx.state
        done = st["acked"] >= self.target
        ctx.send(self._dst(st["seq"]), TAG_PING, [st["seq"]], when=~done)
        ctx.set_timer(self.retry, TIMER_RETRY, when=~done)

    def on_message(self, ctx: Ctx, src, tag, payload):
        st = dict(ctx.state)
        is_ping = tag == TAG_PING
        ctx.send(src, TAG_PONG, [payload[:, 0]], when=is_ping)
        st["pings_got"] = st["pings_got"] + is_ping
        st["pongs_sent"] = st["pongs_sent"] + is_ping

        is_pong = (tag == TAG_PONG) & (payload[:, 0] == st["seq"])
        st["seq"] = st["seq"] + is_pong
        st["acked"] = st["acked"] + is_pong
        done = st["acked"] >= self.target
        # fire the next ping immediately on ack (retry timer is the backstop)
        ctx.send(self._dst(st["seq"]), TAG_PING, [st["seq"]],
                 when=is_pong & ~done)
        ctx.state = st
        ctx.halt_if((ctx.node == 0) & done)
