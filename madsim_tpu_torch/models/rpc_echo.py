"""RPC echo service under faults — BASELINE.md config 3 (the counterpart of
`madsim_tpu.models.rpc_echo`).

The tonic-example analog (tonic-example/src/server.rs:126-253: one
server, clients, typed calls under the simulator): a server program plus
client programs issuing calls with retry-on-timeout through the net.rpc
conventions, under packet loss and server kill/restart.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.api import Ctx, Program
from ..core.types import ms
from ..net import rpc

TAG_ECHO = 1          # request tag (Request::ID analog)
T_RETRY = 1           # client retry/timeout timer

SERVER = 0            # node 0 is the server; 1..N-1 are clients


def server_state_spec():
    z = torch.tensor(0, dtype=torch.int32)
    return dict(served=z, call_id=z, seq=z, acked=z)


client_state_spec = server_state_spec  # one shared schema (union of fields)


class EchoServer(Program):
    def on_message(self, ctx: Ctx, src, tag, payload):
        st = dict(ctx.state)
        is_req = tag == TAG_ECHO
        st["served"] = st["served"] + is_req
        # echo the body back, tagged with the caller's call id
        rpc.reply(ctx, src, TAG_ECHO, payload, [payload[:, 1]], when=is_req)
        ctx.state = st


class EchoClient(Program):
    """Issues `target` sequential echo calls; retries until each is acked
    (call_timeout + retry, the loop a madsim test writes by hand around
    Endpoint::call, net/rpc.rs:107-130)."""

    def __init__(self, target: int = 10, timeout=ms(40)):
        self.target = target
        self.timeout = timeout

    def init(self, ctx: Ctx):
        st = dict(ctx.state)
        st["call_id"] = rpc.new_call_id(ctx)
        rpc.call(ctx, SERVER, TAG_ECHO, [st["seq"]], st["call_id"],
                 retry_timer_tag=T_RETRY, timeout=ctx.randint(0, self.timeout))
        ctx.state = st

    def on_timer(self, ctx: Ctx, tag, payload):
        st = ctx.state
        # retry only if this timeout belongs to the still-outstanding call
        stale = payload[:, 0] != st["call_id"]
        done = st["acked"] >= self.target
        rpc.call(ctx, SERVER, TAG_ECHO, [st["seq"]], st["call_id"],
                 retry_timer_tag=T_RETRY, timeout=self.timeout,
                 when=(tag == T_RETRY) & ~stale & ~done)

    def on_message(self, ctx: Ctx, src, tag, payload):
        st = dict(ctx.state)
        hit = (tag == rpc.reply_tag(TAG_ECHO)) & rpc.matches(
            payload, st["call_id"])
        # the echoed body must match what we asked for
        ctx.crash_if(hit & (payload[:, 1] != st["seq"]), 201)
        st["acked"] = st["acked"] + hit
        st["seq"] = st["seq"] + hit
        new_id = rpc.new_call_id(ctx)
        more = hit & (st["acked"] < self.target)
        st["call_id"] = torch.where(hit, torch.where(more, new_id, 0),
                                    st["call_id"])
        rpc.call(ctx, SERVER, TAG_ECHO, [st["seq"]], new_id,
                 retry_timer_tag=T_RETRY, timeout=self.timeout, when=more)
        ctx.state = st


def all_clients_done(target: int):
    """halt_when: every client acked `target` echoes."""
    def check(state):
        return (state.node_state["acked"][:, 1:] >= target).all(-1)
    return check


def make_echo_runtime(n_nodes=6, target=10, scenario=None, cfg=None,
                      timeout=ms(40), device=None):
    from ..core.types import SimConfig, sec
    from ..runtime.runtime import Runtime
    if cfg is None:
        cfg = SimConfig(n_nodes=n_nodes, event_capacity=256,
                        time_limit=sec(20))
    node_prog = np.asarray([0] + [1] * (n_nodes - 1), np.int32)
    return Runtime(cfg, [EchoServer(), EchoClient(target, timeout)],
                   server_state_spec(), node_prog=node_prog,
                   scenario=scenario, halt_when=all_clients_done(target),
                   device=device)
