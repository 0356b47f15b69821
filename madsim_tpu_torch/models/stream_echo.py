"""Streaming-RPC echo workload — the tonic-example streaming suite analog
(the counterpart of `madsim_tpu.models.stream_echo`, written for batched
[B, ...] node state).

Three method shapes over the framed-stream fabric (net/streaming.py):

  mode="bidi"      client pushes n items, server echoes each (paced through
                   a backpressure ring), both END
  mode="sum"       client-streaming: n items up, one aggregate K_REPLY down
  mode="download"  server-streaming: one request up, n items + END down

Clients verify payloads in-model (ctx.crash_if: 201 / 202 / 203), detect
stalls (lost END, peer restart) and recover by resetting the peer stream
and re-issuing the whole call with a fresh call id.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.api import Ctx, Program
from ..core.types import ms
from ..net import conn, streaming
from ..net.service import Service, rpc_stream
from ..ops.select import put_at, put_row, row_at

T_TICK = 1

CRASH_BAD_ECHO = 201
CRASH_BAD_SUM = 202
CRASH_BAD_DOWNLOAD = 203

SERVER = 0          # node 0 serves; nodes 1.. are clients
ECHO_RING = 8       # server-side backpressure buffer per client

_I32 = torch.int32


def echo_state_spec(n_nodes: int, window: int = 4):
    z = torch.tensor(0, dtype=_I32)
    N = n_nodes

    def vec(*shape):
        return torch.zeros(shape, dtype=_I32)

    return dict(
        **conn.conn_state(N),
        **streaming.streaming_state(N, window=window, body_words=1),
        # server: echo backpressure ring + END bookkeeping (bidi)
        eb_val=vec(N, ECHO_RING), eb_w=vec(N), eb_r=vec(N), eb_cid=vec(N),
        eb_end=vec(N),
        # server: client-streaming aggregation
        acc=vec(N),
        # server: server-streaming download pacing
        dl_rem=vec(N), dl_next=vec(N), dl_cid=vec(N), dl_end=vec(N),
        # client
        c_phase=z,              # 0 open, 1 push, 2 awaiting, 3 done
        c_cid=z.clone(),
        c_sent=z.clone(),
        c_fin=z.clone(),        # our END went out
        c_got=z.clone(),        # items received back
        c_done=z.clone(),
        c_prog=z.clone(),       # virtual time of last forward progress
    )


class StreamEchoServer(Service):
    """All three streaming shapes behind @rpc_stream methods."""

    def __init__(self, n_nodes: int, tick=ms(10)):
        self.n = n_nodes
        self.tick = tick

    # ---- bidi echo: buffer delivered items, push them back paced --------
    @rpc_stream
    def echo(self, ctx: Ctx, st, src, kind, cid, body, when):
        fresh = when & (kind == streaming.K_CALL)
        # a new call resets the ring (a retried call replaces the old one)
        for k in ("eb_w", "eb_r", "eb_end"):
            st[k] = put_at(st[k], src, 0, fresh)
        st["eb_cid"] = put_at(st["eb_cid"], src, cid, fresh)
        item = (when & (kind == streaming.K_ITEM)
                & (cid == row_at(st["eb_cid"], src)))
        w = row_at(st["eb_w"], src)
        wslot = torch.remainder(w, ECHO_RING)
        ring = row_at(st["eb_val"], src)
        st["eb_val"] = put_at(st["eb_val"], src,
                              put_row(ring, wslot, body[:, 0], item))
        st["eb_w"] = put_at(st["eb_w"], src, w + item.to(_I32))
        end = (when & (kind == streaming.K_END)
               & (cid == row_at(st["eb_cid"], src)))
        st["eb_end"] = put_at(st["eb_end"], src,
                              row_at(st["eb_end"], src) | end.to(_I32))

    # ---- client-streaming sum: aggregate, reply on END ------------------
    @rpc_stream
    def sum(self, ctx: Ctx, st, src, kind, cid, body, when):
        acc = row_at(st["acc"], src)
        st["acc"] = put_at(
            st["acc"], src,
            torch.where(when & (kind == streaming.K_CALL), 0,
                        acc + torch.where(when & (kind == streaming.K_ITEM),
                                          body[:, 0], 0)))
        streaming.reply(ctx, st, src, cid, [row_at(st["acc"], src)],
                        method=StreamEchoServer.sum.tag,
                        when=when & (kind == streaming.K_END))

    # ---- server-streaming download: K_CALL asks for n items -------------
    @rpc_stream
    def download(self, ctx: Ctx, st, src, kind, cid, body, when):
        fresh = when & (kind == streaming.K_CALL)
        st["dl_rem"] = put_at(st["dl_rem"], src, body[:, 0], fresh)
        st["dl_next"] = put_at(st["dl_next"], src, 0, fresh)
        st["dl_cid"] = put_at(st["dl_cid"], src, cid, fresh)
        st["dl_end"] = put_at(st["dl_end"], src, 0, fresh)

    def _drain(self, ctx: Ctx, st):
        """Paced response streaming: <= 1 echo item + <= 1 download item
        per client per call, window permitting (a full send window
        delays, never drops)."""
        for c in range(1, self.n):
            # bidi echo ring
            r = st["eb_r"][:, c]
            has = r < st["eb_w"][:, c]
            item = row_at(st["eb_val"][:, c], torch.remainder(r, ECHO_RING))
            ok = streaming.push(ctx, st, c, st["eb_cid"][:, c], [item],
                                method=StreamEchoServer.echo.tag, when=has)
            st["eb_r"] = put_at(st["eb_r"], c, r + ok.to(_I32))
            drained = ((st["eb_end"][:, c] == 1)
                       & (st["eb_r"][:, c] >= st["eb_w"][:, c]))
            fin = streaming.finish(ctx, st, c, st["eb_cid"][:, c],
                                   method=StreamEchoServer.echo.tag,
                                   when=drained)
            st["eb_end"] = put_at(st["eb_end"], c, 0, fin)
            # download stream
            dhas = st["dl_rem"][:, c] > 0
            dok = streaming.push(ctx, st, c, st["dl_cid"][:, c],
                                 [st["dl_next"][:, c]],
                                 method=StreamEchoServer.download.tag,
                                 when=dhas)
            st["dl_next"] = put_at(st["dl_next"], c,
                                   st["dl_next"][:, c] + dok.to(_I32))
            st["dl_rem"] = put_at(st["dl_rem"], c,
                                  st["dl_rem"][:, c] - dok.to(_I32))
            last = dok & (st["dl_rem"][:, c] == 0)
            st["dl_end"] = put_at(st["dl_end"], c,
                                  st["dl_end"][:, c] | last.to(_I32))
            dfin = streaming.finish(ctx, st, c, st["dl_cid"][:, c],
                                    method=StreamEchoServer.download.tag,
                                    when=st["dl_end"][:, c] == 1)
            st["dl_end"] = put_at(st["dl_end"], c, 0, dfin)

    def init(self, ctx: Ctx):
        st = dict(ctx.state)
        conn.listen(ctx, st)
        ctx.set_timer(self.tick, T_TICK, [0])
        ctx.state = st

    def on_timer(self, ctx: Ctx, tag, payload):
        st = dict(ctx.state)
        is_tick = tag == T_TICK
        self._drain(ctx, st)
        streaming.tick(ctx, st, range(1, self.n), when=is_tick)
        ctx.set_timer(self.tick, T_TICK, [0], when=is_tick)
        ctx.state = st

    def on_message(self, ctx: Ctx, src, tag, payload):
        # connection lifecycle first: a (re)connecting or resetting client
        # restarts the sequence space on both sides
        st = dict(ctx.state)
        accept, _, rst = conn.on_message(ctx, st, src, tag, payload)
        fresh = accept | rst
        # the conn layer already re-based the stream fabric; only the
        # app state resets here
        for k in ("eb_w", "eb_r", "eb_end", "acc", "dl_rem", "dl_end"):
            st[k] = put_at(st[k], src, 0, fresh)
        ctx.state = st
        super().on_message(ctx, src, tag, payload)
        # ACKs open send-window room: drain immediately, not a tick later
        st = dict(ctx.state)
        self._drain(ctx, st)
        ctx.state = st


class StreamEchoClient(Program):
    """Drives one call of the configured shape to completion, verifying
    every frame; stalls (kill mid-stream, lost END) trigger a full
    reconnect-and-retry with a fresh call id."""

    def __init__(self, mode: str, n_items: int = 6, tick=ms(10),
                 stall=ms(200)):
        assert mode in ("bidi", "sum", "download")
        self.mode = mode
        self.n = n_items
        self.tick = tick
        self.stall = stall
        self.method = dict(
            bidi=StreamEchoServer.echo.tag,
            sum=StreamEchoServer.sum.tag,
            download=StreamEchoServer.download.tag)[mode]

    def _value(self, ctx, i):
        return ctx.node * 1000 + i * 7

    def init(self, ctx: Ctx):
        st = dict(ctx.state)
        st["c_cid"] = ctx.randint(1, 2**30 - 1)
        st["c_prog"] = ctx.now
        ctx.set_timer(ctx.randint(0, self.tick), T_TICK, [0])
        ctx.state = st

    def on_timer(self, ctx: Ctx, tag, payload):
        st = dict(ctx.state)
        is_tick = tag == T_TICK
        done = st["c_done"] == 1

        # stall watchdog: tear the CONNECTION down (notifying a live
        # server so it resets its side too), then re-issue from scratch
        stalled = (is_tick & ~done
                   & (ctx.now - st["c_prog"] > self.stall))
        conn.reset(ctx, st, SERVER, when=stalled)
        streaming.reset_peer(st, SERVER, when=stalled)
        st["c_cid"] = torch.where(stalled, ctx.randint(1, 2**30 - 1),
                                  st["c_cid"])
        for k in ("c_sent", "c_fin", "c_got", "c_phase"):
            st[k] = torch.where(stalled, 0, st[k])
        st["c_prog"] = torch.where(stalled, ctx.now, st["c_prog"])

        # phase 0: connect, then open the call
        est = conn.is_established(st, SERVER)
        conn.connect(ctx, st, SERVER,
                     when=is_tick & ~done & (st["c_phase"] == 0) & ~est)
        opening = is_tick & ~done & (st["c_phase"] == 0) & est
        open_body = [self.n] if self.mode == "download" else [0]
        ok = streaming.open_call(ctx, st, SERVER, self.method, st["c_cid"],
                                 open_body, when=opening)
        st["c_phase"] = torch.where(
            ok, 2 if self.mode == "download" else 1, st["c_phase"])
        st["c_prog"] = torch.where(ok, ctx.now, st["c_prog"])

        # phase 1: push request items, then our END
        if self.mode in ("bidi", "sum"):
            pushing = (is_tick & ~done & (st["c_phase"] == 1)
                       & (st["c_sent"] < self.n))
            pok = streaming.push(ctx, st, SERVER, st["c_cid"],
                                 [self._value(ctx, st["c_sent"])],
                                 method=self.method, when=pushing)
            st["c_sent"] = st["c_sent"] + pok.to(_I32)
            fin_w = (is_tick & ~done & (st["c_phase"] == 1)
                     & (st["c_sent"] >= self.n) & (st["c_fin"] == 0))
            fok = streaming.finish(ctx, st, SERVER, st["c_cid"],
                                   method=self.method, when=fin_w)
            st["c_fin"] = st["c_fin"] + fok.to(_I32)
            st["c_phase"] = torch.where(fok, 2, st["c_phase"])
            st["c_prog"] = torch.where(pok | fok, ctx.now, st["c_prog"])

        streaming.tick(ctx, st, [SERVER], when=is_tick)
        ctx.set_timer(self.tick, T_TICK, [0], when=is_tick)
        ctx.state = st

    def on_message(self, ctx: Ctx, src, tag, payload):
        from ..net.stream import delivered_slots
        st = dict(ctx.state)
        _, _, rst = conn.on_message(ctx, st, src, tag, payload)
        # the server reset our connection: start over (fresh call id next
        # tick; the conn layer already tore the stream fabric)
        for k in ("c_sent", "c_fin", "c_got", "c_phase"):
            st[k] = torch.where(rst, 0, st[k])
        kinds, methods, cids, bodies, mask = streaming.on_stream(
            ctx, st, src, tag, payload)
        for i in delivered_slots(mask):
            mine = (mask[:, i] & (src == SERVER)
                    & (cids[:, i] == st["c_cid"]) & (st["c_done"] == 0))
            item = mine & (kinds[:, i] == streaming.K_ITEM)
            end = mine & (kinds[:, i] == streaming.K_END)
            repl = mine & (kinds[:, i] == streaming.K_REPLY)
            body = bodies[:, i, 0]
            if self.mode == "bidi":
                # echoed values come back exactly once, in order
                ctx.crash_if(item & (body != self._value(ctx, st["c_got"])),
                             CRASH_BAD_ECHO)
                st["c_got"] = st["c_got"] + item.to(_I32)
                got_all = end & (st["c_got"] >= self.n)
                ctx.crash_if(end & (st["c_got"] < self.n), CRASH_BAD_ECHO)
                st["c_done"] = torch.where(got_all, 1, st["c_done"])
            elif self.mode == "sum":
                expect = sum(ctx.node * 1000 + j * 7 for j in range(self.n))
                ctx.crash_if(repl & (body != expect), CRASH_BAD_SUM)
                st["c_done"] = torch.where(repl, 1, st["c_done"])
            else:  # download
                ctx.crash_if(item & (body != st["c_got"]),
                             CRASH_BAD_DOWNLOAD)
                st["c_got"] = st["c_got"] + item.to(_I32)
                ctx.crash_if(end & (st["c_got"] < self.n),
                             CRASH_BAD_DOWNLOAD)
                st["c_done"] = torch.where(end & (st["c_got"] >= self.n),
                                           1, st["c_done"])
            st["c_prog"] = torch.where(mine, ctx.now, st["c_prog"])
        ctx.state = st


def clients_done(n_nodes: int):
    def check(state):
        return (state.node_state["c_done"][:, 1:n_nodes] == 1).all(-1)
    return check


def make_stream_echo_runtime(mode: str, n_clients: int = 2, n_items: int = 6,
                             scenario=None, cfg=None, device=None):
    from ..core.types import NetConfig, SimConfig, sec
    from ..runtime.runtime import Runtime
    n = 1 + n_clients
    if cfg is None:
        cfg = SimConfig(n_nodes=n, event_capacity=64, payload_words=8,
                        time_limit=sec(10),
                        net=NetConfig(send_latency_min=ms(1),
                                      send_latency_max=ms(8)))
    assert cfg.payload_words >= 2 + streaming.HEADER_WORDS + 1
    server = StreamEchoServer(n)
    client = StreamEchoClient(mode, n_items)
    node_prog = np.asarray([0] + [1] * n_clients, np.int32)
    return Runtime(cfg, [server, client], echo_state_spec(n),
                   node_prog=node_prog, scenario=scenario,
                   halt_when=clients_done(n), device=device)
