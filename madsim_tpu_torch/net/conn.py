"""Connection management over the stream fabric — the TcpListener /
TcpStream surface (the counterpart of `madsim_tpu.net.conn`).

net/stream.py supplies the byte-pipe semantics (ordered, reliable,
windowed); this layer adds the connection lifecycle: a handshake before
data flows, connection state per peer, refusal when nobody listens, and
reset. State machine per (node, peer): CLOSED -> SYN_SENT -> ESTABLISHED
on the initiator; CLOSED -> ESTABLISHED on the listener when a SYN
arrives while listening. A SYN to a non-listening node draws RST.

Peer incarnations: every peering carries an epoch counter
(`cn_epoch[peer]`) that strictly increases across connection
generations. A SYN proposes the initiator's epoch, the listener accepts
at max(proposal, own) and echoes it in the SYN-ACK, so both endpoints
land on the same value — and a stream fabric in the same state dict is
re-based onto it (`stream.reset_peer(epoch=)`). Every RST names the
generation it tears, so a delayed RST of an older incarnation is
ignored; every teardown bumps the counter. `OP_RESET_PEER` applies the
same teardown and bump to both endpoints at once (ops/apply_super.py).

Leaves carry the lane axis inside a handler (`cn_state` [B, N],
`cn_listen` [B]); every helper is masked.
"""

from __future__ import annotations

import torch

from ..core.api import Ctx
from ..ops.select import put_at, row_at
from ..utils.maskutil import statically_false
from . import stream

TAG_SYN = (1 << 21)
TAG_SYN_ACK = (1 << 21) + 1
TAG_RST = (1 << 21) + 2

CLOSED, SYN_SENT, ESTABLISHED = 0, 1, 2

# the stream-fabric leaves conn re-bases on handshake and teardown when a
# model composes both layers in one state dict (minipg, stream_echo)
_STREAM_KEYS = frozenset(
    ("sx_seq", "sx_base", "sx_val", "sr_next", "sr_val", "sr_have",
     "st_epoch"))

_I32 = torch.int32


def conn_state(n_nodes: int):
    return dict(
        cn_state=torch.zeros((n_nodes,), dtype=_I32),  # per-peer state
        cn_listen=torch.tensor(0, dtype=_I32),         # listening flag
        # per-peer incarnation counter: the generation this node will
        # propose or accept next
        cn_epoch=torch.zeros((n_nodes,), dtype=_I32),
    )


def _has_stream(st) -> bool:
    return _STREAM_KEYS <= set(st.keys())


def listen(ctx: Ctx, st, *, when=True):
    """Start accepting connections (TcpListener::bind)."""
    st["cn_listen"] = torch.where(ctx._mask(when), 1, st["cn_listen"])


def connect(ctx: Ctx, st, dst, *, when=True):
    """Initiate a handshake (TcpStream::connect); idempotent from
    SYN_SENT, so a retry timer can re-send a lost SYN. The SYN proposes
    this node's epoch for the new generation."""
    if statically_false(when):
        return ctx._mask(False)
    cur = row_at(st["cn_state"], dst)
    ok = ctx._mask(when) & ((cur == CLOSED) | (cur == SYN_SENT))
    st["cn_state"] = put_at(st["cn_state"], dst,
                            torch.where(ok, SYN_SENT, cur))
    ctx.send(dst, TAG_SYN, [row_at(st["cn_epoch"], dst)], when=ok)
    return ok


def is_established(st, peer):
    return row_at(st["cn_state"], peer) == ESTABLISHED


def on_message(ctx: Ctx, st, src, tag, payload=None, *, epoch_guard=True):
    """Feed connection-control messages through the state machine.
    Returns the (accepted, established, reset) masks of this event. Call
    before stream.on_message.

    `payload` carries the epoch word of the handshake frames; None reads
    epoch 0 everywhere. `epoch_guard=False` lets ANY RST close an
    ESTABLISHED connection whatever its incarnation (the red control)."""
    if statically_false((tag == TAG_SYN) | (tag == TAG_SYN_ACK)
                        | (tag == TAG_RST)):
        f = ctx._mask(False)
        return f, f, f
    tag = ctx._i32(tag)
    carried = (payload[:, 0] if payload is not None
               else ctx._i32(0))

    # listener side: SYN while listening -> ESTABLISHED + SYN-ACK at
    # max(proposal, own counter); SYN while not listening -> RST
    is_syn = tag == TAG_SYN
    accept = is_syn & (st["cn_listen"] == 1)
    refuse = is_syn & (st["cn_listen"] != 1)
    ep_src = row_at(st["cn_epoch"], src)
    e_acc = torch.maximum(carried, ep_src)
    st["cn_epoch"] = put_at(st["cn_epoch"], src,
                            torch.where(accept, e_acc, ep_src))
    st["cn_state"] = put_at(st["cn_state"], src, ESTABLISHED, accept)
    ctx.send(src, TAG_SYN_ACK, [e_acc], when=accept)
    # a refusal RST names the generation the SYN proposed
    ctx.send(src, TAG_RST, [carried], when=refuse)
    if _has_stream(st):
        # fresh connection, fresh stream fabric on the negotiated
        # generation — only where the generation advances: a duplicated
        # SYN of the current one must not reopen the receive window
        stream.reset_peer(
            st, src, when=accept & (e_acc > row_at(st["st_epoch"], src)),
            epoch=e_acc)

    # initiator side: SYN-ACK completes the handshake and installs the
    # negotiated generation
    is_sa = (tag == TAG_SYN_ACK) & (row_at(st["cn_state"], src) == SYN_SENT)
    ep_src = row_at(st["cn_epoch"], src)
    st["cn_epoch"] = put_at(st["cn_epoch"], src,
                            torch.where(is_sa, torch.maximum(carried, ep_src),
                                        ep_src))
    st["cn_state"] = put_at(st["cn_state"], src, ESTABLISHED, is_sa)
    if _has_stream(st):
        e_sa = torch.maximum(carried, row_at(st["cn_epoch"], src))
        stream.reset_peer(
            st, src, when=is_sa & (e_sa > row_at(st["st_epoch"], src)),
            epoch=e_sa)

    # RST tears the connection down — with the guard, only an RST aimed
    # at THIS incarnation; a valid RST bumps the counter
    is_rst = tag == TAG_RST
    if epoch_guard:
        is_rst = is_rst & (carried == row_at(st["cn_epoch"], src))
    st["cn_state"] = put_at(st["cn_state"], src, CLOSED, is_rst)
    st["cn_epoch"] = put_at(st["cn_epoch"], src,
                            row_at(st["cn_epoch"], src) + is_rst.to(_I32))
    if _has_stream(st):
        # the torn generation's in-flight segments are stale to whatever
        # connection comes next
        stream.reset_peer(st, src, when=is_rst)
    return accept, is_sa, is_rst


def reset(ctx: Ctx, st, peer, *, when=True):
    """Abort a connection and notify the peer: the RST names the torn
    generation, and the local counter bumps past it."""
    if statically_false(when):
        return
    w = ctx._mask(when) & (row_at(st["cn_state"], peer) != CLOSED)
    ep = row_at(st["cn_epoch"], peer)
    ctx.send(peer, TAG_RST, [ep], when=w)
    st["cn_state"] = put_at(st["cn_state"], peer, CLOSED, w)
    st["cn_epoch"] = put_at(st["cn_epoch"], peer, ep + w.to(_I32))
