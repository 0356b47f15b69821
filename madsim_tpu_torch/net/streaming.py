"""Streaming RPC — the madsim-tonic analog, all four gRPC method shapes
(the counterpart of `madsim_tpu.net.streaming`).

Each stream item is its own frame on the RELIABLE ordered stream layer
(net/stream.py with vector items), and termination is a StreamEnd
marker:

  frame = [kind, method_tag, call_id, *body]
    kind: K_CALL (open: the request or the stream header)
          K_ITEM (one stream element, either direction)
          K_END  (the StreamEnd marker)
          K_REPLY (the unary or final response)

Call ids are random per call (the net/rpc.py convention); items of
concurrent calls interleave on one peer stream and demux by call id.

  unary            open(K_CALL+body) ......... reply(K_REPLY+body)
  client-streaming open, push*, finish ....... reply(K_REPLY aggregate)
  server-streaming open(request) ............. push*, finish
  bidi             open, push*, finish ....... push*, finish
"""

from __future__ import annotations

from ..core.api import Ctx
from . import stream

K_CALL, K_ITEM, K_END, K_REPLY = 1, 2, 3, 4

HEADER_WORDS = 3  # kind, method_tag, call_id


def streaming_state(n_nodes: int, window: int = 4, body_words: int = 2):
    """Stream-fabric state sized for framed RPC items. Needs
    cfg.payload_words >= 2 + HEADER_WORDS + body_words."""
    return stream.stream_state(n_nodes, window,
                               item_words=HEADER_WORDS + body_words)


def body_width(st) -> int:
    return st["sx_val"].shape[-1] - HEADER_WORDS


def _frame(kind, method, call_id, body, V):
    words = [kind, method, call_id, *body]
    assert len(words) <= V, f"frame ({len(words)} words) exceeds item ({V})"
    return words


def _send(ctx, st, dst, kind, method, call_id, body, when):
    V = st["sx_val"].shape[-1]
    return stream.send(ctx, st, dst, _frame(kind, method, call_id, body, V),
                       when=when)


def open_call(ctx: Ctx, st, dst, method, call_id, body=(), *, when=True):
    """Start a call (any shape): K_CALL carries the unary request or the
    stream header. Returns the ok mask (False: send window full)."""
    return _send(ctx, st, dst, K_CALL, method, call_id, body, when)


def push(ctx: Ctx, st, dst, call_id, body=(), *, method=0, when=True):
    """Send one stream item on an open call (either direction)."""
    return _send(ctx, st, dst, K_ITEM, method, call_id, body, when)


def finish(ctx: Ctx, st, dst, call_id, *, method=0, when=True):
    """Send the StreamEnd marker."""
    return _send(ctx, st, dst, K_END, method, call_id, (), when)


def reply(ctx: Ctx, st, dst, call_id, body=(), *, method=0, when=True):
    """Send the unary or aggregate response of a call."""
    return _send(ctx, st, dst, K_REPLY, method, call_id, body, when)


def on_stream(ctx: Ctx, st, src, tag, payload, *, epoch_guard=True):
    """Feed a received message through transport and framing.

    Returns (kinds [B, W], methods [B, W], call_ids [B, W], bodies
    [B, W, body], mask [B, W]): the frames newly deliverable IN ORDER
    this event. Non-stream tags give an all-False mask."""
    vals, mask = stream.on_message(ctx, st, src, tag, payload,
                                   epoch_guard=epoch_guard)
    return (vals[..., 0], vals[..., 1], vals[..., 2],
            vals[..., HEADER_WORDS:], mask)


def tick(ctx: Ctx, st, peers, *, when=True):
    """Retransmit unacked frames to each peer (the transport's Go-Back-N
    driver; arm a periodic timer and call this on fire)."""
    for p in peers:
        stream.retransmit(ctx, st, p, when=when)


def reset_peer(st, peer, *, when=True, epoch=None):
    """Tear down the stream fabric to a (restarted) peer: outstanding
    calls die with the connection."""
    stream.reset_peer(st, peer, when=when, epoch=epoch)
