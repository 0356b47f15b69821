"""Service sugar: the `#[madsim::service]` / tonic-server analog (the
counterpart of `madsim_tpu.net.service`).

Subclass `Service` and decorate methods with `@rpc`: the base class's
`on_message` dispatches by a stable per-method tag (a hash of the
method's qualified name, the JAX package's bit for bit) and sends the
reply. Every method body runs each event for every lane, gated by its
`when` mask.

    class Counter(Service):
        @rpc
        def add(self, ctx, st, payload, when):
            st["total"] = st["total"] + torch.where(when, payload[:, 1], 0)
            return [st["total"]]          # reply body

    client side: net.rpc.call(ctx, server, Counter.add.tag, [5], call_id,
                              retry_timer_tag=..., timeout=...)

`@rpc_stream` methods (the tonic streaming shapes) run once per frame
the reliable stream fabric (`net/streaming.py`) delivers, for every slot
of the window, gated by the frame's mask and method tag; a service with
any needs the `streaming_state(...)` leaves in its state spec.
"""

from __future__ import annotations

import torch

from ..core.api import Ctx, Program
from . import rpc as _rpc


def _hash33(s: str) -> int:
    """Stable 31-bit string hash (the hash_str const-fn shape,
    rpc.rs:81-91) for deriving method tags from qualified names."""
    h = 5381
    for c in s.encode():
        h = (h * 33 + c) & 0x7FFFFFFF
    return h | 1  # never 0, keep positive, below the REPLY_BIT


def rpc(fn):
    """Mark a Service method as an RPC handler. The method receives
    (ctx, st, payload, when) and returns the reply body (a list of int32
    words, per lane); its tag is `Method.tag`."""
    fn._rpc_tag = _hash33(fn.__qualname__) % (1 << 29)
    fn.tag = fn._rpc_tag
    return fn


def rpc_stream(fn):
    """Mark a Service method as a streaming handler (the tonic client,
    server and bidi streaming shapes). It is called once per delivered
    frame slot with (ctx, st, src, kind, call_id, body, when): kind,
    call_id [B], body [B, body_words], when [B]; kind is streaming.K_CALL
    / K_ITEM / K_END. Senders pass `method=Method.tag` on every frame so
    dispatch works on items too. Its tag is `Method.tag`, as in the JAX
    package."""
    fn._rpc_stream_tag = _hash33(fn.__qualname__) % (1 << 29)
    fn.tag = fn._rpc_stream_tag
    return fn


def _tagged(cls, attr: str, what: str) -> list:
    hs = [m for m in (getattr(cls, name) for name in dir(cls))
          if callable(m) and hasattr(m, attr)]
    hs.sort(key=lambda m: getattr(m, attr))
    tags = [getattr(m, attr) for m in hs]
    assert len(set(tags)) == len(tags), (
        f"{what} tag hash collision in {cls.__name__}: "
        f"{[m.__qualname__ for m in hs]} — rename a method")
    return hs


class Service(Program):
    """Base class dispatching tagged requests to @rpc methods and sending
    replies with the net.rpc call-id convention."""

    def _handlers(self):
        return _tagged(type(self), "_rpc_tag", "@rpc")

    def _stream_handlers(self):
        return _tagged(type(self), "_rpc_stream_tag", "@rpc_stream")

    def on_message(self, ctx: Ctx, src, tag, payload):
        st = dict(ctx.state)
        # handler tags are mutually exclusive, so all replies share one
        # send slot (the emission-count discipline of Raft's broadcasts)
        width = 0
        merged_tag = torch.zeros_like(tag, dtype=torch.int32)
        merged_when = torch.zeros_like(tag, dtype=torch.bool)
        bodies = []
        for m in self._handlers():
            when = tag == m._rpc_tag
            body = [ctx._i32(wd) for wd in m(self, ctx, st, payload, when)]
            bodies.append((when, body))
            width = max(width, len(body))
            merged_tag = torch.where(when, m._rpc_tag, merged_tag)
            merged_when = merged_when | when
        merged_body = [torch.zeros_like(merged_tag)] * width
        for when, body in bodies:
            for i, wd in enumerate(body):
                merged_body[i] = torch.where(when, wd, merged_body[i])
        ctx.send(src, _rpc.reply_tag(merged_tag),
                 [payload[:, 0]] + merged_body, when=merged_when)

        # streaming methods: dispatch each frame slot the reliable stream
        # fabric delivers this event
        shs = self._stream_handlers()
        if shs:
            assert "sx_val" in st, (
                f"{type(self).__name__} has @rpc_stream methods but its "
                "state spec lacks streaming_state(...) fields — frames "
                "would be silently ignored")
            from . import stream as _stream
            from . import streaming
            kinds, methods, cids, bodies_f, mask = streaming.on_stream(
                ctx, st, src, tag, payload)
            for i in _stream.delivered_slots(mask):
                for m in shs:
                    m(self, ctx, st, src, kinds[:, i], cids[:, i],
                      bodies_f[:, i],
                      mask[:, i] & (methods[:, i] == m._rpc_stream_tag))
        ctx.state = st
