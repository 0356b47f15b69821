"""Typed request/response helpers: the sim RPC layer (the counterpart of
`madsim_tpu.net.rpc`).

madsim's RPC (net/rpc.rs:93-165) draws a random response tag, sends
`(rsp_tag, request)` on the request type's tag and awaits the response
tag. The state-machine analog: the caller draws a random call id, keeps
it in its protocol state, sends it in the payload and matches it on the
reply; a retry timer re-sends until the matching reply lands.

Conventions used by these helpers:
  payload[:, 0] = call id (random per attempt chain, constant across
                  retries)
  payload[:, 1:] = request/response body
Reply tags are `reply_tag(req_tag)` = req_tag | REPLY_BIT.
"""

from __future__ import annotations

from ..core.api import Ctx

REPLY_BIT = 1 << 30


def reply_tag(req_tag):
    return req_tag | REPLY_BIT


def is_reply(tag):
    return (tag & REPLY_BIT) != 0


def new_call_id(ctx: Ctx):
    """A random positive int32 call id a lane (rpc.rs:120 draws a random
    response tag)."""
    return ctx.randint(1, 2**30 - 1)


def call(ctx: Ctx, dst, req_tag, body, call_id, *, retry_timer_tag,
         timeout, when=True):
    """Send a request and arm its retry/timeout timer.

    body: list of int32 words (payload[:, 1:]). On timeout the caller's
    on_timer fires with `retry_timer_tag`; re-issue with the SAME call_id
    to retry, or a fresh id to abandon."""
    ctx.send(dst, req_tag, [call_id] + list(body), when=when)
    ctx.set_timer(timeout, retry_timer_tag, [call_id], when=when)


def reply(ctx: Ctx, src, req_tag, payload, body, *, when=True):
    """Answer a request: echo the call id (payload[:, 0]) back with the
    body (the server half of add_rpc_handler, rpc.rs:142-165)."""
    ctx.send(src, reply_tag(req_tag), [payload[:, 0]] + list(body),
             when=when)


def matches(payload, call_id):
    """Does this reply answer the outstanding call? (A stale or duplicate
    reply, e.g. from a retry race, must be ignored by the caller.)"""
    return payload[:, 0] == call_id
