"""Reliable ordered streams over the unordered, lossy message layer — the
simulated-TCP analog (the counterpart of `madsim_tpu.net.stream`).

The engine's messages are datagrams: latency jitter reorders them, loss
drops them, clogs block them and the dup-storm knob duplicates them.
This module layers TCP semantics on top as a state-machine library:
sliding-window transmission, cumulative acks, timer-driven
retransmission, exactly-once in-order delivery. Window slots are a fixed
ring (seq % window), so every shape is static.

Peer incarnations: every DATA and ACK frame carries the sender's
per-peer stream epoch (`st_epoch[peer]`, the connection generation that
net/conn.py negotiates or `reset_peer` bumps). A receiver drops frames of
an older generation and adopts a newer one (wipes both directions, jumps
the epoch, then processes the frame). `epoch_guard=False` gives the
accept-everything transport, the red control.

Inside a handler every leaf carries the lane axis: a node's stream state
is `sx_seq` [B, N], `sx_val` [B, N, W] (or [B, N, W, V] for vector
items), and so on; `dst` / `src` is a Python int or a [B] tensor, `when`
a Python bool or a [B] mask. Usage (see tests/test_torch_stream.py):

    spec = {**my_spec, **stream.stream_state(n_nodes, window=4)}
    # sender:   stream.send(ctx, st, dst, value, when=...)
    #           stream.retransmit(ctx, st, dst, when=timer_fired)
    # receiver: vals, mask = stream.on_message(ctx, st, src, tag, payload)
    #           -> up to `window` values delivered IN ORDER this event
"""

from __future__ import annotations

import torch

from ..core.api import Ctx
from ..ops.select import put_at, put_row, row_at
from ..utils.maskutil import statically_false

TAG_DATA = 1 << 20
TAG_ACK = (1 << 20) + 1

_I32 = torch.int32


def stream_state(n_nodes: int, window: int = 4, item_words: int = 1):
    """One node's stream state: one bidirectional stream per peer.

    item_words > 1 makes each element a fixed int32 vector (rings gain a
    trailing [item_words] axis). Needs payload_words >= 2 + item_words
    (seq, epoch, item)."""
    N, W, V = n_nodes, window, item_words
    z = torch.zeros((N,), dtype=_I32)
    shape = (N, W) if V == 1 else (N, W, V)
    return dict(
        sx_seq=z,                                  # next seq to assign (tx)
        sx_base=z.clone(),                         # lowest unacked seq
        sx_val=torch.zeros(shape, dtype=_I32),     # unacked ring
        sr_next=z.clone(),                         # next expected seq (rx)
        sr_val=torch.zeros(shape, dtype=_I32),     # out-of-order ring
        sr_have=torch.zeros((N, W), dtype=torch.bool),
        st_epoch=z.clone(),                        # peering incarnation
    )


def _window(st) -> int:
    return st["sr_have"].shape[-1]


def _item_words(st) -> int:
    v = st["sx_val"]
    return 1 if v.ndim == 3 else v.shape[3]


def _as_item(ctx: Ctx, val, V):
    """A scalar / list / [B, V] tensor as the stream's per-lane item:
    [B] for scalar streams, [B, V] for vector ones."""
    if V == 1:
        return ctx._i32(val)
    if isinstance(val, (list, tuple)):
        items = [ctx._i32(x) for x in val]
        items += [ctx._i32(0)] * (V - len(items))
        return torch.stack(items, dim=-1)
    assert tuple(val.shape[1:]) == (V,), \
        f"stream item must be (B, {V}), got {tuple(val.shape)}"
    return val.to(_I32)


def _data_payload(seq, epoch, item, V):
    if V == 1:
        return [seq, epoch, item]
    return [seq, epoch] + list(item.unbind(-1))


def send(ctx: Ctx, st, dst, val, *, when=True):
    """Enqueue one value on the stream to `dst` and transmit it. Refused
    (a False mask) where the send window is full — a TCP write blocking
    on a full buffer."""
    if statically_false(when):
        return ctx._mask(False)
    W, V = _window(st), _item_words(st)
    val = _as_item(ctx, val, V)
    seq = row_at(st["sx_seq"], dst)
    room = (seq - row_at(st["sx_base"], dst)) < W
    ok = ctx._mask(when) & room
    slot = torch.remainder(seq, W)
    st["sx_val"] = put_at(st["sx_val"], dst,
                          put_row(row_at(st["sx_val"], dst), slot, val, ok))
    st["sx_seq"] = put_at(st["sx_seq"], dst, seq + ok.to(_I32))
    ctx.send(dst, TAG_DATA,
             _data_payload(seq, row_at(st["st_epoch"], dst), val, V),
             when=ok)
    return ok


def retransmit(ctx: Ctx, st, dst, *, when=True):
    """Resend every unacked value to `dst` (cumulative-ack Go-Back-N):
    W sends a call, each masked by whether its slot is live. After
    `reset_peer` no slot is live (sx_base == sx_seq == 0), and whatever
    is sent stamps the current epoch."""
    if statically_false(when):
        return
    W, V = _window(st), _item_words(st)
    base, nxt = row_at(st["sx_base"], dst), row_at(st["sx_seq"], dst)
    ring = row_at(st["sx_val"], dst)
    epoch = row_at(st["st_epoch"], dst)
    w = ctx._mask(when)
    for i in range(W):
        seq = base + i
        live = w & (seq < nxt)
        ctx.send(dst, TAG_DATA,
                 _data_payload(seq, epoch,
                               row_at(ring, torch.remainder(seq, W)), V),
                 when=live)


def delivered_slots(mask):
    """The slots of the per-event delivery loop. The JAX package visits
    only the delivered slots of a concrete mask; here the mask is a [B, W]
    tensor and every slot is visited with masked ops (reading the mask
    would wait for the device)."""
    if isinstance(mask, torch.Tensor):
        return range(mask.shape[-1])
    import numpy as np
    return np.nonzero(np.asarray(mask))[0].tolist()


def _wipe_peer(st, peer, w):
    """Zero both directions of the ring and counter fabric to `peer`
    where `w` — shared by reset_peer and the adoption path."""
    for k in ("sx_seq", "sx_base", "sr_next", "sx_val", "sr_val"):
        st[k] = put_at(st[k], peer, 0, w)
    st["sr_have"] = put_at(st["sr_have"], peer, False, w)


def reset_peer(st, peer, *, when=True, epoch=None):
    """Wipe both directions of the stream to `peer` (a fresh sequence
    space) and advance the peering's incarnation: by one with
    `epoch=None`, else to the generation the conn layer negotiated."""
    if statically_false(when):
        return
    _wipe_peer(st, peer, when)
    cur = row_at(st["st_epoch"], peer)
    new_ep = cur + 1 if epoch is None else epoch
    st["st_epoch"] = put_at(st["st_epoch"], peer, new_ep, when)


def on_message(ctx: Ctx, st, src, tag, payload, *, epoch_guard=True):
    """Feed a received message through the stream layer.

    Returns (vals, mask): up to `window` values newly deliverable IN
    ORDER (mask [B, W] marks validity); vals is [B, W] for scalar streams
    and [B, W, V] for vector ones. Non-stream tags give an all-False mask,
    so it is safe to call unconditionally.

    Incarnation guard: payload[:, 1] carries the sender's epoch. Frames
    of an older generation than `st_epoch[src]` are dropped; a newer one
    is adopted (both directions wiped, epoch jumped) before the frame is
    processed. `epoch_guard=False` accepts every frame."""
    W, V = _window(st), _item_words(st)
    if statically_false((tag == TAG_DATA) | (tag == TAG_ACK)):
        B = payload.shape[0]
        shape = (B, W) if V == 1 else (B, W, V)
        return (torch.zeros(shape, dtype=_I32, device=payload.device),
                torch.zeros((B, W), dtype=torch.bool, device=payload.device))
    tag = ctx._i32(tag)
    is_data = tag == TAG_DATA
    is_ack = tag == TAG_ACK
    if epoch_guard:
        ep = payload[:, 1]
        cur = row_at(st["st_epoch"], src)
        relevant = is_data | is_ack
        fresh = relevant & (ep > cur)
        stale = relevant & (ep < cur)
        # the peer moved to a newer incarnation (a reset this side
        # missed): wipe both directions onto it, then let the frame land
        _wipe_peer(st, src, fresh)
        st["st_epoch"] = put_at(st["st_epoch"], src,
                                torch.where(fresh, ep, cur))
        is_data = is_data & ~stale
        is_ack = is_ack & ~stale

    # ---- DATA: buffer in-window segments, deliver the contiguous run ----
    seq = payload[:, 0]
    val = payload[:, 2] if V == 1 else payload[:, 2:2 + V]
    nxt = row_at(st["sr_next"], src)
    in_win = is_data & (seq >= nxt) & (seq < nxt + W)
    slot = torch.remainder(seq, W)
    vring = put_row(row_at(st["sr_val"], src), slot, val, in_win)
    have = put_row(row_at(st["sr_have"], src), slot, True, in_win)
    # the longest contiguous run from sr_next (exactly once, in order);
    # the int32 cumprod and sum keep the reference's word width
    idx = torch.remainder(
        nxt[:, None] + torch.arange(W, dtype=_I32, device=nxt.device), W)
    idx64 = idx.to(torch.int64)
    run = torch.cumprod(torch.gather(have, 1, idx64).to(_I32), 1,
                        dtype=_I32)
    count = run.sum(1, dtype=_I32)
    deliver = is_data[:, None] & (run == 1)
    if V == 1:
        vals = torch.gather(vring, 1, idx64)
    else:
        vals = torch.gather(vring, 1, idx64[..., None].expand(-1, -1, V))
    # clear the delivered slots (idx is a permutation of the ring)
    cleared = torch.zeros_like(have).scatter(1, idx64, deliver)
    st["sr_val"] = put_at(st["sr_val"], src, vring)
    st["sr_have"] = put_at(st["sr_have"], src, have & ~cleared)
    new_next = nxt + torch.where(is_data, count, 0)
    st["sr_next"] = put_at(st["sr_next"], src, new_next)
    # cumulative ack (duplicates below the window are re-acked), stamped
    # with the generation it acknowledges
    ctx.send(src, TAG_ACK, [new_next, row_at(st["st_epoch"], src)],
             when=is_data)

    # ---- ACK: slide the send window ------------------------------------
    base = row_at(st["sx_base"], src)
    clipped = torch.minimum(torch.maximum(payload[:, 0], base),
                            row_at(st["sx_seq"], src))
    st["sx_base"] = put_at(st["sx_base"], src,
                           torch.where(is_ack, clipped, base))
    return vals, deliver
