"""ministream — a streaming dataflow with barrier-aligned exactly-once
epochs (the counterpart of `madsim_tpu.models.ministream`, written for
batched [B, ...] node state).

Topology (4 nodes):

    source(0) --DATA(idx even)--> mapper(1) --CNT--> sink(3)
              --DATA(idx odd)---> mapper(2) --CNT-->

The source emits one epoch at a time (K records split by idx parity, then
a BARRIER to both mappers) and retransmits it until the sink's COMMIT. A
mapper accumulates an idx BITMASK per (epoch, attempt) and forwards its
popcount on the barrier only once its residue class is complete
(`strict_barrier=False` ships the classic bug: commit on the first
barrier). A restarted mapper's HELLO makes the source replay the epoch
under a fresh attempt. The sink commits epochs in order and checks the
exactly-once oracle at every commit (CRASH_STREAM_LOST_OR_DUP).

The idx bitmask and its popcount stay int32 and wrap as the reference's
do (ROADMAP F2); the sink's per-mapper slot writes are `put_row` at the
reference's clipped slot.
"""

from __future__ import annotations

import torch

from ..core.api import Ctx, Program
from ..core.types import ms
from ..ops.select import put_row, take1

SOURCE, MAP_A, MAP_B, SINK = 0, 1, 2, 3

M_DATA, M_BARRIER, M_CNT, M_COMMIT, M_HELLO = 1, 2, 3, 4, 5
T_RETX = 1

CRASH_STREAM_LOST_OR_DUP = 401

_I32 = torch.int32


def stream_state_spec():
    z = torch.tensor(0, dtype=_I32)
    return dict(
        # source
        s_epoch=z, s_att=z, s_done=z,
        # mapper (volatile by design: a kill erases the epoch's progress)
        m_mask=z, m_e=z, m_att=z,
        # sink
        k_cnt=torch.zeros((2,), dtype=_I32),      # per-mapper count
        k_att=torch.full((2,), -1, dtype=_I32),   # attempt each count carries
        k_have=torch.zeros((2,), dtype=_I32),     # count present this epoch
        k_committed=z,                            # epochs committed so far
    )


class Source(Program):
    def __init__(self, k: int, epochs: int, retx=ms(40)):
        assert 2 <= k <= 31, "idx bitmask packs into one int32 word"
        self.K = k
        self.E = epochs
        self.retx = retx

    def _emit_epoch(self, ctx: Ctx, st, when):
        """(Re)send the whole current epoch: K records + barriers, with
        exactly one retransmit timer armed."""
        e, att = st["s_epoch"], st["s_att"]
        for idx in range(self.K):
            dst = MAP_A if idx % 2 == 0 else MAP_B
            ctx.send(dst, M_DATA, [e, att, idx], when=when)
        ctx.send(MAP_A, M_BARRIER, [e, att], when=when)
        ctx.send(MAP_B, M_BARRIER, [e, att], when=when)
        ctx.cancel_timer(T_RETX, when=when)
        ctx.set_timer(self.retx, T_RETX, [e], when=when)

    def init(self, ctx: Ctx):
        st = dict(ctx.state)
        self._emit_epoch(ctx, st, when=True)
        ctx.state = st

    def on_timer(self, ctx: Ctx, tag, payload):
        st = dict(ctx.state)
        # retransmit while the epoch payload[0] is still uncommitted
        live = ((tag == T_RETX) & (payload[:, 0] == st["s_epoch"])
                & (st["s_done"] == 0))
        self._emit_epoch(ctx, st, when=live)
        ctx.state = st

    def on_message(self, ctx: Ctx, src, tag, payload):
        st = dict(ctx.state)
        # a mapper came back amnesic: replay the epoch under a fresh attempt
        hello = (tag == M_HELLO) & (st["s_done"] == 0)
        st["s_att"] = st["s_att"] + hello
        self._emit_epoch(ctx, st, when=hello)

        # sink committed our current epoch: advance (or finish)
        commit = (tag == M_COMMIT) & (payload[:, 0] == st["s_epoch"])
        nxt = st["s_epoch"] + 1
        st["s_done"] = torch.where(commit & (nxt >= self.E), 1, st["s_done"])
        advance = commit & (nxt < self.E)
        st["s_epoch"] = torch.where(advance, nxt, st["s_epoch"])
        st["s_att"] = torch.where(advance, 0, st["s_att"])
        self._emit_epoch(ctx, st, when=advance)
        ctx.state = st


class Mapper(Program):
    def __init__(self, k: int, strict_barrier: bool = True):
        self.K = k
        self.strict = strict_barrier
        self._sh = {}         # the popcount's shifts, once a device

    def init(self, ctx: Ctx):
        # rebirth: progress is gone; ask the source for an epoch replay
        ctx.send(SOURCE, M_HELLO)

    def _mine(self, ctx, idx):
        return torch.where(ctx.node == MAP_A, idx % 2 == 0, idx % 2 == 1)

    def on_message(self, ctx: Ctx, src, tag, payload):
        st = dict(ctx.state)
        e, att = payload[:, 0], payload[:, 1]
        newer = (e > st["m_e"]) | ((e == st["m_e"]) & (att > st["m_att"]))
        stale = (e < st["m_e"]) | ((e == st["m_e"]) & (att < st["m_att"]))

        is_data_raw = (tag == M_DATA) & self._mine(ctx, payload[:, 2])
        is_barrier = tag == M_BARRIER
        # ANY message from a newer (epoch, attempt) advances the key and
        # resets the mask, a barrier included
        adv = (is_data_raw | is_barrier) & newer
        st["m_mask"] = torch.where(adv, 0, st["m_mask"])
        st["m_e"] = torch.where(adv, e, st["m_e"])
        st["m_att"] = torch.where(adv, att, st["m_att"])

        is_data = is_data_raw & ~stale
        bit = torch.ones_like(tag) << torch.clamp(payload[:, 2], 0, 30)
        st["m_mask"] = torch.where(is_data, st["m_mask"] | bit,
                                   st["m_mask"])

        # barrier for the CURRENT (e, att): forward the count; the strict
        # gate also requires the residue class to be complete
        n_mine = (self.K + torch.where(ctx.node == MAP_A, 1, 0)) // 2
        dev = tag.device
        if dev not in self._sh:
            self._sh[dev] = torch.arange(31, dtype=_I32, device=dev)
        count = ((st["m_mask"].unsqueeze(-1) >> self._sh[dev]) & 1).sum(
            -1, dtype=_I32)
        cur_barrier = (is_barrier & (e == st["m_e"])
                       & (att == st["m_att"]))
        done = cur_barrier & (count == n_mine) if self.strict \
            else cur_barrier
        ctx.send(SINK, M_CNT, [st["m_e"], st["m_att"], count], when=done)
        ctx.state = st


class Sink(Program):
    def __init__(self, k: int, epochs: int):
        self.K = k
        self.E = epochs

    def on_message(self, ctx: Ctx, src, tag, payload):
        st = dict(ctx.state)
        e, att, cnt = payload[:, 0], payload[:, 1], payload[:, 2]
        slot = torch.clamp(src - MAP_A, 0, 1)
        is_cnt = tag == M_CNT

        # COMMIT acks can be lost: re-ack stragglers of committed epochs
        ctx.send(SOURCE, M_COMMIT, [e],
                 when=is_cnt & (e < st["k_committed"]))

        # counts for the epoch being committed; newest attempt wins
        cur = is_cnt & (e == st["k_committed"])
        take = cur & (att >= take1(st["k_att"], slot))
        st["k_cnt"] = put_row(st["k_cnt"], slot, cnt, take)
        st["k_att"] = put_row(st["k_att"], slot, att, take)
        st["k_have"] = put_row(st["k_have"], slot, 1, take)

        # barrier ALIGNMENT at the join: both inputs present AND from the
        # same attempt
        have, k_att, k_cnt = st["k_have"], st["k_att"], st["k_cnt"]
        both = ((have[:, 0] == 1) & (have[:, 1] == 1)
                & (k_att[:, 0] == k_att[:, 1]))
        total = k_cnt[:, 0] + k_cnt[:, 1]
        commit = cur & both & (st["k_committed"] < self.E)
        # THE exactly-once oracle
        ctx.crash_if(commit & (total != self.K), CRASH_STREAM_LOST_OR_DUP)
        ctx.send(SOURCE, M_COMMIT, [st["k_committed"]], when=commit)
        st["k_committed"] = st["k_committed"] + commit
        # fresh epoch: clear the alignment slots
        c = commit.unsqueeze(-1)
        st["k_cnt"] = torch.where(c, 0, st["k_cnt"])
        st["k_att"] = torch.where(c, -1, st["k_att"])
        st["k_have"] = torch.where(c, 0, st["k_have"])
        ctx.state = st


def make_ministream_runtime(k=8, epochs=4, strict_barrier=True,
                            scenario=None, cfg=None, device=None):
    from ..core.types import NetConfig, SimConfig, sec
    from ..runtime.runtime import Runtime

    if cfg is None:
        cfg = SimConfig(n_nodes=4, event_capacity=160, time_limit=sec(60),
                        net=NetConfig(packet_loss_rate=0.05))
    progs = [Source(k, epochs), Mapper(k, strict_barrier), Sink(k, epochs)]
    return Runtime(cfg, progs, stream_state_spec(),
                   node_prog=[0, 1, 1, 2], scenario=scenario,
                   halt_when=lambda s: s.node_state["s_done"][:, SOURCE] == 1,
                   device=device)
