"""Chain replication with a reconfiguring master (van Renesse & Schneider,
OSDI'04); the counterpart of `madsim_tpu.models.chain`, written for
batched [B, ...] node state.

Cluster: node 0 = master, nodes 1..R = replicas, R+1.. = clients.

  * WRITES enter at the HEAD and propagate down the chain; the TAIL acks
    the client. Propagation is idempotent (monotonic per-client ids dedup
    at every hop), so a client's retry through the head repairs writes
    stranded by a mid-chain failure.
  * READS are served by the tail alone, gated by a LEASE. Virtual time is
    one clock across the cluster, so leases are exact and the invariant
    "at most one replica believes it is a lease-holding tail"
    (CRASH_TWO_TAILS) is checked after every event. The master activates
    a new epoch only after old leases provably expired.
  * Membership: replicas ping the master; a silent replica is declared
    dead and the chain shrinks, survivors keeping their order. A
    restarted replica re-enters only if the master had not yet removed
    it.

Histories are recorded client-side and checked with the linearizability
checker (`native.check_kv_history`, as for the KV store on Raft).
One-slot writes are `put_row` at the reference's clipped index.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.api import Ctx, Program
from ..core.types import ms
from ..ops.select import put_row, take1

# message tags
CFG_REQ, CFG, BEAT, PING, WRITE, READ, CRSP = 11, 12, 13, 14, 15, 16, 17
# timer tags
T_BEAT, T_PING, T_CHECK, T_ACT, T_NEW, T_RETRY = 1, 2, 3, 4, 5, 6
# CRSP statuses
ST_OK, ST_REFUSE = 1, 2

OP_PUT, OP_GET = 1, 2

CRASH_TWO_TAILS = 501

MASTER = 0

_I32 = torch.int32


def _pick(cond, a, b):
    """int32 `where` of two Python ints (a bare `torch.where` of two
    scalars would be int64)."""
    return torch.where(cond, a, b).to(_I32)


def chain_state_spec(n_nodes: int, n_replicas: int, n_keys: int,
                     n_ops: int):
    z = torch.tensor(0, dtype=_I32)
    R = n_replicas
    return dict(
        # master
        m_last=torch.zeros((n_nodes,), dtype=_I32),   # last ping per node
        m_epoch=torch.tensor(1, dtype=_I32),
        m_chain=torch.zeros((R,), dtype=_I32),
        m_len=z,
        m_pend=z,
        # replica
        r_epoch=z,
        r_chain=torch.zeros((R,), dtype=_I32),
        r_len=z,
        r_pos=torch.tensor(-1, dtype=_I32),
        r_lease=z,
        kv=torch.zeros((n_keys,), dtype=_I32),
        sess_rtag=torch.zeros((n_nodes,), dtype=_I32),
        # client
        c_epoch=z, c_head=z, c_tail=z, c_have=z,
        c_opn=z, c_wait=z, c_op=z, c_key=z, c_val=z,
        h_op=torch.zeros((n_ops,), dtype=_I32),
        h_key=torch.zeros((n_ops,), dtype=_I32),
        h_val=torch.zeros((n_ops,), dtype=_I32),
        h_inv=torch.full((n_ops,), -1, dtype=_I32),
        h_resp=torch.full((n_ops,), -1, dtype=_I32),
    )


def chain_persist_spec(spec):
    """The replicated register state survives a blip-restart; config and
    lease deliberately do NOT."""
    return {k: k in ("kv", "sess_rtag") for k in spec}


class ChainMaster(Program):
    """Failure detector + configuration service: on a dead chain member,
    wait `wait` (> lease), then activate epoch+1 without the dead. `wait`
    <= lease is a real protocol bug that the two-tails invariant
    catches."""

    def __init__(self, n_replicas: int, lease=ms(120), beat_every=ms(30),
                 check_every=ms(40), dead_after=ms(100), wait=None):
        self.R = n_replicas
        self.lease = lease
        self.hb = beat_every
        self.chk = check_every
        self.dead = dead_after
        self.wait = wait if wait is not None else lease + ms(30)

    def init(self, ctx: Ctx):
        st = dict(ctx.state)
        only = ctx.node == MASTER
        # initial chain: all replicas, in id order
        ids = torch.arange(1, self.R + 1, dtype=_I32, device=only.device)
        st["m_chain"] = torch.where(only[:, None], ids, st["m_chain"])
        st["m_len"] = torch.where(only, self.R, st["m_len"])
        st["m_last"] = torch.where(only[:, None], ctx.now[:, None],
                                   st["m_last"])
        ctx.set_timer(self.hb, T_BEAT, [0], when=only)
        ctx.set_timer(self.chk, T_CHECK, [0], when=only)
        ctx.state = st

    def on_timer(self, ctx: Ctx, tag, payload):
        st = dict(ctx.state)
        R = self.R
        chain = st["m_chain"]
        ks = torch.arange(R, dtype=_I32, device=tag.device)
        member = ks < st["m_len"][:, None]

        # config beats to current members; the lease expiry is
        # grant-anchored (computed at send time, carried in the beat)
        is_beat = tag == T_BEAT
        expiry = ctx.now + self.lease
        beat_payload = torch.cat(
            [torch.stack([st["m_epoch"], st["m_len"], expiry], -1), chain],
            -1)
        for i in range(R):
            ctx.send(chain[:, i], BEAT, beat_payload,
                     when=is_beat & member[:, i] & (st["m_pend"] == 0))
        ctx.set_timer(self.hb, T_BEAT, [0], when=is_beat)

        # failure detection: a silent chain member triggers reconfiguration
        is_chk = tag == T_CHECK
        last = take1(st["m_last"], torch.clamp(chain, min=0))
        silent = ctx.now[:, None] - last > self.dead
        any_dead = (silent & member).any(-1)
        start = is_chk & any_dead & (st["m_pend"] == 0)
        st["m_pend"] = torch.where(start, 1, st["m_pend"])
        ctx.set_timer(self.wait, T_ACT, [0], when=start)
        ctx.set_timer(self.chk, T_CHECK, [0], when=is_chk)

        # activation: drop every member STILL silent now, bump the epoch;
        # survivors keep their relative order (the j-th new slot takes the
        # (j+1)-th kept element: a searchsorted of the kept prefix count)
        is_act = (tag == T_ACT) & (st["m_pend"] == 1)
        keep = member & ~silent
        cs = torch.cumsum(keep.to(_I32), -1, dtype=_I32)
        srcs = (cs[:, None, :] < (ks + 1)[:, None]).sum(-1, dtype=_I32)
        n_keep = keep.sum(-1, dtype=_I32)
        new_chain = torch.where(ks < n_keep[:, None],
                                take1(chain, torch.clamp(srcs, 0, R - 1)),
                                torch.zeros_like(chain))
        changed = n_keep < st["m_len"]
        act = is_act & changed
        st["m_chain"] = torch.where(act[:, None], new_chain, st["m_chain"])
        st["m_len"] = torch.where(act, n_keep, st["m_len"])
        st["m_epoch"] = st["m_epoch"] + act
        st["m_pend"] = torch.where(is_act, 0, st["m_pend"])
        ctx.state = st

    def on_message(self, ctx: Ctx, src, tag, payload):
        st = dict(ctx.state)
        is_ping = tag == PING
        sc = torch.clamp(src, 0, st["m_last"].shape[-1] - 1)
        st["m_last"] = put_row(st["m_last"], sc, ctx.now, is_ping)
        # config queries (clients): head/tail of the CURRENT epoch
        is_req = tag == CFG_REQ
        head = st["m_chain"][:, 0]
        tail = take1(st["m_chain"], torch.clamp(st["m_len"] - 1, 0,
                                                self.R - 1))
        ctx.send(src, CFG, [st["m_epoch"], head, tail, payload[:, 0]],
                 when=is_req & (st["m_len"] > 0))
        ctx.state = st


class ChainReplica(Program):
    def __init__(self, n_replicas: int, n_keys: int, ping_every=ms(25)):
        self.R = n_replicas
        self.K = n_keys
        self.hp = ping_every

    def init(self, ctx: Ctx):
        ctx.set_timer(ctx.randint(0, self.hp), T_PING, [0])

    def on_timer(self, ctx: Ctx, tag, payload):
        is_ping = tag == T_PING
        ctx.send(MASTER, PING, [0], when=is_ping)
        ctx.set_timer(self.hp, T_PING, [0], when=is_ping)

    def on_message(self, ctx: Ctx, src, tag, payload):
        st = dict(ctx.state)
        R = self.R

        # ---- config beat: adopt newer epochs, extend the lease ----------
        is_beat = (tag == BEAT) & (src == MASTER)
        epoch, clen, expiry = payload[:, 0], payload[:, 1], payload[:, 2]
        chain = payload[:, 3:3 + R]
        newer = is_beat & (epoch >= st["r_epoch"])
        st["r_epoch"] = torch.where(newer, epoch, st["r_epoch"])
        st["r_chain"] = torch.where(newer[:, None], chain, st["r_chain"])
        st["r_len"] = torch.where(newer, clen, st["r_len"])
        ks = torch.arange(R, dtype=_I32, device=tag.device)
        mine = (chain == ctx.node[:, None]) & (ks < clen[:, None])
        mypos = torch.where(mine, ks, -1).max(-1).values.to(_I32)
        st["r_pos"] = torch.where(newer, mypos, st["r_pos"])
        # grant-anchored: take the master's expiry, never now + lease
        st["r_lease"] = torch.where(newer,
                                    torch.maximum(st["r_lease"], expiry),
                                    st["r_lease"])

        # ---- write propagation (idempotent at every hop) ----------------
        is_w = ((tag == WRITE) & (payload[:, 0] == st["r_epoch"])
                & (st["r_pos"] >= 0))
        client, rtag = payload[:, 1], payload[:, 2]
        key = torch.clamp(payload[:, 3], 0, self.K - 1)
        val = payload[:, 4]
        cc = torch.clamp(client, 0, st["sess_rtag"].shape[-1] - 1)
        fresh = is_w & (rtag > take1(st["sess_rtag"], cc))
        st["kv"] = put_row(st["kv"], key, val, fresh)
        st["sess_rtag"] = put_row(st["sess_rtag"], cc, rtag, fresh)
        at_tail = st["r_pos"] == st["r_len"] - 1
        succ = take1(st["r_chain"], torch.clamp(st["r_pos"] + 1, 0, R - 1))
        # forward down-chain or ack the client (shared send slot)
        zero = torch.zeros_like(rtag)
        ack = torch.stack([rtag, zero + ST_OK, val, zero, zero], -1)
        ctx.send(torch.where(at_tail, client, succ),
                 _pick(at_tail, CRSP, WRITE),
                 torch.where(at_tail[:, None], ack, payload[:, :5]),
                 when=is_w)

        # ---- reads: tail-only, lease-gated ------------------------------
        is_r = (tag == READ) & (payload[:, 0] == st["r_epoch"])
        serving = ((st["r_pos"] >= 0) & at_tail
                   & (ctx.now < st["r_lease"]))
        rkey = torch.clamp(payload[:, 3], 0, self.K - 1)
        ctx.send(payload[:, 1], CRSP,
                 [payload[:, 2], _pick(serving, ST_OK, ST_REFUSE),
                  take1(st["kv"], rkey)],
                 when=is_r)
        # stale-epoch reads are refused too
        ctx.send(payload[:, 1], CRSP, [payload[:, 2], ST_REFUSE, 0],
                 when=(tag == READ) & (payload[:, 0] != st["r_epoch"]))
        ctx.state = st


class ChainClient(Program):
    """Sequential PUT/GET over its own key range; refetches the config and
    retries (same monotonic rtag) on timeout or refusal."""

    def __init__(self, n_replicas: int, n_ops: int,
                 keys_per_client: int = 2, timeout=ms(60), think=ms(8)):
        self.R = n_replicas
        self.O = n_ops
        self.KPC = keys_per_client
        self.timeout = timeout
        self.think = think

    def _key(self, ctx, st):
        base = (ctx.node - 1 - self.R) * self.KPC
        return base + (st["c_opn"] // 2) % self.KPC

    def init(self, ctx: Ctx):
        ctx.set_timer(ctx.randint(0, ms(15)), T_NEW, [0])

    def _issue(self, ctx, st, when):
        rtag = st["c_opn"] + 1
        is_put = st["c_op"] == OP_PUT
        dst = torch.where(is_put, st["c_head"], st["c_tail"])
        body = torch.stack([st["c_epoch"], ctx.node, rtag,
                            self._key(ctx, st), st["c_val"]], -1)
        ctx.send(dst, _pick(is_put, WRITE, READ), body,
                 when=when & (st["c_have"] == 1))
        ctx.send(MASTER, CFG_REQ, [rtag], when=when & (st["c_have"] == 0))
        ctx.set_timer(self.timeout, T_RETRY, [rtag], when=when)

    def on_timer(self, ctx: Ctx, tag, payload):
        st = dict(ctx.state)
        start = ((tag == T_NEW) & (st["c_wait"] == 0)
                 & (st["c_opn"] < self.O))
        st["c_op"] = torch.where(start,
                                 _pick(st["c_opn"] % 2 == 0, OP_PUT, OP_GET),
                                 st["c_op"])
        st["c_val"] = torch.where(start & (st["c_op"] == OP_PUT),
                                  ctx.node * 4096 + st["c_opn"] + 1,
                                  st["c_val"])
        st["c_wait"] = torch.where(start, 1, st["c_wait"])
        oidx = torch.clamp(st["c_opn"], 0, self.O - 1)
        for col, v in (("h_op", st["c_op"]), ("h_key", self._key(ctx, st)),
                       ("h_val", st["c_val"]), ("h_inv", ctx.now)):
            st[col] = put_row(st[col], oidx, v, start)

        # timeout: config may be stale — refetch, then retry the SAME rtag
        retry = ((tag == T_RETRY) & (st["c_wait"] == 1)
                 & (payload[:, 0] == st["c_opn"] + 1))
        st["c_have"] = torch.where(retry, 0, st["c_have"])
        self._issue(ctx, st, start | retry)
        ctx.state = st

    def on_message(self, ctx: Ctx, src, tag, payload):
        st = dict(ctx.state)
        # config reply -> re-issue the in-flight op immediately
        is_cfg = (tag == CFG) & (src == MASTER)
        st["c_epoch"] = torch.where(is_cfg, payload[:, 0], st["c_epoch"])
        st["c_head"] = torch.where(is_cfg, payload[:, 1], st["c_head"])
        st["c_tail"] = torch.where(is_cfg, payload[:, 2], st["c_tail"])
        st["c_have"] = torch.where(is_cfg, 1, st["c_have"])
        self._issue(ctx, st, is_cfg & (st["c_wait"] == 1))

        # operation response
        hit = ((tag == CRSP) & (st["c_wait"] == 1)
               & (payload[:, 0] == st["c_opn"] + 1))
        ok = hit & (payload[:, 1] == ST_OK)
        # a refusal (stale tail / expired lease) = refetch config + retry
        refused = hit & (payload[:, 1] == ST_REFUSE)
        st["c_have"] = torch.where(refused, 0, st["c_have"])
        ctx.send(MASTER, CFG_REQ, [st["c_opn"] + 1], when=refused)

        oidx = torch.clamp(st["c_opn"], 0, self.O - 1)
        st["h_resp"] = put_row(st["h_resp"], oidx, ctx.now, ok)
        st["h_val"] = put_row(st["h_val"], oidx, payload[:, 2],
                              ok & (take1(st["h_op"], oidx) == OP_GET))
        st["c_opn"] = st["c_opn"] + ok
        st["c_wait"] = torch.where(ok, 0, st["c_wait"])
        ctx.set_timer(self.think, T_NEW, [0], when=ok)
        ctx.state = st


def chain_invariant(n_nodes: int, n_replicas: int):
    """At most one replica may simultaneously believe it is a
    lease-holding tail. The replica mask and the verdict's code are built
    once a device (and a width for the code), outside the step: the check
    then makes no tensor from a host value, which a captured CUDA graph
    could not replay."""
    replica = np.zeros(n_nodes, bool)
    replica[1:1 + n_replicas] = True
    consts = {}

    def invariant(state):
        ns = state.node_state
        dev, B = state.now.device, state.now.shape[0]
        if (dev, B) not in consts:
            consts[dev, B] = (
                torch.as_tensor(replica).to(dev),
                torch.full((B,), CRASH_TWO_TAILS, dtype=_I32, device=dev))
        rmask, code = consts[dev, B]
        serving = (rmask & state.alive & (ns["r_pos"] >= 0)
                   & (ns["r_pos"] == ns["r_len"] - 1)
                   & (state.now[:, None] < ns["r_lease"]))
        bad = serving.sum(-1, dtype=_I32) > 1
        return bad, code

    return invariant


def all_done(n_replicas: int, n_ops: int):
    def check(state):
        return (state.node_state["c_opn"][:, 1 + n_replicas:]
                >= n_ops).all(-1)
    return check


def make_chain_runtime(n_replicas=3, n_clients=2, n_ops=10,
                       keys_per_client=2, scenario=None, cfg=None,
                       lease=ms(120), master_wait=None, device=None):
    from ..core.types import NetConfig, SimConfig, sec
    from ..runtime.runtime import Runtime
    n = 1 + n_replicas + n_clients
    n_keys = n_clients * keys_per_client
    if cfg is None:
        cfg = SimConfig(n_nodes=n, event_capacity=384, payload_words=12,
                        time_limit=sec(10),
                        net=NetConfig(send_latency_min=ms(1),
                                      send_latency_max=ms(8)))
    assert cfg.payload_words >= 3 + n_replicas  # BEAT: epoch,len,expiry,chain
    spec = chain_state_spec(n, n_replicas, n_keys, n_ops)
    master = ChainMaster(n_replicas, lease=lease, wait=master_wait)
    replica = ChainReplica(n_replicas, n_keys)
    client = ChainClient(n_replicas, n_ops, keys_per_client)
    node_prog = np.asarray([0] + [1] * n_replicas + [2] * n_clients,
                           np.int32)
    return Runtime(cfg, [master, replica, client], spec,
                   node_prog=node_prog, scenario=scenario,
                   invariant=chain_invariant(n, n_replicas),
                   persist=chain_persist_spec(spec),
                   halt_when=all_done(n_replicas, n_ops), device=device)


def extract_histories(state, n_replicas: int, n_clients: int):
    """Client histories for the linearizability checker: the KV store's
    extraction, the client slice starting after master + replicas."""
    from .raft_kv import extract_histories as _extract
    return _extract(state, 1 + n_replicas, n_clients)
