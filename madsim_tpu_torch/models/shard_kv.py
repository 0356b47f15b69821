"""ShardKV — multi-group Raft with reconfiguration and shard migration (the
counterpart of `madsim_tpu.models.shard_kv`, written for batched
[B, ...] node state).

Cluster layout (node ids):
  [0, RC)                    controller group — CfgRaft (config service)
  [RC + g*RG, RC+(g+1)*RG)   kv group g in [0, G) — ShardServer
  [RC + G*RG, N)             clients — ShardClient

Shards: key k belongs to shard k % S. A configuration is one int32 word
packing GRP_BITS bits of owner group per shard (config 0 = nothing
assigned). Every group processes configurations strictly in sequence.

Migration, all through the groups' Raft logs: the controller leader
self-proposes OP_NEWCFG entries; each kv-group leader polls CFGQ and
proposes OP_CFG, whose apply freezes lost shards into an outgoing buffer
stamped with the config number and marks gained shards not-ready; the
new owner PULLs the frozen image and replicates it through its own log
as OP_INS_KV / OP_INS_SES entries closed by OP_INS_DONE, which flips the
shard ready. Client commands are accepted only for owned AND ready
shards, so there is no dual-serving window.

Safety: per-group Raft invariants (the first bad group's code, as the
reference's reversed `where` chain gives it) after every event, and
client histories checked with the linearizability checker. The packed
assignment word, the `ready` bitmask and the session tags are int32 and
wrap as the reference's do (ROADMAP F2). One-slot writes are `put_row`
at the reference's clipped indices; a (client, shard) cell is one slot
of the row-major [NC * S] flattening.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.api import Ctx, Program
from ..core.types import ms
from ..ops.select import put_row, take1, take_row
from . import raft as R

# log-entry ops
OP_PUT, OP_GET = 1, 2
OP_CFG, OP_INS_KV, OP_INS_SES, OP_INS_DONE, OP_NEWCFG = 3, 4, 5, 6, 7
# message tags (1-4, 9 are raft; 5/6 shared with raft_kv's CMD/CRSP)
CMD, CRSP = 5, 6
CFGQ, CFGR, PULL, PULLR, CWRONG = 11, 12, 13, 14, 15
# timer tags (1-3 raft, 4/5 shared with raft_kv's client)
T_NEW, T_RETRY, T_CFGPOLL = 4, 5, 6

FIELDS = ("op", "key", "val", "client", "rtag")
MAXCFG_BITS = 5          # config numbers pack into 5 bits in OP_INS_SES.rtag
GRP_BITS = 3             # owner group packs into 3 bits per shard

_I32 = torch.int32


def grp_of(asn, s):
    """Owner group of shard `s` (an int or a [B] tensor) under assignment
    word `asn`."""
    return (asn >> (GRP_BITS * s)) & ((1 << GRP_BITS) - 1)


def _bit(ready, s):
    """Bit `s` (an int or a [B] tensor) of the int32 `ready` mask, as a
    bool."""
    return ((ready >> s) & 1) != 0


def _pick(cond, a, b):
    """int32 `where` of two Python ints."""
    return torch.where(cond, a, b).to(_I32)


def _take2(mat, i, j):
    """`mat[i, j]` per lane for mat [B, I, J] and in-range i, j [B]."""
    return take1(mat.reshape(mat.shape[0], -1), i * mat.shape[2] + j)


def _put2(mat, i, j, val, mask):
    """`mat.at[i, j].set(val)` per lane where `mask`, i and j in range."""
    return put_row(mat.reshape(mat.shape[0], -1), i * mat.shape[2] + j,
                   val, mask).reshape(mat.shape)


def _set_row(mat, s: int, val, mask):
    """`mat.at[s].set(where(mask, val, mat[s]))` per lane for a static
    row s of mat [B, S, ...]; val [B, ...]."""
    sel = torch.arange(mat.shape[1], device=mat.device) == s
    m = mask.reshape(mask.shape + (1,) * (mat.ndim - 1)) \
        & sel.reshape((1, -1) + (1,) * (mat.ndim - 2))
    return torch.where(m, val.unsqueeze(1) if val.ndim else val, mat)


def shard_state_spec(n_nodes, log_capacity, *, n_keys, n_shards, n_groups,
                     n_clients, max_cfg, n_ops):
    z = torch.tensor(0, dtype=_I32)
    K, S, NC = n_keys, n_shards, n_clients
    extra = dict(
        # ---- controller state machine (applied; persists) ---------------
        cfg_n=z,
        cfg_hist=torch.zeros((max_cfg + 1,), dtype=_I32),   # [0] = invalid
        # ---- kv-server state machine (applied; persists) ----------------
        kv=torch.zeros((K,), dtype=_I32),
        applied=z,
        my_cfg=z,
        my_asn=z,
        ready=z,                                      # bitmask over shards
        src_grp=torch.full((S,), -1, dtype=_I32),     # pull-from group
        sess_rtag=torch.zeros((NC, S), dtype=_I32),   # per-(client, shard)
        sess_val=torch.zeros((NC, S), dtype=_I32),
        out_num=torch.full((S,), -1, dtype=_I32),     # frozen-at config
        out_kv=torch.zeros((S, K), dtype=_I32),
        out_rtag=torch.zeros((S, NC), dtype=_I32),
        out_val=torch.zeros((S, NC), dtype=_I32),
        # ---- client bookkeeping (volatile) ------------------------------
        cl_cfg=z, cl_asn=z,
        c_target=z, c_id=z, c_op=z, c_key=z, c_val=z, c_opn=z, c_wait=z,
        h_op=torch.zeros((n_ops,), dtype=_I32),
        h_key=torch.zeros((n_ops,), dtype=_I32),
        h_val=torch.zeros((n_ops,), dtype=_I32),
        h_inv=torch.full((n_ops,), -1, dtype=_I32),
        h_resp=torch.full((n_ops,), -1, dtype=_I32),
    )
    return R.state_spec(n_nodes, log_capacity, FIELDS, extra)


def shard_persist_spec():
    keep = ("cfg_n", "cfg_hist", "kv", "applied", "my_cfg", "my_asn",
            "ready", "src_grp", "sess_rtag", "sess_val", "out_num",
            "out_kv", "out_rtag", "out_val")
    vol = ("cl_cfg", "cl_asn", "c_target", "c_id", "c_op", "c_key", "c_val",
           "c_opn", "c_wait", "h_op", "h_key", "h_val", "h_inv", "h_resp")
    mask = R.persist_spec(FIELDS, {k: None for k in keep + vol})
    mask.update({k: True for k in keep})
    mask.update({k: False for k in vol})
    return mask


def _noop_on_become_leader(self, ctx, st, become_leader):
    # current-term no-op entry so a new leader can advance commit over
    # inherited entries (§5.4.2), as RaftKv does
    self._append(ctx, st, become_leader & (st["commit"] < st["log_len"]),
                 {f: 0 for f in FIELDS})


class CfgRaft(R.Raft):
    """The configuration service: a Raft group whose committed log IS the
    sequence of cluster configurations (the shardctrler analog)."""

    ENTRY_FIELDS = FIELDS

    def __init__(self, n_nodes, log_capacity, *, rc, n_groups, n_shards,
                 max_cfg, **kw):
        super().__init__(n_nodes, log_capacity, n_cmds=max_cfg,
                         n_peers=rc, peer_base=0, **kw)
        self.G, self.S, self.maxcfg = n_groups, n_shards, max_cfg

    _on_become_leader = _noop_on_become_leader

    def _can_propose(self, ctx, st):
        # one config in flight at a time, within the APPLIED config budget
        return (st["cfg_n"] < self.maxcfg) & (st["applied"] >= st["log_len"])

    def _propose_fields(self, ctx, st):
        cur = take1(st["cfg_hist"], torch.clamp(st["cfg_n"], 0,
                                                self.maxcfg))
        # config 1: random initial spread; later: move one random shard
        init_asn = torch.zeros_like(cur)
        for s in range(self.S):
            init_asn = init_asn | (ctx.randint(0, self.G - 1)
                                   << (GRP_BITS * s))
        mv_s = ctx.randint(0, self.S - 1)
        mv_g = ctx.randint(0, self.G - 1)
        field = torch.full_like(mv_s, (1 << GRP_BITS) - 1) << (GRP_BITS
                                                               * mv_s)
        moved = (cur & ~field) | (mv_g << (GRP_BITS * mv_s))
        asn = torch.where(st["cfg_n"] == 0, init_asn, moved)
        return dict(op=OP_NEWCFG, key=0, val=asn, client=0, rtag=0)

    def _on_commit_progress(self, ctx: Ctx, st, active):
        # apply committed OP_NEWCFG entries into the config history;
        # entries past the budget apply as no-ops
        for _ in range(2):
            k = st["applied"]
            can = active & (k < st["commit"]) & (k >= st["snap_len"])
            slot = torch.clamp(k - st["snap_len"], 0, self.L - 1)
            is_cfg = (can & (take1(st["log_op"], slot) == OP_NEWCFG)
                      & (st["cfg_n"] < self.maxcfg))
            nxt = torch.clamp(st["cfg_n"] + 1, 0, self.maxcfg)
            st["cfg_hist"] = put_row(st["cfg_hist"], nxt,
                                     take1(st["log_val"], slot), is_cfg)
            st["cfg_n"] = torch.where(is_cfg, nxt, st["cfg_n"])
            st["applied"] = st["applied"] + can

    def _extra_message(self, ctx: Ctx, st, src, tag, payload):
        # CFGQ [want] -> CFGR [num, asn], from the APPLIED history of any
        # controller node
        is_q = tag == CFGQ
        num = torch.clamp(torch.minimum(payload[:, 0], st["cfg_n"]), 0,
                          self.maxcfg)
        ctx.send(src, CFGR, [num, take1(st["cfg_hist"], num)], when=is_q)


class ShardServer(R.Raft):
    """One kv group's Raft peer, serving shard-gated client commands and
    migrating shards by config number (see the module docstring)."""

    ENTRY_FIELDS = FIELDS

    def __init__(self, n_nodes, log_capacity, *, gid, rc, rg, n_groups,
                 n_keys, n_shards, n_clients, max_cfg,
                 cfg_poll=ms(60), apply_per_event=3, **kw):
        super().__init__(n_nodes, log_capacity, n_cmds=0,
                         n_peers=rg, peer_base=rc + gid * rg, **kw)
        self.gid, self.rc, self.rg, self.G = gid, rc, rg, n_groups
        self.K, self.S, self.NC = n_keys, n_shards, n_clients
        self.maxcfg = max_cfg
        self.cfg_poll = cfg_poll
        self.apply_per_event = apply_per_event
        self.clients_base = rc + n_groups * rg
        self.Ks = n_keys // n_shards
        assert n_keys % n_shards == 0, "keys must spread evenly over shards"
        assert max_cfg < (1 << MAXCFG_BITS)
        assert n_groups <= (1 << GRP_BITS)

    _on_become_leader = _noop_on_become_leader

    def _propose_fields(self, ctx, st):
        return {f: 0 for f in FIELDS}   # never self-proposes (n_cmds=0)

    def _owns(self, st, s):
        """Applied-state serving gate for shard s (an int or [B])."""
        return ((st["my_cfg"] >= 1)
                & (grp_of(st["my_asn"], s) == self.gid)
                & _bit(st["ready"], s))

    # -- lifecycle ---------------------------------------------------------
    def init(self, ctx: Ctx):
        super().init(ctx)
        ctx.set_timer(ctx.randint(0, self.cfg_poll), T_CFGPOLL, [0])

    def on_timer(self, ctx: Ctx, tag, payload):
        super().on_timer(ctx, tag, payload)
        st = dict(ctx.state)
        is_poll = tag == T_CFGPOLL
        leader = st["role"] == R.LEADER
        # poll the next config from a random controller node
        ctx.send(ctx.randint(0, self.rc - 1), CFGQ, [st["my_cfg"] + 1],
                 when=is_poll & leader)
        # pull every owned-but-not-ready shard from its previous owner,
        # rotating through the old group's members
        for s in range(self.S):
            src_s = st["src_grp"][:, s]
            need = (is_poll & leader & (st["my_cfg"] >= 1)
                    & (grp_of(st["my_asn"], s) == self.gid)
                    & ~_bit(st["ready"], s) & (src_s >= 0))
            member = (ctx.now // self.cfg_poll + s) % self.rg
            tgt = self.rc + src_s * self.rg + member
            ctx.send(tgt, PULL, [s, st["my_cfg"]], when=need)
        ctx.set_timer(self.cfg_poll, T_CFGPOLL, [0], when=is_poll)
        ctx.state = st

    # -- the apply loop ----------------------------------------------------
    def _on_commit_progress(self, ctx: Ctx, st, active):
        L, K, S, NC = self.L, self.K, self.S, self.NC
        for _ in range(self.apply_per_event):
            k = st["applied"]
            can = active & (k < st["commit"]) & (k >= st["snap_len"])
            slot = torch.clamp(k - st["snap_len"], 0, L - 1)
            op = take1(st["log_op"], slot)
            raw_key = take1(st["log_key"], slot)
            key = torch.clamp(raw_key, 0, K - 1)
            val = take1(st["log_val"], slot)
            client = take1(st["log_client"], slot)
            rtag = take1(st["log_rtag"], slot)
            cid = torch.clamp(client - self.clients_base, 0, NC - 1)
            s_of_key = key % S

            # client PUT/GET — only while the shard is owned AND ready at
            # APPLY time
            is_cli = can & ((op == OP_PUT) | (op == OP_GET))
            valid = is_cli & self._owns(st, s_of_key)
            do_put = valid & (op == OP_PUT)
            st["kv"] = put_row(st["kv"], key, val, do_put)
            result = take1(st["kv"], key)
            st["sess_rtag"] = _put2(st["sess_rtag"], cid, s_of_key, rtag,
                                    valid)
            st["sess_val"] = _put2(st["sess_val"], cid, s_of_key, result,
                                   valid)
            # one reply slot: OK with the result, or wrong-group
            ctx.send(client, _pick(valid, CRSP, CWRONG), [rtag, result],
                     when=is_cli & (st["role"] == R.LEADER))

            # OP_CFG(num=key, asn=val): the migration pivot (key unclipped)
            num = raw_key
            is_cfg = can & (op == OP_CFG) & (num == st["my_cfg"] + 1)
            asn_new = val
            for s in range(S):
                old = ((st["my_cfg"] >= 1)
                       & (grp_of(st["my_asn"], s) == self.gid))
                new = grp_of(asn_new, s) == self.gid
                lost = is_cfg & old & ~new
                gained = is_cfg & new & ~old
                # freeze outgoing shard data at the pivot
                st["out_kv"] = _set_row(st["out_kv"], s, st["kv"], lost)
                st["out_rtag"] = _set_row(st["out_rtag"], s,
                                          st["sess_rtag"][:, :, s], lost)
                st["out_val"] = _set_row(st["out_val"], s,
                                         st["sess_val"][:, :, s], lost)
                st["out_num"] = _set_row(st["out_num"], s, num, lost)
                # gained at config 1 = initial assignment (nothing to pull)
                st["ready"] = torch.where(
                    lost, st["ready"] & ~(1 << s),
                    torch.where(gained & (num == 1), st["ready"] | (1 << s),
                                torch.where(gained, st["ready"] & ~(1 << s),
                                            st["ready"])))
                st["src_grp"] = _set_row(st["src_grp"], s,
                                         grp_of(st["my_asn"], s),
                                         gained & (num > 1))
            st["my_cfg"] = torch.where(is_cfg, num, st["my_cfg"])
            st["my_asn"] = torch.where(is_cfg, asn_new, st["my_asn"])

            # OP_INS_* — install a pulled shard image, fenced by (s, num)
            ins_s = torch.clamp(raw_key, 0, S - 1)        # SES/DONE key
            not_ready = ~_bit(st["ready"], ins_s)
            ins_mine = grp_of(st["my_asn"], ins_s) == self.gid
            is_ikv = (can & (op == OP_INS_KV) & (rtag == st["my_cfg"])
                      & ~_bit(st["ready"], s_of_key)
                      & (grp_of(st["my_asn"], s_of_key) == self.gid))
            st["kv"] = put_row(st["kv"], key, val, is_ikv)
            is_ses = (can & (op == OP_INS_SES)
                      & ((rtag & ((1 << MAXCFG_BITS) - 1)) == st["my_cfg"])
                      & not_ready & ins_mine)
            st["sess_rtag"] = _put2(st["sess_rtag"], cid, ins_s,
                                    rtag >> MAXCFG_BITS, is_ses)
            st["sess_val"] = _put2(st["sess_val"], cid, ins_s, val, is_ses)
            is_done = (can & (op == OP_INS_DONE) & (rtag == st["my_cfg"])
                       & not_ready & ins_mine)
            st["ready"] = torch.where(
                is_done, st["ready"] | (torch.ones_like(ins_s) << ins_s),
                st["ready"])

            st["applied"] = st["applied"] + can

    # -- messages ----------------------------------------------------------
    def _extra_message(self, ctx: Ctx, st, src, tag, payload):
        L, S, NC, Ks = self.L, self.S, self.NC, self.Ks
        leader = st["role"] == R.LEADER
        live = (st["log_len"] - st["snap_len"])[:, None]
        ks = torch.arange(L, dtype=_I32, device=tag.device)
        in_live = ks < live

        # ---- CFGR [num, asn]: advance to the next config ----------------
        is_cfgr = tag == CFGR
        num, asn = payload[:, 0], payload[:, 1]
        owned_all_ready = torch.ones_like(is_cfgr)
        for s in range(S):
            owned = ((st["my_cfg"] >= 1)
                     & (grp_of(st["my_asn"], s) == self.gid))
            owned_all_ready = owned_all_ready & (~owned
                                                 | _bit(st["ready"], s))
        cfg_pending = ((st["log_op"] == OP_CFG)
                       & (st["log_key"] == num[:, None]) & in_live).any(-1)
        adv = (is_cfgr & leader & (num == st["my_cfg"] + 1)
               & owned_all_ready & ~cfg_pending)
        self._append(ctx, st, adv, dict(op=OP_CFG, key=num, val=asn,
                                        client=0, rtag=0))

        # ---- CMD [rtag, op, key, val] from a client ---------------------
        is_cmd = tag == CMD
        rtag, cop = payload[:, 0], payload[:, 1]
        ckey = torch.clamp(payload[:, 2], 0, self.K - 1)
        cval = payload[:, 3]
        s_of = ckey % S
        cid = torch.clamp(src - self.clients_base, 0, NC - 1)
        owns = self._owns(st, s_of)
        sess = _take2(st["sess_rtag"], cid, s_of)
        sess_hit = sess == rtag
        stale = rtag < sess
        # in-flight dedup covers UNAPPLIED client entries only
        unapplied = ks >= (st["applied"] - st["snap_len"])[:, None]
        is_cli_op = (st["log_op"] == OP_PUT) | (st["log_op"] == OP_GET)
        pending = ((st["log_rtag"] == rtag[:, None])
                   & (st["log_client"] == src[:, None])
                   & is_cli_op & in_live & unapplied).any(-1)
        self._append(ctx, st,
                     is_cmd & leader & owns & ~sess_hit & ~stale & ~pending,
                     dict(op=cop, key=ckey, val=cval, client=src, rtag=rtag))
        # dedup hit answers from the session; wrong-group redirects — one
        # shared reply slot, mutually exclusive conditions
        hit = is_cmd & leader & owns & sess_hit
        wrong = is_cmd & leader & ~owns
        ctx.send(src, _pick(wrong, CWRONG, CRSP),
                 [rtag, _take2(st["sess_val"], cid, s_of)],
                 when=hit | wrong)

        # ---- PULL [s, num]: hand a frozen shard image out ---------------
        is_pull = tag == PULL
        ps = torch.clamp(payload[:, 0], 0, S - 1)
        pnum = payload[:, 1]
        have = is_pull & (take1(st["out_num"], ps) == pnum)
        okv = take_row(st["out_kv"], ps)          # [B, K]
        kvals = [take1(okv, ps + p * S) for p in range(Ks)]
        ortag = take_row(st["out_rtag"], ps)      # [B, NC]
        oval = take_row(st["out_val"], ps)
        ctx.send(src, PULLR,
                 [ps, pnum] + kvals + list(ortag.unbind(-1))
                 + list(oval.unbind(-1)), when=have)

        # ---- PULLR: replicate the image through our own log -------------
        is_pr = tag == PULLR
        rs = torch.clamp(payload[:, 0], 0, S - 1)
        rnum = payload[:, 1]
        ins_pending = ((st["log_op"] == OP_INS_DONE)
                       & (st["log_key"] == rs[:, None])
                       & (st["log_rtag"] == rnum[:, None]) & in_live).any(-1)
        take = (is_pr & leader & (rnum == st["my_cfg"])
                & (grp_of(st["my_asn"], rs) == self.gid)
                & ~_bit(st["ready"], rs) & ~ins_pending)
        for p in range(Ks):
            self._append(ctx, st, take, dict(
                op=OP_INS_KV, key=rs + p * S, val=payload[:, 2 + p],
                client=0, rtag=rnum))
        for c in range(NC):
            self._append(ctx, st, take, dict(
                op=OP_INS_SES, key=rs, val=payload[:, 2 + Ks + NC + c],
                client=self.clients_base + c,
                rtag=(payload[:, 2 + Ks + c] << MAXCFG_BITS) | rnum))
        self._append(ctx, st, take, dict(op=OP_INS_DONE, key=rs, val=0,
                                         client=0, rtag=rnum))


class ShardClient(Program):
    """Closed-loop client routing by its cached configuration; refreshes
    the config on wrong-group replies and timeouts, then retries the SAME
    call id."""

    def __init__(self, *, rc, rg, n_groups, n_shards, n_keys, n_ops,
                 max_cfg, timeout=ms(80), think=ms(10)):
        self.rc, self.rg, self.G = rc, rg, n_groups
        self.S, self.K, self.O = n_shards, n_keys, n_ops
        self.maxcfg = max_cfg
        self.timeout, self.think = timeout, think

    def _refresh(self, ctx, when):
        ctx.send(ctx.randint(0, self.rc - 1), CFGQ, [self.maxcfg],
                 when=when)

    def _issue(self, ctx, st, when):
        g = grp_of(st["cl_asn"], st["c_key"] % self.S)
        st["c_target"] = torch.where(
            when, self.rc + g * self.rg + ctx.randint(0, self.rg - 1),
            st["c_target"])
        ctx.send(st["c_target"], CMD,
                 [st["c_id"], st["c_op"], st["c_key"], st["c_val"]],
                 when=when)
        ctx.set_timer(self.timeout, T_RETRY, [st["c_id"]], when=when)

    def init(self, ctx: Ctx):
        self._refresh(ctx, True)
        ctx.set_timer(ctx.randint(ms(5), ms(30)), T_NEW, [0])

    def on_timer(self, ctx: Ctx, tag, payload):
        st = dict(ctx.state)
        routed = st["cl_cfg"] >= 1
        is_new = tag == T_NEW
        start = (is_new & (st["c_wait"] == 0) & (st["c_opn"] < self.O)
                 & routed)
        # no config yet: ask again and come back
        self._refresh(ctx, is_new & ~routed)
        ctx.set_timer(self.think, T_NEW, [0], when=is_new & ~routed)

        st["c_id"] = torch.where(start, st["c_opn"] + 1, st["c_id"])
        st["c_op"] = torch.where(
            start, _pick(ctx.bernoulli(0.5), OP_PUT, OP_GET), st["c_op"])
        st["c_key"] = torch.where(start, ctx.randint(0, self.K - 1),
                                  st["c_key"])
        st["c_val"] = torch.where(start, ctx.node * 4096 + st["c_opn"],
                                  st["c_val"])
        st["c_wait"] = torch.where(start, 1, st["c_wait"])
        oidx = torch.clamp(st["c_opn"], 0, self.O - 1)
        for h, v in (("h_op", st["c_op"]), ("h_key", st["c_key"]),
                     ("h_val", st["c_val"]), ("h_inv", ctx.now)):
            st[h] = put_row(st[h], oidx, v, start)

        # timeout: refresh the config (the shard may have moved) and retry
        retry = ((tag == T_RETRY) & (st["c_wait"] == 1)
                 & (payload[:, 0] == st["c_id"]))
        self._refresh(ctx, retry)
        self._issue(ctx, st, start | retry)
        ctx.state = st

    def on_message(self, ctx: Ctx, src, tag, payload):
        st = dict(ctx.state)
        # config updates
        newer = (tag == CFGR) & (payload[:, 0] > st["cl_cfg"])
        st["cl_cfg"] = torch.where(newer, payload[:, 0], st["cl_cfg"])
        st["cl_asn"] = torch.where(newer, payload[:, 1], st["cl_asn"])

        hit = ((tag == CRSP) & (st["c_wait"] == 1)
               & (payload[:, 0] == st["c_id"]))
        oidx = torch.clamp(st["c_opn"], 0, self.O - 1)
        st["h_resp"] = put_row(st["h_resp"], oidx, ctx.now, hit)
        st["h_val"] = put_row(st["h_val"], oidx, payload[:, 1],
                              hit & (take1(st["h_op"], oidx) == OP_GET))
        st["c_opn"] = st["c_opn"] + hit
        st["c_wait"] = torch.where(hit, 0, st["c_wait"])
        ctx.set_timer(self.think, T_NEW, [0], when=hit)

        # wrong group: our config is stale — refresh now; the armed retry
        # timer re-issues with the updated routing
        wrong = ((tag == CWRONG) & (st["c_wait"] == 1)
                 & (payload[:, 0] == st["c_id"]))
        self._refresh(ctx, wrong)
        ctx.state = st


def compose_invariants(*invs):
    """OR a set of per-group invariants into one (bad, code) check; the
    code is the FIRST bad invariant's, as the reference's reversed
    `where` chain gives it."""
    def inv(state):
        bads, codes = [], []
        for f in invs:
            b, c = f(state)
            bads.append(b)
            codes.append(c)
        bad = torch.stack(bads).any(0)
        code = torch.zeros_like(codes[0])
        for b, c in zip(reversed(bads), reversed(codes)):
            code = torch.where(b, c, code)
        return bad, code
    return inv


def all_clients_done(clients_base: int, n_ops: int):
    def check(state):
        return (state.node_state["c_opn"][:, clients_base:]
                >= n_ops).all(-1)
    return check


def make_shard_runtime(n_groups=2, rg=3, rc=3, n_clients=2, n_keys=8,
                       n_shards=4, n_ops=6, max_cfg=4, log_capacity=64,
                       scenario=None, cfg=None, extra_invariant=None,
                       device=None, **kw):
    """Assemble the full sharded-KV cluster runtime. `extra_invariant`
    composes an additional (bad, code) check after the per-group Raft
    invariants."""
    from ..core.types import NetConfig, SimConfig, sec
    from ..runtime.runtime import Runtime
    n = rc + n_groups * rg + n_clients
    if cfg is None:
        cfg = SimConfig(n_nodes=n, event_capacity=160, payload_words=12,
                        time_limit=sec(30),
                        net=NetConfig(send_latency_min=ms(1),
                                      send_latency_max=ms(10)))
    assert cfg.payload_words >= 2 + n_keys // n_shards + 2 * n_clients, \
        "PULLR must fit one payload (chunk bigger shards over net/streaming)"
    common = dict(n_keys=n_keys, n_shards=n_shards, n_clients=n_clients,
                  max_cfg=max_cfg)
    progs = [CfgRaft(n, log_capacity, rc=rc, n_groups=n_groups,
                     n_shards=n_shards, max_cfg=max_cfg, **kw)]
    for g in range(n_groups):
        progs.append(ShardServer(n, log_capacity, gid=g, rc=rc, rg=rg,
                                 n_groups=n_groups, **common, **kw))
    progs.append(ShardClient(rc=rc, rg=rg, n_groups=n_groups,
                             n_shards=n_shards, n_keys=n_keys, n_ops=n_ops,
                             max_cfg=max_cfg))
    node_prog = np.asarray([0] * rc
                           + sum(([1 + g] * rg for g in range(n_groups)), [])
                           + [1 + n_groups] * n_clients, np.int32)
    masks = [np.arange(n) < rc]
    for g in range(n_groups):
        base = rc + g * rg
        masks.append((np.arange(n) >= base) & (np.arange(n) < base + rg))
    inv = compose_invariants(
        *([R.raft_invariant(n, log_capacity, FIELDS, m,
                            window_slides=R.window_slides_for(kw))
           for m in masks]
          + ([extra_invariant] if extra_invariant is not None else [])))
    clients_base = rc + n_groups * rg
    return Runtime(cfg, progs,
                   shard_state_spec(n, log_capacity, n_groups=n_groups,
                                    n_ops=n_ops, **common),
                   node_prog=node_prog, scenario=scenario, invariant=inv,
                   persist=shard_persist_spec(),
                   halt_when=all_clients_done(clients_base, n_ops),
                   device=device)


def extract_histories(state, clients_base: int, n_clients: int):
    """Per-trajectory client histories (the layout of raft_kv's)."""
    from .raft_kv import extract_histories as _extract
    return _extract(state, clients_base, n_clients)
