"""Durable KV server with a write-ahead log on the simulated filesystem
(the counterpart of `madsim_tpu.models.wal_kv`): the workload that makes
fs.py's power-fail semantics falsifiable.

Protocol (the classic WAL + checkpoint design):
  PUT: append (key, val) to the WAL file, `sync_all`, apply to the
       in-memory table, ack. The ack therefore PROMISES durability.
  WAL full: checkpoint — write the whole table to the DB file, sync it,
       truncate the WAL (set_len 0 + sync).
  Recovery (init after kill): mount(), load the table from the DB file,
       replay the WAL on top.

Clients own disjoint key ranges and write strictly increasing values, so
"a synced ack can never be un-written" is a per-key monotonicity oracle:
a GET observing a value below the last acked PUT for that key crashes the
lane with CRASH_LOST_WRITE. `sync_wal=False` removes the sync between
append and ack, and with kill chaos the oracle must then fire.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import fs
from ..core.api import Ctx, Program
from ..core.types import ms
from ..ops.select import put_row, take1

WAL, DB = 0, 1
M_PUT, M_GET, M_ACK = 1, 2, 3
T_NEW, T_RETRY = 1, 2

CRASH_LOST_WRITE = 301

SERVER = 0

_I32 = torch.int32


def wal_state_spec(n_nodes: int, n_keys: int, wal_cap: int, keys_per_client):
    z = torch.tensor(0, dtype=_I32)
    file_words = max(2 * wal_cap, n_keys)
    return dict(
        **fs.fs_state(2, file_words),
        kv=torch.zeros((n_keys,), dtype=_I32),
        wal_n=z,
        # per-client dedup: call ids are monotonic (op index + 1), so a
        # delayed duplicate of an older PUT is acked but never re-applied
        last_cid=torch.zeros((n_nodes,), dtype=_I32),
        # client side
        c_cid=z, c_opn=z, c_wait=z, c_key=z, c_val=z, c_op=z, c_done=z,
        acked=torch.zeros((keys_per_client,), dtype=_I32),
    )


def wal_persist_spec():
    """ONLY the fs disk view persists — kv/wal_n are process memory and
    die with the process."""
    vol = dict(kv=False, wal_n=False, last_cid=False, c_cid=False,
               c_opn=False, c_wait=False, c_key=False, c_val=False,
               c_op=False, c_done=False, acked=False)
    return dict(fs.fs_persist(), **vol)


class WalKvServer(Program):
    def __init__(self, n_keys: int, wal_cap: int, sync_wal: bool = True):
        self.K = n_keys
        self.W = wal_cap
        self.sync_wal = sync_wal

    def init(self, ctx: Ctx):
        st = dict(ctx.state)
        # recovery: mount the disk, load the last checkpoint, replay the WAL
        fs.mount(st)
        db = fs.read_at(st, DB, 0, self.K)
        have_db = fs.file_len(st, DB) >= self.K
        st["kv"] = torch.where(have_db[:, None], db,
                               torch.zeros_like(st["kv"]))
        recs = fs.read_at(st, WAL, 0, 2 * self.W)
        keys, vals = recs[:, 0::2], recs[:, 1::2]
        nrec = fs.file_len(st, WAL) // 2
        ridx = torch.arange(self.W, dtype=_I32, device=recs.device)
        for k in range(self.K):
            m = (keys == k) & (ridx < nrec[:, None])
            last = torch.where(m, ridx + 1, torch.zeros_like(keys)).amax(-1)
            kv = st["kv"].clone()
            kv[:, k] = torch.where(
                last > 0, take1(vals, torch.clamp(last - 1, 0, self.W - 1)),
                kv[:, k])
            st["kv"] = kv
        st["wal_n"] = nrec
        ctx.state = st

    def on_message(self, ctx: Ctx, src, tag, payload):
        st = dict(ctx.state)
        cid, key, val = payload[:, 0], payload[:, 1], payload[:, 2]
        kc = torch.clamp(key, 0, self.K - 1)
        is_put = tag == M_PUT
        is_get = tag == M_GET

        # WAL full -> checkpoint: table to DB (synced), truncate WAL
        ckpt = is_put & (st["wal_n"] >= self.W)
        fs.write_all_at(st, DB, 0, st["kv"], when=ckpt)
        fs.sync_all(st, DB, when=ckpt)
        fs.set_len(st, WAL, 0, when=ckpt)
        fs.sync_all(st, WAL, when=ckpt)
        st["wal_n"] = torch.where(ckpt, torch.zeros_like(st["wal_n"]),
                                  st["wal_n"])

        # append + sync + apply + ack (the ack promises durability — only
        # TRUE if sync_wal actually runs). Only FRESH puts apply:
        # duplicates and stale retries are acked without touching state.
        fresh = is_put & (cid > take1(st["last_cid"], src))
        ok = fs.write_all_at(st, WAL, 2 * st["wal_n"],
                             torch.stack([kc, val], -1), when=fresh)
        if self.sync_wal:
            fs.sync_all(st, WAL, when=ok)
        st["wal_n"] = st["wal_n"] + ok
        st["kv"] = put_row(st["kv"], kc, val, ok)
        st["last_cid"] = put_row(st["last_cid"], src, cid, ok)

        reply = torch.where(is_get, take1(st["kv"], kc), val)
        ctx.send(src, M_ACK, [cid, reply, key], when=is_put | is_get)
        ctx.state = st


class WalKvClient(Program):
    """Alternates PUT(key, increasing val) and verifying GET(key) over its
    own key range; retries on timeout. The GET oracle: a response below
    the last acked PUT for that key means a synced write was lost."""

    def __init__(self, n_ops: int, keys_per_client: int,
                 timeout=ms(60), think=ms(8)):
        self.O = n_ops
        self.KPC = keys_per_client
        self.timeout = timeout
        self.think = think

    def _key_local(self, st):
        return (st["c_opn"] // 2) % self.KPC

    def init(self, ctx: Ctx):
        st = dict(ctx.state)
        ctx.set_timer(ctx.randint(0, ms(20)), T_NEW, [0])
        ctx.state = st

    def _issue(self, ctx, st, when):
        key = (ctx.node - 1) * self.KPC + self._key_local(st)
        op = torch.where(st["c_op"] == M_PUT,
                         torch.full_like(st["c_op"], M_PUT),
                         torch.full_like(st["c_op"], M_GET))
        ctx.send(SERVER, op, [st["c_cid"], key, st["c_val"]], when=when)
        ctx.set_timer(self.timeout, T_RETRY, [st["c_cid"]], when=when)

    def on_timer(self, ctx: Ctx, tag, payload):
        st = dict(ctx.state)
        start = ((tag == T_NEW) & (st["c_wait"] == 0)
                 & (st["c_opn"] < self.O))
        # even ops PUT a fresh (strictly increasing) value, odd ops GET it
        put_get = torch.where(st["c_opn"] % 2 == 0,
                              torch.full_like(st["c_opn"], M_PUT),
                              torch.full_like(st["c_opn"], M_GET))
        st["c_op"] = torch.where(start, put_get, st["c_op"])
        # monotonic call ids (op index + 1): the server's dedup can order
        # retries
        st["c_cid"] = torch.where(start, st["c_opn"] + 1, st["c_cid"])
        st["c_val"] = torch.where(start & (st["c_op"] == M_PUT),
                                  st["c_opn"] + 1, st["c_val"])
        st["c_wait"] = torch.where(start, torch.ones_like(st["c_wait"]),
                                   st["c_wait"])
        retry = ((tag == T_RETRY) & (st["c_wait"] == 1)
                 & (payload[:, 0] == st["c_cid"]))
        self._issue(ctx, st, start | retry)
        ctx.state = st

    def on_message(self, ctx: Ctx, src, tag, payload):
        st = dict(ctx.state)
        hit = ((tag == M_ACK) & (st["c_wait"] == 1)
               & (payload[:, 0] == st["c_cid"]))
        kl = torch.clamp(self._key_local(st), 0, self.KPC - 1)
        acked = take1(st["acked"], kl)
        # durability oracle: GET must observe >= the last acked PUT
        ctx.crash_if(hit & (st["c_op"] == M_GET) & (payload[:, 1] < acked),
                     CRASH_LOST_WRITE)
        st["acked"] = put_row(st["acked"], kl,
                              torch.maximum(acked, st["c_val"]),
                              hit & (st["c_op"] == M_PUT))
        st["c_opn"] = st["c_opn"] + hit
        st["c_wait"] = torch.where(hit, torch.zeros_like(st["c_wait"]),
                                   st["c_wait"])
        st["c_done"] = torch.where(st["c_opn"] >= self.O,
                                   torch.ones_like(st["c_done"]),
                                   st["c_done"])
        ctx.set_timer(self.think, T_NEW, [0], when=hit)
        ctx.state = st


def clients_done(n_nodes: int):
    def check(state):
        return (state.node_state["c_done"][:, 1:n_nodes] == 1).all(-1)
    return check


def make_wal_kv_runtime(n_clients=2, n_ops=12, keys_per_client=2,
                        wal_cap=8, sync_wal=True, scenario=None, cfg=None,
                        device=None):
    from ..core.types import NetConfig, SimConfig, sec
    from ..runtime.runtime import Runtime
    n = 1 + n_clients
    n_keys = n_clients * keys_per_client
    if cfg is None:
        cfg = SimConfig(n_nodes=n, event_capacity=256, payload_words=8,
                        time_limit=sec(10),
                        net=NetConfig(send_latency_min=ms(1),
                                      send_latency_max=ms(8)))
    server = WalKvServer(n_keys, wal_cap, sync_wal=sync_wal)
    client = WalKvClient(n_ops, keys_per_client)
    node_prog = np.asarray([0] + [1] * n_clients, np.int32)
    return Runtime(cfg, [server, client],
                   wal_state_spec(n, n_keys, wal_cap, keys_per_client),
                   node_prog=node_prog, scenario=scenario,
                   persist=wal_persist_spec(),
                   halt_when=clients_done(n), device=device)
