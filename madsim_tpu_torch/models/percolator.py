"""Percolator-lite transactions (the counterpart of
`madsim_tpu.models.percolator`, written for batched [B, ...] node state).

A two-shard transactional KV with Percolator's shape (primary/secondary
locks, snapshot reads, lazy commit of secondaries, TTL-based lock
cleanup) and two LITE simplifications that make its snapshot-isolation
invariant exactly what asymmetric partitions, skewed clocks and slow
disks violate:

  1. Timestamps come from each node's LOCAL clock (`ctx.now`), not a
     timestamp oracle.
  2. Lock cleanup never consults the primary: a reader that finds a lock
     older than `ttl` (by the SERVER's clock) rolls it back in place, so a
     committed-primary transaction whose secondary commit was delayed or
     dropped loses its secondary write (a fractured write).

The oracle is total conservation under snapshot reads: a client audit
reads ALL keys at one timestamp and crashes the lane (CRASH_SNAPSHOT) if
the balances do not sum to the initial total.

Durability: committed writes append to a WAL on the simulated fs
(`fs.py`), synced per commit when `sync_commits=True`; lock state is
process memory and dies with the server. A booting server replays the
WAL (`PercServer.init`). One-slot writes are `put_row` at the
reference's clipped key; bit masks stay int32 (ROADMAP F2).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import fs
from ..core.api import Ctx, Program
from ..core.types import ms
from ..ops.select import put_row, take1

# message tags
M_READ, M_READ_ACK = 1, 2
M_PREWRITE, M_PW_ACK = 3, 4
M_COMMIT, M_CM_ACK = 5, 6
M_ROLLBACK = 7
# timer tags
T_NEW, T_TO = 1, 2
# read statuses
R_OK, R_LOCKED, R_RETRY = 0, 1, 2
# client phases
PH_IDLE, PH_READ, PH_PREWRITE, PH_COMMIT, PH_AUDIT = 0, 1, 2, 3, 4

CRASH_SNAPSHOT = 501     # snapshot audit saw a fractured total

N_SERVERS = 2            # shards; server_of(key) = key % 2
LOG = 0                  # the commit WAL's fs file id
INIT_BAL = 100

_I32 = torch.int32


def server_of(key):
    return key % N_SERVERS


def perc_state_spec(n_keys: int, log_cap: int):
    z = torch.tensor(0, dtype=_I32)
    K = n_keys
    return dict(
        **fs.fs_state(1, 3 * log_cap),
        # server: lock column (volatile)
        lock_ts=torch.zeros((K,), dtype=_I32),        # 0 = unlocked
        lock_primary=torch.zeros((K,), dtype=_I32),
        lock_data=torch.zeros((K,), dtype=_I32),
        lock_wall=torch.zeros((K,), dtype=_I32),      # LOCAL time when placed
        # server: two retained versions per key (newest + previous)
        write_ts=torch.zeros((K,), dtype=_I32),
        write_val=torch.full((K,), INIT_BAL, dtype=_I32),
        prev_ts=torch.zeros((K,), dtype=_I32),
        prev_val=torch.full((K,), INIT_BAL, dtype=_I32),
        log_n=z,
        # client txn driver
        c_phase=z, c_ts=z, c_cts=z, c_k1=z, c_k2=z, c_amt=z,
        c_v1=z, c_v2=z, c_got=z, c_pw=z,
        a_got=z, a_sum=z,
        c_opn=z, c_done=z,
    )


def perc_persist_spec():
    """Only the fs disk view survives kill/restart: the commit WAL is the
    server's sole stable storage."""
    vol = dict(lock_ts=False, lock_primary=False, lock_data=False,
               lock_wall=False, write_ts=False, write_val=False,
               prev_ts=False, prev_val=False, log_n=False,
               c_phase=False, c_ts=False, c_cts=False, c_k1=False,
               c_k2=False, c_amt=False, c_v1=False, c_v2=False,
               c_got=False, c_pw=False, a_got=False, a_sum=False,
               c_opn=False, c_done=False)
    return dict(fs.fs_persist(), **vol)


class PercServer(Program):
    def __init__(self, n_keys: int, log_cap: int, ttl=ms(80),
                 sync_commits: bool = True):
        self.K = n_keys
        self.W = log_cap
        self.ttl = ttl
        self.sync_commits = sync_commits

    def init(self, ctx: Ctx):
        st = dict(ctx.state)
        # recovery: mount the disk and replay the commit WAL in append
        # order. The reference folds the W records one by one; per key
        # that leaves the last record as the current version and the one
        # before it (or, with a single record, the version it replaced)
        # as the previous one, which is what is computed here at once.
        fs.mount(st)
        nrec = fs.file_len(st, LOG) // 3
        W, K = self.W, self.K
        rec = fs.read_at(st, LOG, 0, 3 * W).reshape(-1, W, 3)
        dev = nrec.device
        iw = torch.arange(W, dtype=_I32, device=dev)
        kid = torch.arange(K, dtype=_I32, device=dev)
        ok = iw < nrec[:, None]                                   # [B, W]
        hit = ((torch.clamp(rec[:, :, 0], 0, K - 1)[:, :, None] == kid)
               & ok[:, :, None])                                  # [B, W, K]
        pos = torch.where(hit, iw[:, None], -1)
        last = pos.max(1).values                                  # [B, K]
        second = torch.where(pos < last[:, None, :], pos, -1).max(1).values
        ts, val = rec[:, :, 1], rec[:, :, 2]
        one = last >= 0
        two = second >= 0
        li = torch.clamp(last, min=0).to(torch.int64)
        si = torch.clamp(second, min=0).to(torch.int64)
        last_ts, last_val = ts.gather(1, li), val.gather(1, li)
        sec_ts, sec_val = ts.gather(1, si), val.gather(1, si)
        st["prev_ts"] = torch.where(two, sec_ts, torch.where(
            one, st["write_ts"], st["prev_ts"]))
        st["prev_val"] = torch.where(two, sec_val, torch.where(
            one, st["write_val"], st["prev_val"]))
        st["write_ts"] = torch.where(one, last_ts, st["write_ts"])
        st["write_val"] = torch.where(one, last_val, st["write_val"])
        st["log_n"] = nrec
        ctx.state = st

    def on_message(self, ctx: Ctx, src, tag, payload):
        st = dict(ctx.state)
        K = self.K
        local_now = ctx.now                       # the SKEWED clock

        # ---- PREWRITE [start_ts, key, val, primary] ---------------------
        is_pw = tag == M_PREWRITE
        ts, key, val, primary = (payload[:, 0], payload[:, 1],
                                 payload[:, 2], payload[:, 3])
        kc = torch.clamp(key, 0, K - 1)
        lock_k = take1(st["lock_ts"], kc)
        held_other = (lock_k != 0) & (lock_k != ts)
        # conflict: any retained commit at/after start_ts
        conflict = take1(st["write_ts"], kc) >= ts
        pw_ok = is_pw & ~held_other & ~conflict
        fresh = pw_ok & (lock_k == 0)
        st["lock_ts"] = put_row(st["lock_ts"], kc, ts, fresh)
        st["lock_primary"] = put_row(st["lock_primary"], kc, primary, fresh)
        st["lock_data"] = put_row(st["lock_data"], kc, val, fresh)
        st["lock_wall"] = put_row(st["lock_wall"], kc, local_now, fresh)
        ctx.send(src, M_PW_ACK, [ts, key, pw_ok.to(_I32)], when=is_pw)

        # ---- COMMIT [start_ts, commit_ts, key] --------------------------
        is_cm = tag == M_COMMIT
        cts = payload[:, 1]
        ck = torch.clamp(torch.where(is_cm, payload[:, 2], 0), 0, K - 1)
        held = is_cm & (take1(st["lock_ts"], ck) == ts)
        # promote: prev <- cur, cur <- (commit_ts, locked data)
        st["prev_ts"] = put_row(st["prev_ts"], ck,
                                take1(st["write_ts"], ck), held)
        st["prev_val"] = put_row(st["prev_val"], ck,
                                 take1(st["write_val"], ck), held)
        st["write_ts"] = put_row(st["write_ts"], ck, cts, held)
        st["write_val"] = put_row(st["write_val"], ck,
                                  take1(st["lock_data"], ck), held)
        st["lock_ts"] = put_row(st["lock_ts"], ck, 0, held)
        # durable commit record (key, commit_ts, val); sync per commit
        # unless running the group-commit crash-rich configuration
        wrote = fs.write_all_at(
            st, LOG, 3 * st["log_n"],
            torch.stack([ck, cts, take1(st["write_val"], ck)], -1),
            when=held)
        if self.sync_commits:
            fs.sync_all(st, LOG, when=wrote)
        st["log_n"] = st["log_n"] + wrote
        cm_ok = held | (is_cm & (take1(st["write_ts"], ck) == cts))
        ctx.send(src, M_CM_ACK, [ts, payload[:, 2], cm_ok.to(_I32)],
                 when=is_cm)

        # ---- ROLLBACK [start_ts, key] -----------------------------------
        is_rb = tag == M_ROLLBACK
        rk = torch.clamp(torch.where(is_rb, payload[:, 1], 0), 0, K - 1)
        undo = is_rb & (take1(st["lock_ts"], rk) == ts)
        st["lock_ts"] = put_row(st["lock_ts"], rk, 0, undo)

        # ---- READ [ts, key] ---------------------------------------------
        is_rd = tag == M_READ
        rts = payload[:, 0]
        dk = torch.clamp(torch.where(is_rd, payload[:, 1], 0), 0, K - 1)
        lock_d = take1(st["lock_ts"], dk)
        blocked = is_rd & (lock_d != 0) & (lock_d <= rts)
        # THE LITE HOLE: an expired lock (by this server's clock) is rolled
        # back in place, no primary consult
        expired = blocked & (local_now - take1(st["lock_wall"], dk)
                             > self.ttl)
        st["lock_ts"] = put_row(st["lock_ts"], dk, 0, expired)
        blocked = blocked & ~expired
        cur_vis = take1(st["write_ts"], dk) <= rts
        prev_vis = take1(st["prev_ts"], dk) <= rts
        status = torch.where(
            blocked, R_LOCKED,
            torch.where(cur_vis | prev_vis, R_OK, R_RETRY)).to(_I32)
        rval = torch.where(cur_vis, take1(st["write_val"], dk),
                           take1(st["prev_val"], dk))
        ctx.send(src, M_READ_ACK, [rts, payload[:, 1], status, rval],
                 when=is_rd)
        ctx.state = st


class PercClient(Program):
    """Alternates transfer transactions (move `amt` between two random
    keys through the 2PC lock protocol) with snapshot AUDITS (read every
    key at one timestamp; the balance total is the SI oracle)."""

    def __init__(self, n_keys: int, n_ops: int, timeout=ms(60),
                 think=ms(10)):
        self.K = n_keys
        self.O = n_ops
        self.timeout = timeout
        self.think = think
        self.total = n_keys * INIT_BAL
        self.full = (1 << n_keys) - 1      # every key's audit bit

    def init(self, ctx: Ctx):
        ctx.set_timer(ctx.randint(0, ms(20)), T_NEW, [0])

    # -- txn driver --------------------------------------------------------
    def on_timer(self, ctx: Ctx, tag, payload):
        st = dict(ctx.state)
        K = self.K
        start = ((tag == T_NEW) & (st["c_phase"] == PH_IDLE)
                 & (st["c_opn"] < self.O))
        # timestamps are LOCAL — the lite design choice skew attacks
        ts = ctx.now + 1
        audit = start & (st["c_opn"] % 3 == 2)
        xfer = start & ~audit
        k1 = ctx.randint(0, K - 1)
        k2 = torch.remainder(k1 + 1 + ctx.randint(0, K - 2), K)  # distinct
        st["c_ts"] = torch.where(start, ts, st["c_ts"])
        st["c_k1"] = torch.where(xfer, k1, st["c_k1"])
        st["c_k2"] = torch.where(xfer, k2, st["c_k2"])
        st["c_amt"] = torch.where(xfer, 1 + ctx.randint(0, 2), st["c_amt"])
        for k in ("c_got", "c_pw", "a_got", "a_sum"):
            st[k] = torch.where(start, 0, st[k])
        st["c_phase"] = torch.where(
            xfer, PH_READ, torch.where(audit, PH_AUDIT, st["c_phase"]))
        ctx.send(server_of(k1), M_READ, [ts, k1], when=xfer)
        ctx.send(server_of(k2), M_READ, [ts, k2], when=xfer)
        for k in range(K):
            ctx.send(server_of(k), M_READ, [ts, k], when=audit)
        ctx.set_timer(self.timeout, T_TO, [ts], when=start)

        # timeout: abort whatever is in flight (best-effort rollbacks)
        to = ((tag == T_TO) & (st["c_phase"] != PH_IDLE)
              & (payload[:, 0] == st["c_ts"]))
        undoing = to & ((st["c_phase"] == PH_PREWRITE)
                        | (st["c_phase"] == PH_COMMIT))
        ctx.send(server_of(st["c_k1"]), M_ROLLBACK,
                 [st["c_ts"], st["c_k1"]], when=undoing)
        ctx.send(server_of(st["c_k2"]), M_ROLLBACK,
                 [st["c_ts"], st["c_k2"]], when=undoing)
        self._complete(ctx, st, to)
        ctx.state = st

    def _complete(self, ctx, st, done):
        st["c_phase"] = torch.where(done, PH_IDLE, st["c_phase"])
        st["c_opn"] = st["c_opn"] + done
        st["c_done"] = torch.where(st["c_opn"] >= self.O, 1, st["c_done"])
        ctx.set_timer(self.think, T_NEW, [0],
                      when=done & (st["c_opn"] < self.O))

    # -- protocol replies --------------------------------------------------
    def on_message(self, ctx: Ctx, src, tag, payload):
        st = dict(ctx.state)
        ts_match = payload[:, 0] == st["c_ts"]

        # READ_ACK [ts, key, status, val] — transfer read phase
        is_rd = (tag == M_READ_ACK) & ts_match
        rd_x = is_rd & (st["c_phase"] == PH_READ)
        key, status, val = payload[:, 1], payload[:, 2], payload[:, 3]
        bad = status != R_OK
        hit1 = rd_x & (key == st["c_k1"]) & ((st["c_got"] & 1) == 0)
        hit2 = rd_x & (key == st["c_k2"]) & ((st["c_got"] & 2) == 0)
        st["c_v1"] = torch.where(hit1 & ~bad, val, st["c_v1"])
        st["c_v2"] = torch.where(hit2 & ~bad, val, st["c_v2"])
        st["c_got"] = (st["c_got"] | (hit1 & ~bad).to(_I32)
                       | ((hit2 & ~bad).to(_I32) << 1))
        # a locked/too-new key aborts the transfer (nothing locked yet)
        self._complete(ctx, st, rd_x & bad)
        st["c_phase"] = torch.where(rd_x & bad, PH_IDLE, st["c_phase"])
        both = (st["c_phase"] == PH_READ) & (st["c_got"] == 3)
        st["c_phase"] = torch.where(both, PH_PREWRITE, st["c_phase"])
        # prewrite both, k1 is the primary
        ctx.send(server_of(st["c_k1"]), M_PREWRITE,
                 [st["c_ts"], st["c_k1"], st["c_v1"] - st["c_amt"],
                  st["c_k1"]], when=both)
        ctx.send(server_of(st["c_k2"]), M_PREWRITE,
                 [st["c_ts"], st["c_k2"], st["c_v2"] + st["c_amt"],
                  st["c_k1"]], when=both)

        # READ_ACK — audit phase: accumulate the snapshot total
        rd_a = is_rd & (st["c_phase"] == PH_AUDIT)
        kb = torch.ones_like(key) << torch.clamp(key, 0, 30)
        hit_a = rd_a & ~bad & ((st["a_got"] & kb) == 0)
        st["a_sum"] = st["a_sum"] + torch.where(hit_a, val, 0)
        st["a_got"] = st["a_got"] | torch.where(hit_a, kb, 0)
        self._complete(ctx, st, rd_a & bad)       # honest abort, no oracle
        st["c_phase"] = torch.where(rd_a & bad, PH_IDLE, st["c_phase"])
        audited = (st["c_phase"] == PH_AUDIT) & (st["a_got"] == self.full)
        # THE ORACLE: a complete snapshot must conserve the total
        ctx.crash_if(audited & (st["a_sum"] != self.total), CRASH_SNAPSHOT)
        self._complete(ctx, st, audited)
        st["c_phase"] = torch.where(audited, PH_IDLE, st["c_phase"])

        # PW_ACK [ts, key, ok]
        is_pw = ((tag == M_PW_ACK) & ts_match
                 & (st["c_phase"] == PH_PREWRITE))
        pw_fail = is_pw & (payload[:, 2] == 0)
        ctx.send(server_of(st["c_k1"]), M_ROLLBACK,
                 [st["c_ts"], st["c_k1"]], when=pw_fail)
        ctx.send(server_of(st["c_k2"]), M_ROLLBACK,
                 [st["c_ts"], st["c_k2"]], when=pw_fail)
        self._complete(ctx, st, pw_fail)
        st["c_phase"] = torch.where(pw_fail, PH_IDLE, st["c_phase"])
        got1 = is_pw & ~pw_fail & (payload[:, 1] == st["c_k1"])
        got2 = is_pw & ~pw_fail & (payload[:, 1] == st["c_k2"])
        st["c_pw"] = (st["c_pw"] | got1.to(_I32) | (got2.to(_I32) << 1))
        locked = (st["c_phase"] == PH_PREWRITE) & (st["c_pw"] == 3)
        st["c_phase"] = torch.where(locked, PH_COMMIT, st["c_phase"])
        cts = torch.maximum(ctx.now, st["c_ts"] + 1)    # local again
        st["c_cts"] = torch.where(locked, cts, st["c_cts"])
        # commit the PRIMARY first; secondaries follow lazily
        ctx.send(server_of(st["c_k1"]), M_COMMIT,
                 [st["c_ts"], st["c_cts"], st["c_k1"]], when=locked)

        # CM_ACK [ts, key, ok] — primary outcome decides the txn
        is_cm = ((tag == M_CM_ACK) & ts_match
                 & (st["c_phase"] == PH_COMMIT)
                 & (payload[:, 1] == st["c_k1"]))
        cm_ok = is_cm & (payload[:, 2] != 0)
        # LAZY secondary commit: fire-and-forget (the bug surface)
        ctx.send(server_of(st["c_k2"]), M_COMMIT,
                 [st["c_ts"], st["c_cts"], st["c_k2"]], when=cm_ok)
        # primary lock was cleaned under us: txn aborted — release k2
        ctx.send(server_of(st["c_k2"]), M_ROLLBACK,
                 [st["c_ts"], st["c_k2"]], when=is_cm & ~cm_ok)
        self._complete(ctx, st, is_cm)
        st["c_phase"] = torch.where(is_cm, PH_IDLE, st["c_phase"])
        ctx.cancel_timer(T_TO, when=is_cm)
        ctx.state = st


def clients_done(n_nodes: int):
    def check(state):
        return (state.node_state["c_done"][:, N_SERVERS:n_nodes]
                == 1).all(-1)
    return check


def make_percolator_runtime(n_clients=3, n_ops=9, n_keys=6, ttl=ms(80),
                            sync_commits=True, scenario=None, cfg=None,
                            device=None):
    """2 shard servers (nodes 0, 1; key % 2) + `n_clients` txn clients.
    Green with no faults injected; the gray-failure recipes
    (runtime/chaos.py) break its snapshot-isolation oracle by design."""
    from ..core.types import NetConfig, SimConfig, sec
    from ..runtime.runtime import Runtime
    n = N_SERVERS + n_clients
    # every op commits at most 2 records; margin for retries
    log_cap = 2 * n_clients * n_ops + 8
    if cfg is None:
        cfg = SimConfig(n_nodes=n, event_capacity=256, payload_words=8,
                        time_limit=sec(10),
                        net=NetConfig(send_latency_min=ms(1),
                                      send_latency_max=ms(8)))
    server = PercServer(n_keys, log_cap, ttl=ttl,
                        sync_commits=sync_commits)
    client = PercClient(n_keys, n_ops)
    node_prog = np.asarray([0] * N_SERVERS + [1] * n_clients, np.int32)
    return Runtime(cfg, [server, client],
                   perc_state_spec(n_keys, log_cap),
                   node_prog=node_prog, scenario=scenario,
                   persist=perc_persist_spec(),
                   halt_when=clients_done(n), device=device)
