"""minipg — a postgres-shaped session protocol over the sim TCP stack (the
counterpart of `madsim_tpu.models.minipg`, written for batched [B, ...]
node state).

One protocol state machine with
  * a multi-phase session handshake: STARTUP -> salted-challenge AUTH ->
    READY (wrong credentials draw ERROR and a connection reset),
  * PIPELINED queries: the client issues a whole transaction's statements
    without awaiting responses; the server answers strictly in order,
  * TRANSACTIONS: BEGIN / SET / GET (read-your-writes through the txn
    buffer) / COMMIT / ROLLBACK, exactly-once commits across
    reconnect-and-retry (txn ids dedup against the last committed id),
running over the full sim TCP stack: net/conn.py's lifecycle (SYN /
SYN-ACK / RST) and net/stream.py's reliable ordered framing, under kill,
loss, reset and duplicate-delivery chaos.

Client-side oracles (ctx.crash_if): response statuses per pipeline
position (401), read-your-writes inside transactions (402), committed
state visible after COMMIT (403) — so a run that completes IS the
correctness assertion.

Every masked block of the reference runs on every event here (a tensor
mask is never statically false, utils/maskutil.py): in particular the
server draws a salt (`ctx.randint`) for every delivered slot, as the
reference's traced step does, so the draws are the reference's.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.api import Ctx, Program
from ..core.types import ms
from ..net import conn, stream
from ..ops.select import put_at, put_row, row_at, take1

# wire frames (ride reliable stream items): [mtype, a, b, c, d]
M_STARTUP, M_AUTHREQ, M_AUTH, M_READY, M_ERROR, M_QUERY, M_RESULT = \
    1, 2, 3, 4, 5, 6, 7
FRAME_WORDS = 5
PROTO_VER = 3          # a nod to the postgres v3 protocol

# query ops
OP_BEGIN, OP_SET, OP_GET, OP_COMMIT, OP_ROLLBACK = 1, 2, 3, 4, 5
# result statuses
ST_OK, ST_VAL, ST_ERR, ST_DUP = 1, 2, 3, 4

# session phases (server, per client)
S_NONE, S_AWAIT_AUTH, S_READY = 0, 1, 2

CRASH_BAD_STATUS = 401
CRASH_TXN_READ = 402
CRASH_VISIBILITY = 403

SERVER = 0
TXN_BUF = 4            # statements a transaction may buffer
RING = 12              # server response backpressure ring, per client
OPS_PER_TXN = 6        # BEGIN, SET, GET, SET, COMMIT|ROLLBACK, verify-GET

AUTH_MIX = 1540483477  # odd multiplier for the toy digest

_I32 = torch.int32


def _pick(cond, a, b):
    """int32 `where` (a `torch.where` of two Python ints is int64)."""
    return torch.where(cond, a, b).to(_I32)


def password_for(user):
    """The shared secret both sides derive; tests break it deliberately
    to exercise the refusal path."""
    return user * 7 + 13


def auth_digest(user, password, salt):
    """(user * AUTH_MIX + password) ^ salt, wrapping at 32 bits as the
    reference's int32 arithmetic does."""
    return (user * AUTH_MIX + password) ^ salt


def pg_state_spec(n_nodes: int, n_keys: int, window: int = 8):
    z = torch.tensor(0, dtype=_I32)
    N = n_nodes

    def vec(*shape):
        return torch.zeros(shape, dtype=_I32)

    return dict(
        **conn.conn_state(N),
        **stream.stream_state(N, window=window, item_words=FRAME_WORDS),
        # server: sessions
        sess=vec(N), salt=vec(N), susr=vec(N),
        # server: transactions
        txn=vec(N), tb_key=vec(N, TXN_BUF), tb_val=vec(N, TXN_BUF),
        tb_n=vec(N),
        # server: durable storage (persist mask)
        kv=vec(n_keys), ltid=vec(N),
        # server: in-order response ring (backpressure, never drop)
        rb=vec(N, RING, FRAME_WORDS), rb_w=vec(N), rb_r=vec(N),
        # client
        c_phase=z, c_salt=z.clone(), c_tid=torch.tensor(1, dtype=_I32),
        c_sq=z.clone(), c_rid=z.clone(), c_dup0=z.clone(),
        c_exp=vec(2),
        c_prog=z.clone(), c_done=z.clone(), c_rej=z.clone(),
    )


def pg_persist_spec(spec):
    """Only the database (kv) and commit-dedup table (ltid) are durable."""
    return {k: k in ("kv", "ltid") for k in spec}


class PgServer(Program):
    def __init__(self, n_nodes: int, n_keys: int, tick=ms(10),
                 epoch_guard: bool = True):
        self.n = n_nodes
        self.K = n_keys
        self.tick = tick
        # the incarnation guard (net/conn.py, net/stream.py): False is the
        # accept-everything transport, the red control
        self.guard = epoch_guard

    # ---- response ring (strict output order + backpressure) -------------
    def _rpush(self, ctx, st, src, words, when):
        w = row_at(st["rb_w"], src)
        slot = torch.remainder(w, RING)
        ok = when & (w - row_at(st["rb_r"], src) < RING)
        frame = torch.stack([ctx._i32(x) for x in words], dim=-1)
        st["rb"] = put_at(st["rb"], src,
                          put_row(row_at(st["rb"], src), slot, frame, ok))
        st["rb_w"] = put_at(st["rb_w"], src, w + ok.to(_I32))

    def _drain(self, ctx, st):
        for c in range(1, self.n):
            for _ in range(2):     # <= 2 frames per client per event
                r = st["rb_r"][:, c]
                has = r < st["rb_w"][:, c]
                frame = row_at(st["rb"][:, c], torch.remainder(r, RING))
                ok = stream.send(ctx, st, c, frame, when=has)
                st["rb_r"] = put_at(st["rb_r"], c, r + ok.to(_I32))

    # ---- one protocol frame ---------------------------------------------
    def _frame(self, ctx: Ctx, st, src, f, when):
        mtype, a, b, c, d = f.unbind(-1)
        zero = 0

        # STARTUP: fresh session — void any open txn and pending output,
        # challenge with a salt
        su = when & (mtype == M_STARTUP)
        st["sess"] = put_at(st["sess"], src, S_AWAIT_AUTH, su)
        st["susr"] = put_at(st["susr"], src, b, su)
        st["txn"] = put_at(st["txn"], src, 0, su)
        st["salt"] = put_at(st["salt"], src, ctx.randint(1, 2**30 - 1), su)
        self._rpush(ctx, st, src,
                    [M_AUTHREQ, row_at(st["salt"], src), zero, zero, zero],
                    su)

        # AUTH: verify the salted digest
        au = when & (mtype == M_AUTH) & (row_at(st["sess"], src)
                                         == S_AWAIT_AUTH)
        usr = row_at(st["susr"], src)
        good = a == auth_digest(usr, password_for(usr),
                                row_at(st["salt"], src))
        st["sess"] = put_at(st["sess"], src, S_READY, au & good)
        self._rpush(ctx, st, src, [M_READY, zero, zero, zero, zero],
                    au & good)
        # bad credentials: best-effort ERROR, then reset the connection
        stream.send(ctx, st, src, [M_ERROR, 1, 0, 0, 0], when=au & ~good)
        conn.reset(ctx, st, src, when=au & ~good)
        st["sess"] = put_at(st["sess"], src, S_NONE, au & ~good)

        # QUERY: the pipelined statement machine
        q = when & (mtype == M_QUERY) & (row_at(st["sess"], src) == S_READY)
        qid, op, key, val = a, b, torch.clamp(c, 0, self.K - 1), d
        open_ = row_at(st["txn"], src) == 1

        beg = q & (op == OP_BEGIN)
        dup = beg & (c <= row_at(st["ltid"], src))  # txn id committed
        st["txn"] = put_at(st["txn"], src, 1, beg & ~dup)
        st["tb_n"] = put_at(st["tb_n"], src, 0, beg & ~dup)

        sets = q & (op == OP_SET) & open_
        tb_n = row_at(st["tb_n"], src)
        room = tb_n < TXN_BUF
        wslot = torch.clamp(tb_n, 0, TXN_BUF - 1)
        for k, v in (("tb_key", key), ("tb_val", val)):
            st[k] = put_at(st[k], src,
                           put_row(row_at(st[k], src), wslot, v, sets & room))
        st["tb_n"] = put_at(st["tb_n"], src,
                            tb_n + (sets & room).to(_I32))

        # GET reads through the txn buffer (read-your-writes), else storage
        get = q & (op == OP_GET)
        js = torch.arange(TXN_BUF, dtype=_I32, device=q.device)
        tb_key = row_at(st["tb_key"], src)
        tb_val = row_at(st["tb_val"], src)
        tb_n = row_at(st["tb_n"], src)
        m = ((tb_key == key[:, None]) & (js < tb_n[:, None])
             & open_[:, None])
        lastb = torch.where(m, js + 1, 0).amax(-1)
        read = torch.where(lastb > 0,
                           take1(tb_val, torch.clamp(lastb - 1, 0,
                                                     TXN_BUF - 1)),
                           take1(st["kv"], key))

        com = q & (op == OP_COMMIT)
        ltid = row_at(st["ltid"], src)
        cdup = com & ~open_ & (c <= ltid)
        apply_ = com & open_
        for j in range(TXN_BUF):        # ordered buffer replay
            aj = apply_ & (j < tb_n)
            kj = torch.clamp(tb_key[:, j], 0, self.K - 1)
            st["kv"] = put_row(st["kv"], kj, tb_val[:, j], aj)
        st["ltid"] = put_at(st["ltid"], src, torch.maximum(ltid, c), apply_)
        st["txn"] = put_at(st["txn"], src, 0, com)

        rol = q & (op == OP_ROLLBACK)
        st["txn"] = put_at(st["txn"], src, 0, rol)
        st["tb_n"] = put_at(st["tb_n"], src, 0, com | rol)

        status = _pick(
            beg, _pick(dup, ST_DUP, ST_OK),
            _pick(sets, _pick(room, ST_OK, ST_ERR),
                  _pick(get, ST_VAL,
                        _pick(com,
                              _pick(apply_, ST_OK,
                                    _pick(cdup, ST_DUP, ST_ERR)),
                              _pick(rol, ST_OK, ST_ERR)))))
        # a SET outside a txn is autocommit-disabled here: explicit ERR
        status = _pick(q & (op == OP_SET) & ~open_, ST_ERR, status)
        self._rpush(ctx, st, src,
                    [M_RESULT, qid, status, torch.where(get, read, 0), zero],
                    q)

    # ---- lifecycle -------------------------------------------------------
    def init(self, ctx: Ctx):
        st = dict(ctx.state)
        conn.listen(ctx, st)
        ctx.set_timer(self.tick, 1, [0])
        ctx.state = st

    def on_timer(self, ctx: Ctx, tag, payload):
        st = dict(ctx.state)
        self._drain(ctx, st)
        for c in range(1, self.n):
            stream.retransmit(ctx, st, c, when=True)
        ctx.set_timer(self.tick, 1, [0])
        ctx.state = st

    def on_message(self, ctx: Ctx, src, tag, payload):
        st = dict(ctx.state)
        accept, _, rst = conn.on_message(ctx, st, src, tag, payload,
                                         epoch_guard=self.guard)
        # a (re)connecting or resetting peer voids its session and pending
        # output (the conn layer already re-based the stream fabric)
        fresh = accept | rst
        for k in ("rb_w", "rb_r", "sess", "txn", "tb_n"):
            st[k] = put_at(st[k], src, 0, fresh)
        vals, mask = stream.on_message(ctx, st, src, tag, payload,
                                       epoch_guard=self.guard)
        for i in stream.delivered_slots(mask):
            self._frame(ctx, st, src, vals[:, i], mask[:, i])
        self._drain(ctx, st)
        ctx.state = st


class PgClient(Program):
    """Runs n_txns pipelined transactions, verifying every response; txn
    ids make retried commits exactly-once. wrong_password exercises the
    auth-refusal path (expects ERROR/RST, never READY)."""

    def __init__(self, n_txns: int = 4, tick=ms(8), stall=ms(250),
                 wrong_password: bool = False, epoch_guard: bool = True):
        self.T = n_txns
        self.tick = tick
        self.stall = stall
        self.wrong = wrong_password
        self.guard = epoch_guard

    def _keys(self, ctx):
        base = (ctx.node - 1) * 2
        return base, base + 1

    def _val(self, ctx, tid):
        return ctx.node * 10000 + tid * 10

    def _is_commit(self, tid):
        return tid % 2 == 1

    def init(self, ctx: Ctx):
        st = dict(ctx.state)
        st["c_prog"] = ctx.now
        ctx.set_timer(ctx.randint(0, self.tick), 1, [0])
        ctx.state = st

    def _reset_session(self, ctx, st, when):
        conn.reset(ctx, st, SERVER, when=when)
        stream.reset_peer(st, SERVER, when=when)
        for k in ("c_phase", "c_sq", "c_rid", "c_dup0"):
            st[k] = torch.where(when, 0, st[k])

    def on_timer(self, ctx: Ctx, tag, payload):
        st = dict(ctx.state)
        done = st["c_done"] == 1

        # stall watchdog: tear the session down, re-handshake, re-run the
        # CURRENT txn (same tid — the server dedups a re-commit)
        stalled = ~done & (ctx.now - st["c_prog"] > self.stall)
        self._reset_session(ctx, st, stalled)
        st["c_prog"] = torch.where(stalled, ctx.now, st["c_prog"])

        # phase 0: connect, then STARTUP
        est = conn.is_established(st, SERVER)
        conn.connect(ctx, st, SERVER,
                     when=~done & (st["c_phase"] == 0) & ~est)
        ok = stream.send(ctx, st, SERVER,
                         [M_STARTUP, PROTO_VER, ctx.node, 0, 0],
                         when=~done & (st["c_phase"] == 0) & est)
        st["c_phase"] = torch.where(ok, 1, st["c_phase"])
        st["c_prog"] = torch.where(ok, ctx.now, st["c_prog"])

        # phase 3: issue the pipelined statements of the current txn —
        # never waiting for a response before the next statement
        tid = st["c_tid"]
        k0, k1 = self._keys(ctx)
        v = self._val(ctx, tid)
        commit = self._is_commit(tid)
        sq = st["c_sq"]
        issuing = (~done & (st["c_phase"] == 3) & (sq < OPS_PER_TXN)
                   & (tid <= self.T))
        op = _pick(sq == 0, OP_BEGIN,
                   _pick((sq == 1) | (sq == 3), OP_SET,
                         _pick(sq == 2, OP_GET,
                               _pick(sq == 4,
                                     _pick(commit, OP_COMMIT, OP_ROLLBACK),
                                     OP_GET))))
        key = torch.where((sq == 0) | (sq == 4), tid,
                          torch.where(sq == 3, k1, k0))
        val = torch.where(sq == 1, v, torch.where(sq == 3, v + 1000, 0))
        qid = tid * 8 + sq
        sent = stream.send(ctx, st, SERVER, [M_QUERY, qid, op, key, val],
                           when=issuing)
        st["c_sq"] = st["c_sq"] + sent.to(_I32)
        st["c_prog"] = torch.where(sent, ctx.now, st["c_prog"])

        stream.retransmit(ctx, st, SERVER, when=~done)
        ctx.set_timer(self.tick, 1, [0], when=True)
        ctx.state = st

    def _result(self, ctx: Ctx, st, f, when):
        mtype, a, b, c = f[:, 0], f[:, 1], f[:, 2], f[:, 3]

        # handshake frames
        ar = when & (mtype == M_AUTHREQ) & (st["c_phase"] == 1)
        pw = password_for(ctx.node) + (1 if self.wrong else 0)
        dig = auth_digest(ctx.node, pw, a)
        ok = stream.send(ctx, st, SERVER, [M_AUTH, dig, 0, 0, 0], when=ar)
        st["c_phase"] = torch.where(ok, 2, st["c_phase"])
        rdy = when & (mtype == M_READY) & (st["c_phase"] == 2)
        st["c_phase"] = torch.where(rdy, 3, st["c_phase"])
        # the refusal oracle: with bad credentials READY must never come
        if self.wrong:
            ctx.crash_if(rdy, CRASH_BAD_STATUS)
        err = when & (mtype == M_ERROR)
        st["c_rej"] = torch.where(err, 1, st["c_rej"])
        if self.wrong:
            st["c_done"] = torch.where(err, 1, st["c_done"])
        st["c_prog"] = torch.where(ar | rdy | err, ctx.now, st["c_prog"])

        # pipelined results, strictly in order: c_rid is the position
        tid = st["c_tid"]
        v = self._val(ctx, tid)
        commit = self._is_commit(tid)
        res = (when & (mtype == M_RESULT) & (st["c_phase"] == 3)
               & (st["c_done"] == 0) & (a == tid * 8 + st["c_rid"]))
        pos = st["c_rid"]
        dup0 = st["c_dup0"] == 1

        p0 = res & (pos == 0)
        ctx.crash_if(p0 & (b != ST_OK) & (b != ST_DUP), CRASH_BAD_STATUS)
        st["c_dup0"] = torch.where(p0 & (b == ST_DUP), 1, st["c_dup0"])

        pset = res & ((pos == 1) | (pos == 3)) & ~dup0
        ctx.crash_if(pset & (b != ST_OK), CRASH_BAD_STATUS)

        # read-your-writes inside the txn
        p2 = res & (pos == 2) & ~dup0
        ctx.crash_if(p2 & ((b != ST_VAL) | (c != v)), CRASH_TXN_READ)

        # commit / rollback status
        p4 = res & (pos == 4)
        ctx.crash_if(p4 & commit & (b != ST_OK) & (b != ST_DUP),
                     CRASH_BAD_STATUS)
        ctx.crash_if(p4 & ~commit & ~dup0 & (b != ST_OK), CRASH_BAD_STATUS)
        # commit visibility: remember what the database must now hold
        landed = p4 & commit & ((b == ST_OK) | (b == ST_DUP))
        st["c_exp"] = torch.where(landed[:, None],
                                  torch.stack([v, v + 1000], dim=-1),
                                  st["c_exp"])

        # the out-of-txn verify GET must see exactly the committed state
        p5 = res & (pos == 5)
        ctx.crash_if(p5 & ((b != ST_VAL) | (c != st["c_exp"][:, 0])),
                     CRASH_VISIBILITY)

        st["c_rid"] = st["c_rid"] + res.to(_I32)
        st["c_prog"] = torch.where(res, ctx.now, st["c_prog"])

        # txn complete -> next txn (or done)
        fin = res & (st["c_rid"] >= OPS_PER_TXN)
        st["c_tid"] = st["c_tid"] + fin.to(_I32)
        for k in ("c_sq", "c_rid", "c_dup0"):
            st[k] = torch.where(fin, 0, st[k])
        st["c_done"] = torch.where(fin & (st["c_tid"] > self.T), 1,
                                   st["c_done"])

    def on_message(self, ctx: Ctx, src, tag, payload):
        st = dict(ctx.state)
        _, _, rst = conn.on_message(ctx, st, src, tag, payload,
                                    epoch_guard=self.guard)
        # server reset (or refusal): back to square one, unless this is
        # the wrong-password client, for whom RST is the expected outcome
        if self.wrong:
            st["c_rej"] = torch.where(rst, 1, st["c_rej"])
            st["c_done"] = torch.where(rst, 1, st["c_done"])
        else:
            self._reset_session(ctx, st, rst & (st["c_done"] == 0))
        vals, mask = stream.on_message(ctx, st, src, tag, payload,
                                       epoch_guard=self.guard)
        for i in stream.delivered_slots(mask):
            self._result(ctx, st, vals[:, i], mask[:, i] & (src == SERVER))
        ctx.state = st


def clients_done(n_nodes: int):
    def check(state):
        return (state.node_state["c_done"][:, 1:n_nodes] == 1).all(-1)
    return check


def make_minipg_runtime(n_clients=2, n_txns=4, scenario=None, cfg=None,
                        wrong_password=False, epoch_guard=True,
                        device=None):
    from ..core.types import NetConfig, SimConfig, sec
    from ..runtime.runtime import Runtime
    n = 1 + n_clients
    n_keys = 2 * n_clients
    if cfg is None:
        cfg = SimConfig(n_nodes=n, event_capacity=64, payload_words=8,
                        time_limit=sec(10),
                        net=NetConfig(send_latency_min=ms(1),
                                      send_latency_max=ms(8)))
    spec = pg_state_spec(n, n_keys)
    server = PgServer(n, n_keys, epoch_guard=epoch_guard)
    client = PgClient(n_txns, wrong_password=wrong_password,
                      epoch_guard=epoch_guard)
    node_prog = np.asarray([0] + [1] * n_clients, np.int32)
    return Runtime(cfg, [server, client], spec, node_prog=node_prog,
                   scenario=scenario, persist=pg_persist_spec(spec),
                   halt_when=clients_done(n), device=device)
