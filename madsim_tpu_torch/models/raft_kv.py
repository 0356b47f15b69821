"""Replicated KV register store on Raft, with client-observed histories —
the full MadRaft workload (BASELINE.md config 4: log replication +
snapshots + linearizability fuzz); the counterpart of
`madsim_tpu.models.raft_kv`, written for batched [B, ...] node state.

Cluster layout: nodes [0, R) run RaftKv (the consensus core of
models/raft.py with a richer log entry: op/key/val/client/rtag); nodes
[R, N) run KvClient, issuing sequential PUT/GET calls with retry-and-rotate
on timeout. Clients record an invocation/response history into fixed-size
state arrays; the host extracts it after the run and feeds it to the
linearizability checker (`madsim_tpu_torch/native.py`, C++).

State machine: every node applies committed entries in order into a
materialized image (kv registers + per-client session table), bounded per
event by `apply_per_event`. The leader replies at apply time. Exactly-once:
entries carry (client, rtag); retries dedup against the session table (for
applied ops — their log entries may be compacted away) and against the live
log window (for in-flight ops). GETs are linearized through the log like
writes, so every response is a committed operation.

Snapshots (Raft §7): compaction folds exactly the applied prefix, capturing
the (kv, sessions) image at that boundary. InstallSnapshot ships the image
CHUNKED over the fixed-width payload: each IS carries [chunk_idx,
n_chunks, words...] after the 4-word header; followers stage chunks keyed
by snap_len and install only when the image is complete.

Per-lane index writes are `select.put_row` (a one-hot `where` over the
lane's row) at an index clipped exactly as the reference clips it; the
chunk bitmap stays int32 (ROADMAP F2).
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.api import Ctx, Program
from ..core.types import ms
from ..ops.select import put_row, take1
from . import raft as R

OP_PUT, OP_GET = 1, 2
# message tags (beyond RV/RVR/AE/AER/IS = 1..4, 9)
CMD, CRSP = 5, 6
# client timer tags
T_NEW, T_RETRY = 4, 5

KV_FIELDS = ("op", "key", "val", "client", "rtag")
# IS data words per chunk: rides the slots the AE entry fields occupy, so
# every payload variant stacks to the same width
CHUNK_WORDS = len(KV_FIELDS)

_I32 = torch.int32


def _image_words(n_keys: int, n_clients: int) -> int:
    """Flattened snapshot image: kv registers + session (rtag, val) rows."""
    return n_keys + 2 * n_clients


def kv_state_spec(n_nodes: int, log_capacity: int, n_ops: int,
                  n_keys: int = 4, n_clients: int = 3):
    z = torch.tensor(0, dtype=_I32)
    K, NC = n_keys, n_clients
    SW = _image_words(K, NC)
    extra = dict(
        # materialized state machine (persistent — it IS applied state)
        kv=torch.zeros((K,), dtype=_I32),
        applied=z,
        sess_rtag=torch.zeros((NC,), dtype=_I32),
        sess_val=torch.zeros((NC,), dtype=_I32),
        # frozen image at snap_len, captured at compaction — IS chunks read
        # this so a multi-chunk transfer stays internally consistent even
        # while the live kv keeps advancing
        snap_kv=torch.zeros((K,), dtype=_I32),
        snap_sess_rtag=torch.zeros((NC,), dtype=_I32),
        snap_sess_val=torch.zeros((NC,), dtype=_I32),
        # incoming-snapshot staging (volatile — restart restages)
        stage_buf=torch.zeros((SW,), dtype=_I32),
        stage_mask=z,
        stage_slen=z,
        # client-side bookkeeping
        c_target=z, c_id=z, c_op=z, c_key=z, c_val=z, c_opn=z,
        c_wait=z,
        h_op=torch.zeros((n_ops,), dtype=_I32),
        h_key=torch.zeros((n_ops,), dtype=_I32),
        h_val=torch.zeros((n_ops,), dtype=_I32),
        h_inv=torch.full((n_ops,), -1, dtype=_I32),
        h_resp=torch.full((n_ops,), -1, dtype=_I32),
    )
    return R.state_spec(n_nodes, log_capacity, KV_FIELDS, extra)


def kv_persist_spec():
    persist = ("kv", "applied", "sess_rtag", "sess_val",
               "snap_kv", "snap_sess_rtag", "snap_sess_val")
    volatile = dict(stage_buf=None, stage_mask=None, stage_slen=None,
                    c_target=None, c_id=None, c_op=None, c_key=None,
                    c_val=None, c_opn=None, c_wait=None, h_op=None,
                    h_key=None, h_val=None, h_inv=None, h_resp=None)
    mask = R.persist_spec(KV_FIELDS, volatile)
    mask.update({k: True for k in persist})
    return mask


def _c(x):
    """[B] -> [B, 1]: a per-lane mask against a per-lane vector."""
    return x.unsqueeze(-1)


class RaftKv(R.Raft):
    """Raft peer serving PUT/GET commands from clients."""

    ENTRY_FIELDS = KV_FIELDS

    def __init__(self, n_nodes: int, log_capacity: int = 64,
                 apply_per_event: int = 2, n_keys: int = 4, **kw):
        super().__init__(n_nodes, log_capacity, n_cmds=0, **kw)
        self.apply_per_event = apply_per_event
        self.K = n_keys
        self.NC = n_nodes - self.npeers          # client nodes [R, N)
        self.SW = _image_words(self.K, self.NC)
        self.n_chunks = -(-self.SW // CHUNK_WORDS)
        assert self.n_chunks <= 31, "stage_mask is a single int32 bitmap"
        self.full_mask = (1 << self.n_chunks) - 1

    def _propose_fields(self, ctx, st):
        # RaftKv never self-proposes (n_cmds=0); entries come from clients
        return {f: 0 for f in KV_FIELDS}

    # -- the apply loop: committed entries -> (kv, sessions), in order ----
    def _on_commit_progress(self, ctx: Ctx, st, active):
        L, K = self.L, self.K
        for _ in range(self.apply_per_event):
            k = st["applied"]
            can = active & (k < st["commit"]) & (k >= st["snap_len"])
            slot = torch.clamp(k - st["snap_len"], 0, L - 1)
            op = take1(st["log_op"], slot)
            key = torch.clamp(take1(st["log_key"], slot), 0, K - 1)
            client = take1(st["log_client"], slot)
            rtag = take1(st["log_rtag"], slot)
            do_put = can & (op == OP_PUT)
            st["kv"] = put_row(st["kv"], key, take1(st["log_val"], slot),
                               do_put)
            # post-write read: a PUT's result is its own value, a GET's is
            # the register as of this log position — both are kv[key] now
            result = take1(st["kv"], key)
            cid = torch.clamp(client - self.npeers, 0, self.NC - 1)
            isop = can & (op != 0)                # no-op entries: no caller
            st["sess_rtag"] = put_row(st["sess_rtag"], cid, rtag, isop)
            st["sess_val"] = put_row(st["sess_val"], cid, result, isop)
            ctx.send(client, CRSP, [rtag, result],
                     when=isop & (st["role"] == R.LEADER))
            st["applied"] = st["applied"] + can

    # -- client commands ---------------------------------------------------
    def _extra_message(self, ctx: Ctx, st, src, tag, payload):
        L = self.L
        is_cmd = tag == CMD
        rtag, op, key, val = (payload[:, 0], payload[:, 1], payload[:, 2],
                              payload[:, 3])
        leader = st["role"] == R.LEADER
        cid = torch.clamp(src - self.npeers, 0, self.NC - 1)

        # exactly-once, two levels: the session table answers retries of
        # already-APPLIED ops (whose log entries may be compacted away);
        # the live-window scan suppresses re-append of in-flight ops.
        # rtags are MONOTONIC per client (KvClient issues c_opn + 1), so a
        # delayed duplicate of an op OLDER than the session entry is
        # rejected outright
        sess = take1(st["sess_rtag"], cid)
        sess_hit = sess == rtag
        stale = rtag < sess
        ks = torch.arange(L, dtype=_I32, device=tag.device)
        live = st["log_len"] - st["snap_len"]
        pending = ((st["log_rtag"] == _c(rtag)) & (st["log_client"] == _c(src))
                   & (ks < _c(live))).any(-1)

        self._append(ctx, st,
                     is_cmd & leader & ~sess_hit & ~stale & ~pending,
                     dict(op=op, key=key, val=val, client=src, rtag=rtag))
        ctx.send(src, CRSP, [rtag, take1(st["sess_val"], cid)],
                 when=is_cmd & leader & sess_hit)
        # non-leaders drop client commands; the client's retry timer rotates
        # it to another node (no redirect hints — pure fuzzing pressure)

    def _on_become_leader(self, ctx: Ctx, st, become_leader):
        # append a no-op entry (op=0): a leader can only count commits for
        # current-term entries (§5.4.2), and clients' retries dedup against
        # inherited entries instead of re-appending. Only needed when
        # uncommitted inherited entries exist; gating on that keeps leader
        # churn from eating the log capacity.
        self._append(ctx, st,
                     become_leader & (st["commit"] < st["log_len"]),
                     {f: 0 for f in KV_FIELDS})

    # -- snapshots ---------------------------------------------------------
    def _compact_limit(self, st):
        # compact exactly the applied prefix: the (kv, sessions) image then
        # sits precisely at the new snap_len
        return st["applied"]

    def _snapshot_extra(self, ctx, st, do, shift):
        for k in ("kv", "sess_rtag", "sess_val"):
            st[f"snap_{k}"] = torch.where(_c(do), st[k], st[f"snap_{k}"])

    def _is_extra_words(self, ctx, st):
        # rotate chunks on the heartbeat clock: every n_chunks ticks each
        # lagging follower has seen the whole image (lossy links just take
        # another cycle)
        chunk = torch.remainder(torch.div(ctx.now, self.hb,
                                          rounding_mode="floor"),
                                self.n_chunks)
        svec = torch.cat(
            [st["snap_kv"], st["snap_sess_rtag"], st["snap_sess_val"]], -1)
        base = chunk * CHUNK_WORDS
        words = []
        for w in range(CHUNK_WORDS):
            idx = torch.clamp(base + w, 0, self.SW - 1)
            words.append(torch.where(base + w < self.SW, take1(svec, idx),
                                     torch.zeros_like(idx)))
        # n_chunks as a device fill (no host value enters the step)
        return [chunk, torch.full_like(chunk, self.n_chunks)] + words

    def _install_ready(self, ctx, st, want, payload):
        # stage the incoming chunk, keyed by the snapshot's snap_len —
        # chunks of a superseded snapshot are discarded wholesale
        s_len, cidx = payload[:, 1], payload[:, 4]
        fresh = want & (st["stage_slen"] != s_len)
        st["stage_mask"] = torch.where(fresh, 0, st["stage_mask"])
        st["stage_slen"] = torch.where(want, s_len, st["stage_slen"])
        base = cidx * CHUNK_WORDS
        for w in range(CHUNK_WORDS):
            pos = torch.clamp(base + w, 0, self.SW - 1)
            ok_w = want & (base + w < self.SW)
            st["stage_buf"] = put_row(st["stage_buf"], pos, payload[:, 6 + w],
                                      ok_w)
        bit = torch.ones_like(cidx) << torch.clamp(cidx, 0, 30)
        st["stage_mask"] = torch.where(want, st["stage_mask"] | bit,
                                       st["stage_mask"])
        return st["stage_mask"] == self.full_mask

    def _install_extra(self, ctx, st, inst, payload):
        s_len = payload[:, 1]
        K, NC = self.K, self.NC
        buf = st["stage_buf"]
        image = dict(kv=buf[:, :K], sess_rtag=buf[:, K:K + NC],
                     sess_val=buf[:, K + NC:K + 2 * NC])
        # adopt the image only if it's ahead of our own applied state (a
        # node that kept a matching suffix may already be further along)
        adopt = inst & (st["applied"] < s_len)
        for k, v in image.items():
            st[k] = torch.where(_c(adopt), v, st[k])
        st["applied"] = torch.where(adopt, s_len, st["applied"])
        # the installed image is also our shipping copy at the new
        # snap_len — on EVERY install (not just adopt): snap_len moved to
        # s_len, so keeping an image captured at the old boundary would
        # ship a wrong snapshot if this node later leads
        for k, v in image.items():
            st[f"snap_{k}"] = torch.where(_c(inst), v, st[f"snap_{k}"])


class KvClient(Program):
    """Sequential closed-loop client: one outstanding op, retry with target
    rotation on timeout, per-op invocation/response history recording."""

    def __init__(self, n_raft: int, n_keys: int = 4, n_ops: int = 12,
                 timeout=ms(60), think=ms(10)):
        self.R = n_raft
        self.K = n_keys
        self.O = n_ops
        self.timeout = timeout
        self.think = think

    def init(self, ctx: Ctx):
        st = dict(ctx.state)
        st["c_target"] = ctx.randint(0, self.R - 1)
        ctx.set_timer(ctx.randint(0, ms(20)), T_NEW, [0])
        ctx.state = st

    # call ids are MONOTONIC per client (op index + 1): the server's
    # session dedup can then reject a delayed duplicate of an OLDER op
    # even after its log entry was compacted (see RaftKv._extra_message)
    def _next_call_id(self, st):
        return st["c_opn"] + 1

    def _issue(self, ctx, st, when):
        ctx.send(st["c_target"], CMD,
                 [st["c_id"], st["c_op"], st["c_key"], st["c_val"]],
                 when=when)
        ctx.set_timer(self.timeout, T_RETRY, [st["c_id"]], when=when)

    def on_timer(self, ctx: Ctx, tag, payload):
        st = dict(ctx.state)
        start = ((tag == T_NEW) & (st["c_wait"] == 0)
                 & (st["c_opn"] < self.O))
        st["c_id"] = torch.where(start, self._next_call_id(st), st["c_id"])
        put_or_get = torch.where(ctx.bernoulli(0.5), OP_PUT, OP_GET)
        st["c_op"] = torch.where(start, put_or_get.to(_I32), st["c_op"])
        st["c_key"] = torch.where(start, ctx.randint(0, self.K - 1),
                                  st["c_key"])
        st["c_val"] = torch.where(start, ctx.node * 4096 + st["c_opn"],
                                  st["c_val"])
        st["c_wait"] = torch.where(start, 1, st["c_wait"])
        oidx = torch.clamp(st["c_opn"], 0, self.O - 1)
        for h, v in (("h_op", st["c_op"]), ("h_key", st["c_key"]),
                     ("h_val", st["c_val"]), ("h_inv", ctx.now)):
            st[h] = put_row(st[h], oidx, v, start)

        # timeout: rotate to a random raft node and retry the SAME call id
        retry = ((tag == T_RETRY) & (st["c_wait"] == 1)
                 & (payload[:, 0] == st["c_id"]))
        st["c_target"] = torch.where(retry, ctx.randint(0, self.R - 1),
                                     st["c_target"])
        self._issue(ctx, st, start | retry)
        ctx.state = st

    def on_message(self, ctx: Ctx, src, tag, payload):
        st = dict(ctx.state)
        hit = ((tag == CRSP) & (st["c_wait"] == 1)
               & (payload[:, 0] == st["c_id"]))
        oidx = torch.clamp(st["c_opn"], 0, self.O - 1)
        st["h_resp"] = put_row(st["h_resp"], oidx, ctx.now, hit)
        st["h_val"] = put_row(st["h_val"], oidx, payload[:, 1],
                              hit & (take1(st["h_op"], oidx) == OP_GET))
        st["c_opn"] = st["c_opn"] + hit
        st["c_wait"] = torch.where(hit, 0, st["c_wait"])
        ctx.set_timer(self.think, T_NEW, [0], when=hit)
        ctx.state = st


def all_clients_done(n_raft: int, n_ops: int):
    """halt_when: every client finished its `n_ops` operations."""
    def check(state):
        return (state.node_state["c_opn"][:, n_raft:] >= n_ops).all(-1)
    return check


def make_kv_runtime(n_raft=5, n_clients=3, n_keys=4, n_ops=12,
                    log_capacity=64, scenario=None, cfg=None,
                    halt_when_all_done=True, device=None, **raft_kw):
    from ..core.types import SimConfig, sec
    from ..runtime.runtime import Runtime
    n = n_raft + n_clients
    if cfg is None:
        cfg = SimConfig(n_nodes=n, event_capacity=128, payload_words=12,
                        time_limit=sec(20))
    assert cfg.payload_words >= 6 + len(KV_FIELDS)
    if not raft_kw.get("compact_threshold"):
        assert log_capacity >= n_clients * n_ops + 4, \
            ("without compaction the log must fit every client op plus "
             "slack for election no-ops (one per leader change with "
             "uncommitted inherited entries)")
    raft_kw.setdefault("n_peers", n_raft)  # quorum over servers, not clients
    prog_raft = RaftKv(n, log_capacity, n_keys=n_keys, **raft_kw)
    prog_client = KvClient(n_raft, n_keys, n_ops)
    node_prog = np.asarray([0] * n_raft + [1] * n_clients, np.int32)
    peer_mask = np.asarray([True] * n_raft + [False] * n_clients)
    return Runtime(cfg, [prog_raft, prog_client],
                   kv_state_spec(n, log_capacity, n_ops, n_keys, n_clients),
                   node_prog=node_prog, scenario=scenario,
                   invariant=R.raft_invariant(
                       n, log_capacity, KV_FIELDS, peer_mask,
                       window_slides=R.window_slides_for(raft_kw)),
                   persist=kv_persist_spec(),
                   halt_when=(all_clients_done(n_raft, n_ops)
                              if halt_when_all_done else None),
                   device=device)


def extract_histories(state, n_raft: int, n_clients: int):
    """Pull per-trajectory client histories out of the final batched state.

    Returns a list (one per trajectory) of dicts with numpy arrays
    op/key/val/inv/resp flattened over clients (resp == -1 for ops still
    outstanding at halt — the checker treats those as possibly-applied).
    """
    ns = state.node_state
    sl = slice(n_raft, n_raft + n_clients)
    h = {k: ns[k][:, sl].cpu().numpy() for k in
         ("h_op", "h_key", "h_val", "h_inv", "h_resp")}
    out = []
    for b in range(h["h_op"].shape[0]):
        started = h["h_inv"][b] >= 0
        out.append({k[2:]: v[b][started] for k, v in h.items()})
    return out
