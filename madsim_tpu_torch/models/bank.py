"""Jepsen-style bank workload over the Raft core (the counterpart of
`madsim_tpu.models.bank`, written for batched [B, ...] node state).

Accounts live in a replicated ledger: TRANSFER(from, to, amt) entries move
money atomically, READ entries capture a snapshot of all balances at their
log position. The safety property is *total conservation*: money is
neither created nor destroyed — checked two ways:
  * in-sim, every event: each node's committed-prefix balance total must
    equal the initial total (the global invariant), and
  * host-side: every completed READ observed a conserving snapshot.

Every total is an int32 sum cut back to 32 bits (`_wrap32`, ROADMAP F2),
so it equals the reference's wrapping sum.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.api import Ctx, Program
from ..core.types import ms
from ..ops.raft_invariant import _wrap32
from ..ops.select import put_row, take1
from . import raft as R

OP_TRANSFER, OP_READ = 1, 2
CMD, CRSP = 5, 6
T_NEW, T_RETRY = 4, 5

CRASH_MONEY_LEAK = 501        # committed total != initial total
# (client-observed snapshots are checked host-side by the tests — every
# CRSP carries the committed total at the op's log position)

BANK_FIELDS = ("op", "afrom", "ato", "amt", "client", "rtag")

_I32 = torch.int32


def bank_state_spec(n_nodes: int, log_capacity: int, n_ops: int):
    z = torch.tensor(0, dtype=_I32)
    extra = dict(
        last_replied=z,
        c_target=z, c_id=z, c_op=z, c_from=z, c_to=z, c_amt=z, c_opn=z,
        c_wait=z,
        h_total=torch.full((n_ops,), -1, dtype=_I32),  # total READs saw
        h_resp=torch.full((n_ops,), -1, dtype=_I32),
    )
    return R.state_spec(n_nodes, log_capacity, BANK_FIELDS, extra)


def bank_persist_spec():
    extra = dict(last_replied=None, c_target=None, c_id=None, c_op=None,
                 c_from=None, c_to=None, c_amt=None, c_opn=None,
                 c_wait=None, h_total=None, h_resp=None)
    return R.persist_spec(BANK_FIELDS, extra)


def _entry_delta(log_op, log_afrom, log_ato, log_amt, n_accounts):
    """Each log entry's contribution to the TOTAL balance, [..., L]:
    summing the per-account deltas over accounts collapses to
    amt * (to_in_range - from_in_range), zero for every well-formed
    transfer. Any nonzero prefix sum means replication corrupted an
    entry."""
    in_to = ((log_ato >= 0) & (log_ato < n_accounts)).to(_I32)
    in_from = ((log_afrom >= 0) & (log_afrom < n_accounts)).to(_I32)
    is_xfer = (log_op == OP_TRANSFER).to(_I32)
    return is_xfer * log_amt * (in_to - in_from)


class RaftBank(R.Raft):
    """Raft peer applying the bank command schema."""

    ENTRY_FIELDS = BANK_FIELDS

    def __init__(self, n_nodes: int, n_accounts: int = 6,
                 init_balance: int = 100, log_capacity: int = 64, **kw):
        super().__init__(n_nodes, log_capacity, n_cmds=0, **kw)
        self.K = n_accounts
        self.init_balance = init_balance

    def _propose_fields(self, ctx, st):
        return {f: 0 for f in BANK_FIELDS}

    def _entry_total_delta(self, st):
        """Per-entry contribution to the total balance: [B, L]."""
        return _entry_delta(st["log_op"], st["log_afrom"], st["log_ato"],
                            st["log_amt"], self.K)

    def _total_at(self, st, k):
        """Total balance over all accounts at log position k [B]."""
        ks = torch.arange(self.L, dtype=_I32, device=k.device)
        delta = self._entry_total_delta(st)
        pre = _wrap32(torch.where(ks < k.unsqueeze(-1), delta,
                                  torch.zeros_like(delta)).sum(-1))
        return self.init_balance * self.K + pre

    # -- hooks ------------------------------------------------------------
    def _extra_message(self, ctx: Ctx, st, src, tag, payload):
        L = self.L
        is_cmd = tag == CMD
        rtag, op = payload[:, 0], payload[:, 1]
        afrom, ato, amt = payload[:, 2], payload[:, 3], payload[:, 4]
        leader = st["role"] == R.LEADER
        ks = torch.arange(L, dtype=_I32, device=tag.device)
        dup = ((st["log_rtag"] == rtag.unsqueeze(-1))
               & (st["log_client"] == src.unsqueeze(-1))
               & (ks < st["log_len"].unsqueeze(-1)))
        dup_any = dup.any(-1)
        # the first duplicate slot (0 where there is none), as jnp.argmax
        dup_idx = torch.argmax(dup.to(torch.int8), -1).to(_I32)
        self._append(ctx, st, is_cmd & leader & ~dup_any,
                     dict(op=op, afrom=afrom, ato=ato, amt=amt, client=src,
                          rtag=rtag))
        dup_done = is_cmd & leader & dup_any & (dup_idx < st["commit"])
        ctx.send(src, CRSP, [rtag, self._total_at(st, dup_idx)],
                 when=dup_done)

    def _on_leader_commit(self, ctx: Ctx, st, prev_commit, is_aer):
        base = st["last_replied"]
        for j in range(2):
            k = base + j
            kc = torch.clamp(k, 0, self.L - 1)
            m = (is_aer & (st["role"] == R.LEADER) & (k < st["commit"])
                 & (take1(st["log_op"], kc) != 0))
            ctx.send(take1(st["log_client"], kc), CRSP,
                     [take1(st["log_rtag"], kc), self._total_at(st, k)],
                     when=m)
        st["last_replied"] = torch.where(
            is_aer, torch.minimum(st["commit"], base + 2), base)

    def _on_become_leader(self, ctx: Ctx, st, become_leader):
        st["last_replied"] = torch.where(become_leader, st["commit"],
                                         st["last_replied"])
        self._append(ctx, st,
                     become_leader & (st["commit"] < st["log_len"]),
                     {f: 0 for f in BANK_FIELDS})


class BankClient(Program):
    """Issues random transfers (and READs every third op) sequentially with
    retry-and-rotate; records the total balance each READ observed."""

    def __init__(self, n_raft: int, n_accounts: int = 6, n_ops: int = 12,
                 timeout=ms(60), think=ms(10)):
        self.R = n_raft
        self.K = n_accounts
        self.O = n_ops
        self.timeout = timeout
        self.think = think

    def init(self, ctx: Ctx):
        st = dict(ctx.state)
        st["c_target"] = ctx.randint(0, self.R - 1)
        ctx.set_timer(ctx.randint(0, ms(20)), T_NEW, [0])
        ctx.state = st

    def _issue(self, ctx, st, when):
        ctx.send(st["c_target"], CMD,
                 [st["c_id"], st["c_op"], st["c_from"], st["c_to"],
                  st["c_amt"]], when=when)
        ctx.set_timer(self.timeout, T_RETRY, [st["c_id"]], when=when)

    def on_timer(self, ctx: Ctx, tag, payload):
        st = dict(ctx.state)
        start = ((tag == T_NEW) & (st["c_wait"] == 0)
                 & (st["c_opn"] < self.O))
        st["c_id"] = torch.where(start, ctx.randint(1, 2**30 - 1),
                                 st["c_id"])
        is_read = torch.remainder(st["c_opn"], 3) == 2
        st["c_op"] = torch.where(
            start, torch.where(is_read, OP_READ, OP_TRANSFER).to(_I32),
            st["c_op"])
        st["c_from"] = torch.where(start, ctx.randint(0, self.K - 1),
                                   st["c_from"])
        st["c_to"] = torch.where(start, ctx.randint(0, self.K - 1),
                                 st["c_to"])
        st["c_amt"] = torch.where(start, ctx.randint(1, 20), st["c_amt"])
        st["c_wait"] = torch.where(start, 1, st["c_wait"])

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
        # every reply carries the committed total at the op's log position
        st["h_total"] = put_row(st["h_total"], oidx, payload[:, 1], hit)
        st["h_resp"] = put_row(st["h_resp"], oidx, ctx.now, hit)
        st["c_opn"] = st["c_opn"] + hit
        st["c_wait"] = torch.where(hit, 0, st["c_wait"])
        ctx.set_timer(self.think, T_NEW, [0], when=hit)
        ctx.state = st


def bank_invariant(n_nodes, log_capacity, n_raft, n_accounts, init_balance,
                   window_slides=True):
    """Money conservation on every node's committed prefix, every event,
    after the Raft safety check (`raft_invariant`: K11 on the card). The
    conservation sum over [B, N, L] is plain PyTorch (ROADMAP K18)."""
    base = R.raft_invariant(n_nodes, log_capacity, BANK_FIELDS,
                            np.asarray([i < n_raft for i in range(n_nodes)]),
                            window_slides=window_slides)
    K, L = n_accounts, log_capacity
    total0 = n_accounts * init_balance
    consts = {}

    def invariant(state):
        bad, code = base(state)
        ns = state.node_state
        dev = bad.device
        if dev not in consts:
            consts[dev] = torch.arange(L, dtype=_I32, device=dev)
        ks = consts[dev]
        # each committed entry's TOTAL delta: [B, N, L]
        delta = _entry_delta(ns["log_op"], ns["log_afrom"], ns["log_ato"],
                             ns["log_amt"], K)
        committed = ks < ns["commit"].unsqueeze(-1)
        totals = init_balance * K + _wrap32(torch.where(
            committed, delta, torch.zeros_like(delta)).sum(-1))  # [B, N]
        leak = (totals[:, :n_raft] != total0).any(-1)
        return bad | leak, torch.where(bad, code, CRASH_MONEY_LEAK)

    return invariant


def all_clients_done(n_raft: int, n_ops: int):
    """halt_when: every client finished its `n_ops` operations."""
    def check(state):
        return (state.node_state["c_opn"][:, n_raft:] >= n_ops).all(-1)
    return check


def make_bank_runtime(n_raft=5, n_clients=3, n_accounts=6, n_ops=12,
                      log_capacity=64, init_balance=100, scenario=None,
                      cfg=None, device=None, **raft_kw):
    from ..core.types import SimConfig, sec
    from ..runtime.runtime import Runtime
    n = n_raft + n_clients
    if cfg is None:
        cfg = SimConfig(n_nodes=n, event_capacity=96, payload_words=13,
                        time_limit=sec(20))
    assert cfg.payload_words >= 6 + len(BANK_FIELDS)
    assert log_capacity >= n_clients * n_ops + 4
    # RaftBank is NOT snapshot-aware: its leader-commit reply and
    # duplicate-detection paths index the log by ABSOLUTE position, so a
    # slid window would corrupt replies and re-apply retried transfers.
    # Refuse loudly rather than run wrong.
    assert not raft_kw.get("compact_threshold"), \
        "bank does not support log compaction (absolute log indexing)"
    raft_kw.setdefault("n_peers", n_raft)
    prog = RaftBank(n, n_accounts, init_balance, log_capacity, **raft_kw)
    client = BankClient(n_raft, n_accounts, n_ops)
    node_prog = np.asarray([0] * n_raft + [1] * n_clients, np.int32)
    return Runtime(cfg, [prog, client],
                   bank_state_spec(n, log_capacity, n_ops),
                   node_prog=node_prog, scenario=scenario,
                   invariant=bank_invariant(
                       n, log_capacity, n_raft, n_accounts, init_balance,
                       # compaction is refused above, so the window is
                       # statically pinned and the cheap form is safe
                       window_slides=False),
                   persist=bank_persist_spec(),
                   halt_when=all_clients_done(n_raft, n_ops), device=device)
