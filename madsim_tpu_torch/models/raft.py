"""Raft — the MadRaft-equivalent flagship workload (the counterpart of
`madsim_tpu.models.raft`, written for batched [B, ...] node state).

A full Raft core (leader election, log replication, commit) as a
vectorised state machine: every handler is straight-line tensor code with
masks. term / votedFor / log live in stable storage (the engine's persist
mask), so kill/restart chaos exercises real Raft durability. Safety is
checked after every event by a global invariant: Election Safety (at
most one leader per term) and State Machine Safety (committed prefixes
never disagree).

Message schema (payload words):
  RV : [term, last_log_len, last_log_term]          RequestVote
  RVR: [term, granted]                               RequestVote reply
  AE : [term, prev_len, prev_term, leader_commit,    AppendEntries
        n_entries, k x (entry_term, entry_cmd)]      (k = ae_batch entries)
  AER: [term, success, match_len]                    AppendEntries reply
  IS : [term, snap_len, snap_term, snap_digest]      InstallSnapshot

All digest arithmetic is int32 wraparound (mod 2^32). torch widens an
int32 cumsum or sum to int64 unless told otherwise; such results are cut
back to 32 bits (`_wrap32`, or an int32 result dtype), so the values
equal the JAX package's.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.api import Ctx, Program
from ..core.types import ms
from ..ops.raft_invariant import (  # noqa: F401 - the model's names
    CRASH_COMMIT_GT_LOG, CRASH_LOG_MISMATCH, CRASH_TWO_LEADERS, DIGEST_MIX,
    DIGEST_P, DIGEST_P_INV, _pow_table, _wrap32, entry_hash,
    raft_invariant_check)
from ..ops.select import put_row, row_onehot, take1

FOLLOWER, CANDIDATE, LEADER = 0, 1, 2

# message tags (5/6 are taken by raft_kv's CMD/CRSP in the JAX package)
RV, RVR, AE, AER, IS = 1, 2, 3, 4, 9
# timer tags
T_ELECTION, T_HEARTBEAT, T_PROPOSE = 1, 2, 3

_I32 = torch.int32


def state_spec(n_nodes: int, log_capacity: int = 32, fields=("cmd",),
               extra=None):
    """One node's state schema (no node or lane axis)."""
    z = torch.tensor(0, dtype=_I32)
    L, N = log_capacity, n_nodes
    spec = dict(
        # persistent (stable storage: survives kill/restart)
        term=z,
        voted_for=torch.tensor(-1, dtype=_I32),
        log_term=torch.zeros((L,), dtype=_I32),
        log_len=z,
        snap_len=z,
        snap_term=z,
        snap_digest=z,
        # volatile
        role=z,
        votes=z,
        commit=z,
        next_idx=torch.zeros((N,), dtype=_I32),
        match_idx=torch.zeros((N,), dtype=_I32),
        egen=z,
        hgen=z,
        nprop=z,
    )
    for f in fields:
        spec[f"log_{f}"] = torch.zeros((L,), dtype=_I32)
    if extra:
        spec.update(extra)
    return spec


def persist_spec(fields=("cmd",), extra=None):
    """Which leaves are stable storage (Raft Figure 2 'persistent state')."""
    mask = dict(
        term=True, voted_for=True, log_term=True, log_len=True,
        snap_len=True, snap_term=True, snap_digest=True,
        role=False, votes=False, commit=False, next_idx=False,
        match_idx=False, egen=False, hgen=False, nprop=False,
    )
    for f in fields:
        mask[f"log_{f}"] = True
    if extra:
        mask.update({k: False for k in extra})
    return mask


def _c(x):
    """[B] -> [B, 1]: a per-lane scalar against a per-lane vector."""
    return x.unsqueeze(-1)


class Raft(Program):
    """One Raft peer; see `madsim_tpu.models.raft.Raft` for the protocol
    notes and the subclass hooks, kept here with the same names.

    Args:
      n_nodes: cluster size (majority = n//2 + 1).
      log_capacity: max entries (static shape).
      n_cmds: proposals each leader stint will issue (self-proposing client).
      halt_on_commit: halt the lane when any node's commit index reaches
        this (0 = run to the scenario's HALT).
    """

    def __init__(self, n_nodes: int, log_capacity: int = 32,
                 n_cmds: int = 8, halt_on_commit: int = 0,
                 election_min=ms(150), election_max=ms(300),
                 heartbeat_every=ms(50), propose_every=ms(100),
                 majority_override: int | None = None,
                 n_peers: int | None = None,
                 peer_base: int = 0,
                 compact_threshold: int = 0,
                 ae_batch: int = 1):
        self.n = n_nodes
        self.base = peer_base
        self.npeers = n_peers if n_peers is not None else n_nodes
        self.L = log_capacity
        self.n_cmds = n_cmds
        self.halt_on_commit = halt_on_commit
        self.emin, self.emax = election_min, election_max
        self.hb = heartbeat_every
        self.prop = propose_every
        self.majority = (majority_override if majority_override is not None
                         else self.npeers // 2 + 1)
        self.compact_threshold = compact_threshold
        assert ae_batch >= 1
        self.ae_batch = ae_batch
        self._powP = _pow_table(log_capacity)

    ENTRY_FIELDS = ("cmd",)

    # -- subclass hooks ---------------------------------------------------
    def _propose_fields(self, ctx, st):
        return {"cmd": ctx.node * 65536 + st["nprop"]}

    def _can_propose(self, ctx, st):
        return st["nprop"] < self.n_cmds

    def _on_leader_commit(self, ctx, st, prev_commit, is_aer):
        pass

    def _extra_message(self, ctx, st, src, tag, payload):
        pass

    def _on_become_leader(self, ctx, st, become_leader):
        pass

    def _compact_limit(self, st):
        return st["commit"]

    def _snapshot_extra(self, ctx, st, do, shift):
        pass

    def _is_extra_words(self, ctx, st):
        return []

    def _install_ready(self, ctx, st, want, payload):
        return want

    def _install_extra(self, ctx, st, inst, payload):
        pass

    def _on_commit_progress(self, ctx, st, active):
        pass

    def _append(self, ctx, st, when, vals):
        """Leader-side masked append of one entry (term = current term)."""
        live = st["log_len"] - st["snap_len"]
        when = when & (live < self.L)
        widx = torch.clamp(live, 0, self.L - 1)
        st["log_term"] = put_row(st["log_term"], widx, st["term"], when)
        for f in self.ENTRY_FIELDS:
            st[f"log_{f}"] = put_row(st[f"log_{f}"], widx, vals[f], when)
        st["log_len"] = st["log_len"] + when
        st["match_idx"] = put_row(st["match_idx"], ctx.node, st["log_len"],
                                  when)
        return when

    # -- helpers ----------------------------------------------------------
    def _last_term(self, st):
        return torch.where(
            st["log_len"] > st["snap_len"],
            take1(st["log_term"],
                  torch.clamp(st["log_len"] - 1 - st["snap_len"], 0,
                              self.L - 1)),
            st["snap_term"])

    def _entry_hash(self, st):
        return entry_hash(st["log_term"],
                          [st[f"log_{f}"] for f in self.ENTRY_FIELDS])

    def _shift_log(self, st, shift, live):
        """Slide the log window left by `shift` [B] slots, zeroing every
        slot past the `live` [B] surviving entries."""
        ks = torch.arange(self.L, dtype=_I32, device=shift.device)
        src_idx = torch.remainder(ks + _c(shift), self.L)
        keep = ks < _c(live)
        for c in ("log_term",) + tuple(f"log_{f}" for f in self.ENTRY_FIELDS):
            st[c] = torch.where(keep, take1(st[c], src_idx),
                                torch.zeros_like(st[c]))

    def _maybe_compact(self, ctx, st, when):
        """Fold the committed prefix into the snapshot once it exceeds
        compact_threshold entries, then slide the window."""
        if not self.compact_threshold:
            return
        L = self.L
        dev = st["snap_len"].device
        if self._powP.device != dev:
            self._powP = self._powP.to(dev)
        powP = self._powP
        sl = st["snap_len"]
        target = torch.minimum(self._compact_limit(st), st["log_len"])
        shift = torch.clamp(target - sl, min=0)
        do = when & (shift >= self.compact_threshold)
        shift = torch.where(do, shift, torch.zeros_like(shift))
        ks = torch.arange(L, dtype=_I32, device=dev)
        h = self._entry_hash(st)
        w = take1(powP, torch.clamp(_c(shift) - 1 - ks, 0, L))
        contrib = _wrap32(torch.where(ks < _c(shift), h * w,
                                      torch.zeros_like(h)).sum(-1))
        self._snapshot_extra(ctx, st, do, shift)
        st["snap_digest"] = torch.where(
            do, st["snap_digest"] * take1(powP, shift) + contrib,
            st["snap_digest"])
        st["snap_term"] = torch.where(
            do, take1(st["log_term"], torch.clamp(shift - 1, 0, L - 1)),
            st["snap_term"])
        st["snap_len"] = st["snap_len"] + shift
        self._shift_log(st, shift, st["log_len"] - st["snap_len"])

    def _arm_election(self, ctx, st, when):
        st["egen"] = st["egen"] + (int(when) if isinstance(when, bool)
                                   else when)
        ctx.set_timer(ctx.randint(self.emin, self.emax), T_ELECTION,
                      [st["egen"]], when=when)

    # -- lifecycle --------------------------------------------------------
    def init(self, ctx: Ctx):
        st = dict(ctx.state)
        st["commit"] = torch.maximum(st["commit"], st["snap_len"])
        self._arm_election(ctx, st, True)
        ctx.set_timer(ctx.randint(0, self.prop), T_PROPOSE, [0])
        ctx.state = st

    # -- timers -----------------------------------------------------------
    def on_timer(self, ctx: Ctx, tag, payload):
        st = dict(ctx.state)
        L = self.L

        # election timeout: become candidate, solicit votes (Raft §5.2)
        is_el = ((tag == T_ELECTION) & (payload[:, 0] == st["egen"])
                 & (st["role"] != LEADER))
        st["term"] = st["term"] + is_el
        st["role"] = torch.where(is_el, CANDIDATE, st["role"])
        st["voted_for"] = torch.where(is_el, ctx.node, st["voted_for"])
        st["votes"] = torch.where(is_el, 1, st["votes"])
        last_t = self._last_term(st)
        self._arm_election(ctx, st, is_el)

        # heartbeat / replication tick (leader only); RV, AE and IS to a
        # peer are mutually exclusive, so they share one send slot
        is_hb = ((tag == T_HEARTBEAT) & (payload[:, 0] == st["hgen"])
                 & (st["role"] == LEADER))
        K, F = self.ae_batch, len(self.ENTRY_FIELDS)
        zero = torch.zeros_like(st["term"])
        sl = st["snap_len"]
        rv_payload = torch.stack(
            [st["term"], st["log_len"], last_t]
            + [zero] * (2 + K * (1 + F)), -1)
        extra = self._is_extra_words(ctx, st)
        pad = 1 + K * (1 + F) - len(extra)
        assert pad >= 0, "IS extra words exceed the shared payload width"
        is_payload = torch.stack(
            [st["term"], sl, st["snap_term"], st["snap_digest"]]
            + list(extra) + [zero] * pad, -1)
        for p in range(self.base, self.base + self.npeers):
            nxt = st["next_idx"][:, p]
            need_is = nxt < sl
            prev_term = torch.where(
                nxt > sl,
                take1(st["log_term"], torch.clamp(nxt - 1 - sl, 0, L - 1)),
                st["snap_term"])
            cnt = torch.clamp(st["log_len"] - nxt, 0, K)
            entry_words = []
            for j in range(K):
                eidx = torch.clamp(nxt + j - sl, 0, L - 1)
                entry_words.append(take1(st["log_term"], eidx))
                entry_words += [take1(st[f"log_{f}"], eidx)
                                for f in self.ENTRY_FIELDS]
            ae_payload = torch.stack(
                [st["term"], nxt, prev_term, st["commit"], cnt]
                + entry_words, -1)
            ctx.send(p,
                     torch.where(is_el, RV, torch.where(need_is, IS, AE)),
                     torch.where(_c(is_el), rv_payload,
                                 torch.where(_c(need_is), is_payload,
                                             ae_payload)),
                     when=(is_el | is_hb) & (ctx.node != p))
        ctx.set_timer(self.hb, T_HEARTBEAT, [st["hgen"]], when=is_hb)

        # self-proposing client: leaders append a fresh command
        is_pr = tag == T_PROPOSE
        can = is_pr & (st["role"] == LEADER) & self._can_propose(ctx, st)
        appended = self._append(ctx, st, can, self._propose_fields(ctx, st))
        st["nprop"] = st["nprop"] + appended
        ctx.set_timer(self.prop, T_PROPOSE, [0], when=is_pr)

        if self.halt_on_commit:
            ctx.halt_if(st["commit"] >= self.halt_on_commit)
        ctx.state = st

    # -- messages ---------------------------------------------------------
    def on_message(self, ctx: Ctx, src, tag, payload):
        st = dict(ctx.state)
        N, L = self.n, self.L
        dev = tag.device
        majority = self.majority
        term_in = payload[:, 0]
        is_raft_msg = ((tag == RV) | (tag == RVR) | (tag == AE)
                       | (tag == AER) | (tag == IS))

        # a RAFT message with a higher term: step down (Raft §5.1)
        higher = is_raft_msg & (term_in > st["term"])
        st["term"] = torch.where(higher, term_in, st["term"])
        st["role"] = torch.where(higher, FOLLOWER, st["role"])
        st["voted_for"] = torch.where(higher, -1, st["voted_for"])

        # ---- RequestVote (§5.2, §5.4.1 up-to-date check) ----------------
        is_rv = tag == RV
        cand_len, cand_last_t = payload[:, 1], payload[:, 2]
        my_last_t = self._last_term(st)
        log_ok = ((cand_last_t > my_last_t)
                  | ((cand_last_t == my_last_t)
                     & (cand_len >= st["log_len"])))
        grant = (is_rv & (term_in == st["term"]) & log_ok
                 & ((st["voted_for"] == -1) | (st["voted_for"] == src)))
        st["voted_for"] = torch.where(grant, src, st["voted_for"])
        ctx.send(src, RVR, [st["term"], grant.to(_I32)], when=is_rv)

        # ---- RequestVote reply ------------------------------------------
        is_rvr = ((tag == RVR) & (st["role"] == CANDIDATE)
                  & (term_in == st["term"]) & (payload[:, 1] == 1))
        st["votes"] = st["votes"] + is_rvr
        become_leader = is_rvr & (st["votes"] == majority)
        st["role"] = torch.where(become_leader, LEADER, st["role"])
        st["next_idx"] = torch.where(
            _c(become_leader),
            torch.ones((1, N), dtype=_I32, device=dev) * _c(st["log_len"]),
            st["next_idx"])
        st["match_idx"] = torch.where(
            _c(become_leader),
            torch.where(row_onehot(N, ctx.node), _c(st["log_len"]), 0),
            st["match_idx"])
        st["hgen"] = st["hgen"] + become_leader
        ctx.set_timer(0, T_HEARTBEAT, [st["hgen"]], when=become_leader)
        self._on_become_leader(ctx, st, become_leader)

        # ---- AppendEntries (§5.3) ---------------------------------------
        K, F = self.ae_batch, len(self.ENTRY_FIELDS)
        is_ae = tag == AE
        is_is = tag == IS
        prev, prev_t = payload[:, 1], payload[:, 2]
        lcommit, cnt_in = payload[:, 3], payload[:, 4]
        from_leader = (is_ae | is_is) & (term_in == st["term"])
        st["role"] = torch.where(from_leader & (st["role"] == CANDIDATE),
                                 FOLLOWER, st["role"])
        sl = st["snap_len"]
        prev_ok = (prev <= sl) | (
            (prev <= st["log_len"])
            & (take1(st["log_term"],
                     torch.clamp(prev - 1 - sl, 0, L - 1)) == prev_t))
        ok = (is_ae & (term_in == st["term"])) & prev_ok & (
            (cnt_in == 0) | (prev - sl < L))
        cur_len = st["log_len"]
        n_acc = torch.zeros_like(st["log_len"])
        for j in range(K):
            e_term_j = payload[:, 5 + j * (1 + F)]
            absn = prev + j
            covered_j = ok & (j < cnt_in) & (absn - sl < L)
            valid_j = covered_j & (absn >= sl)
            widx = torch.clamp(absn - sl, 0, L - 1)
            conflict_j = valid_j & (absn < cur_len) & (
                take1(st["log_term"], widx) != e_term_j)
            st["log_term"] = put_row(st["log_term"], widx, e_term_j,
                                     valid_j)
            for i, f in enumerate(self.ENTRY_FIELDS):
                st[f"log_{f}"] = put_row(st[f"log_{f}"], widx,
                                         payload[:, 6 + j * (1 + F) + i],
                                         valid_j)
            cur_len = torch.where(
                valid_j,
                torch.where(conflict_j, absn + 1,
                            torch.maximum(cur_len, absn + 1)),
                cur_len)
            n_acc = n_acc + covered_j
        st["log_len"] = cur_len
        match = torch.where(ok, torch.maximum(sl, prev + n_acc),
                            torch.zeros_like(prev))
        st["commit"] = torch.where(
            ok, torch.maximum(st["commit"], torch.minimum(lcommit, match)),
            st["commit"])

        # ---- InstallSnapshot (§7, follower side) ------------------------
        s_len, s_term, s_dig = payload[:, 1], payload[:, 2], payload[:, 3]
        want = is_is & (term_in == st["term"]) & (s_len > sl)
        inst = want & self._install_ready(ctx, st, want, payload)
        have_suffix = inst & (st["log_len"] >= s_len) & (
            take1(st["log_term"],
                  torch.clamp(s_len - 1 - sl, 0, L - 1)) == s_term)
        keep_len = torch.where(inst,
                               torch.where(have_suffix, st["log_len"], s_len),
                               st["log_len"])
        self._shift_log(st, torch.where(inst, s_len - sl,
                                        torch.zeros_like(sl)),
                        keep_len - torch.where(inst, s_len, sl))
        st["log_len"] = keep_len
        st["snap_len"] = torch.where(inst, s_len, st["snap_len"])
        st["snap_term"] = torch.where(inst, s_term, st["snap_term"])
        st["snap_digest"] = torch.where(inst, s_dig, st["snap_digest"])
        st["commit"] = torch.where(inst, torch.maximum(st["commit"], s_len),
                                   st["commit"])
        self._install_extra(ctx, st, inst, payload)

        # AE and IS replies share the AER slot (mutually exclusive tags)
        aer_ok = torch.where(is_is, 1, ok.to(_I32))
        aer_match = torch.where(is_is, st["snap_len"], match)
        ctx.send(src, AER, [st["term"], aer_ok, aer_match],
                 when=is_ae | is_is)

        # ---- AppendEntries reply (leader side) --------------------------
        is_aer = ((tag == AER) & (st["role"] == LEADER)
                  & (term_in == st["term"]))
        succ = payload[:, 1] == 1
        mlen = payload[:, 2]
        old_match = take1(st["match_idx"], src)
        old_next = take1(st["next_idx"], src)
        new_match = torch.where(is_aer & succ,
                                torch.maximum(old_match, mlen), old_match)
        st["match_idx"] = put_row(st["match_idx"], src, new_match)
        st["next_idx"] = put_row(
            st["next_idx"], src,
            torch.where(is_aer & succ, torch.maximum(old_next, new_match),
                        torch.where(is_aer & ~succ,
                                    torch.clamp(old_next - 1, min=0),
                                    old_next)))
        # advance commit: majority-replicated entries of the current term
        # (§5.4.2); slot k holds absolute entry snap_len + k
        ks = torch.arange(L, dtype=_I32, device=dev)
        abs_idx = _c(st["snap_len"]) + ks                       # [B, L]
        replicated = (st["match_idx"][:, None, :]
                      >= abs_idx[:, :, None] + 1)               # [B, L, N]
        cnt = replicated.sum(-1)
        committable = ((cnt >= majority) & (abs_idx < _c(st["log_len"]))
                       & (st["log_term"] == _c(st["term"])))
        best = torch.where(committable, abs_idx + 1,
                           torch.zeros_like(abs_idx)).max(-1).values
        prev_commit = st["commit"]
        st["commit"] = torch.where(is_aer,
                                   torch.maximum(st["commit"], best),
                                   st["commit"])
        self._on_leader_commit(ctx, st, prev_commit, is_aer)
        self._on_commit_progress(ctx, st, ok | is_aer | inst)

        # ---- election timer reset (vote granted or live leader heard) ---
        self._arm_election(ctx, st, grant | from_leader)
        self._extra_message(ctx, st, src, tag, payload)
        self._maybe_compact(ctx, st, ok | is_aer)
        if self.halt_on_commit:
            ctx.halt_if(st["commit"] >= self.halt_on_commit)
        ctx.state = st


def window_slides_for(raft_kw) -> bool:
    """The `raft_invariant(window_slides=...)` gate: the log window can
    slide iff compaction is enabled."""
    return bool(raft_kw.get("compact_threshold", 0))


def raft_invariant(n_nodes: int, log_capacity: int = 32, fields=("cmd",),
                   raft_nodes=None, window_slides: bool = True):
    """Global safety checks on a batched state, after every event:
    Election Safety and State Machine Safety (via prefix digest chains),
    in the JAX package's two static forms (`window_slides`). The check
    itself is `ops.raft_invariant.raft_invariant_check` (the CUDA kernel
    on the card, its plain version on the CPU); its constant tables are
    built once per device, outside the step."""
    N, L = n_nodes, log_capacity
    peer = (torch.ones((N,), dtype=torch.bool) if raft_nodes is None
            else torch.as_tensor(np.asarray(raft_nodes, bool)))
    powP = _pow_table(L)
    ipowP = _pow_table(L, DIGEST_P_INV)
    consts = {}

    def on(dev):
        if dev not in consts:
            consts[dev] = tuple(t.to(dev) for t in (peer, powP, ipowP))
        return consts[dev]

    def invariant(state):
        ns = state.node_state
        peer_d, powP_d, ipowP_d = on(state.now.device)
        return raft_invariant_check(
            ns["role"], ns["term"], ns["snap_len"], ns["log_len"],
            ns["commit"], ns["snap_digest"], ns["log_term"],
            tuple(ns[f"log_{f}"] for f in fields), peer_d, powP_d, ipowP_d,
            window_slides)

    return invariant


def make_raft_runtime(n_nodes=5, log_capacity=32, n_cmds=8,
                      halt_on_commit=0, scenario=None, cfg=None,
                      device=None, **raft_kw):
    """Convenience constructor for a Raft fuzzing runtime."""
    from ..core.types import SimConfig, sec
    from ..runtime.runtime import Runtime
    if cfg is None:
        cfg = SimConfig(n_nodes=n_nodes, event_capacity=256,
                        time_limit=sec(10))
    prog = Raft(n_nodes, log_capacity, n_cmds, halt_on_commit, **raft_kw)
    return Runtime(cfg, [prog], state_spec(n_nodes, log_capacity),
                   scenario=scenario,
                   invariant=raft_invariant(
                       n_nodes, log_capacity,
                       window_slides=window_slides_for(raft_kw)),
                   persist=persist_spec(), device=device)
