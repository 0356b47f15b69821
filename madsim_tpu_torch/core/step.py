"""The event engine: one batched `step(state) -> (state, record)`.

The counterpart of `madsim_tpu.core.step.make_step` for B lanes held in
explicit [B, ...] tensors. Every lane advances by one event per step:

  1. pick the next event — the earliest eligible deadline, ties broken by
     a threefry draw or the PCT priority nudge — with the `sched_pick`
     kernel (ops/sched_pick.py), and fold it into `sched_hash`;
  2. apply a supervisor op (kill, restart, partition, heal, ...);
  3. run the protocol handlers, merged per lane by one-hot program masks;
  4. write the handlers' emissions (sends with clog / loss / latency,
     timers with skew and disk delay) into free event-table rows, and the
     dispatched event into the flight-recorder ring, with the
     `emit_write` kernel (ops/emit_write.py);
  5. check the end conditions: deadlock, time limit, invariant, halt.

Every branch runs for every lane and masks decide what commits, as in the
JAX package; the PRNG is split in the same static order, so a seed gives
the same trajectory, leaf for leaf, in both packages. With
`cfg.trace_cap > 0` the flight recorder and causal lineage ride along
(the ring, `ev_prov`, `lamport`); they consume no randomness and touch no
other leaf. The other observation planes (profiler, latency, spans,
sketch, series) are not ported yet: `Runtime` refuses configs that
enable them.

The step writes the event table and the ring of the state it is given in
place (section 4, `emit_write`): the rows emissions take and the one ring
row, and no other. Every other leaf of its result is a new tensor or one
the step did not touch. So the step must own its input: the runners step
a private copy of the caller's state (runtime/runtime.py `run`, and
`run_fused`'s static buffers), and a direct call of the step function
writes the caller's tensors.
"""

from __future__ import annotations

import functools
from typing import Any, Callable, Sequence

import numpy as np
import torch

from ..ops import select as sel
from ..ops.emit_write import RING_COLS, TABLE_COLS, drift, emit_write
from ..ops.sched_pick import sched_pick
from . import prng
from . import types as T
from .api import Ctx, Program
from .state import SimState, tree_map

_I32 = torch.int32


def _lane(mask: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A [B] mask reshaped to broadcast against a [B, ...] tensor."""
    return mask.reshape((mask.shape[0],) + (1,) * (like.ndim - 1))


def _where_tree(mask, new, old):
    return tree_map(lambda a, b: torch.where(_lane(mask, b), a, b), new, old)


def _slice_node(tree, node):
    return tree_map(lambda a: sel.take_row(a, node), tree)


def _scatter_node(tree, node, new, mask):
    return tree_map(lambda full, val: sel.put_row(full, node, val, mask),
                    tree, new)


def make_step(cfg: T.SimConfig, programs: Sequence[Program],
              node_prog: np.ndarray, state_spec: Any,
              invariant: Callable | None = None, persist: Any = None,
              halt_when: Callable | None = None, extensions: Sequence = (),
              device="cpu") -> Callable[[SimState], tuple]:
    """Build the batched step function.

    Args:
      cfg: static SimConfig.
      programs: node programs; node i runs programs[node_prog[i]].
      node_prog: int array [N] mapping node -> program index.
      state_spec: one node's default protocol state (dict of tensors, no
        node or lane axis).
      invariant: optional global safety check `f(state) -> (bad [B],
        code [B])`, evaluated after every dispatch.
      persist: optional dict of bools matching state_spec; True leaves are
        stable storage and survive kill/restart.
      halt_when: optional `f(state) -> bool [B]` success condition.
      device: where the step's constant tables live.

    The step function writes its input's event table and ring in place
    (the rows its emissions take, the one ring row it records): hand it
    a state it may overwrite.
    """
    node_prog = np.asarray(node_prog, np.int32)
    assert node_prog.shape == (cfg.n_nodes,)
    assert node_prog.min() >= 0 and node_prog.max() < len(programs)
    node_prog_t = torch.as_tensor(node_prog, device=device)
    N, C, P = cfg.n_nodes, cfg.event_capacity, cfg.payload_words
    spec_default = tree_map(lambda a: torch.as_tensor(a, device=device),
                            state_spec)
    persist_mask = (tree_map(lambda a: False, spec_default)
                    if persist is None else persist)
    use_jitter = cfg.net.op_jitter_max > 0
    trace = cfg.trace_cap > 0
    dup_fold = torch.tensor([0x44555031, 0x44555032], dtype=_I32,
                            device=device)
    per_million = torch.tensor(1e-6, dtype=torch.float32, device=device)

    def live_step(s: SimState):
        B = s.now.shape[0]
        dev = s.now.device
        live = ~s.halted
        keys = prng.split(s.key, 5)
        key = torch.where(live[:, None], keys[:, 0], s.key)
        k_sched = keys[:, 1].contiguous()
        k_super, k_handler, k_net = keys[:, 2], keys[:, 3], keys[:, 4]

        # ---- 1. pick the next event (the sched_pick kernel) ------------
        # ev_node_raw may be NODE_RANDOM
        (idx, dmin, valid, any_ev, sched_hash, ev_kind, ev_node_raw, ev_src,
         ev_tag) = sched_pick(
            s.t_kind, s.t_node, s.t_deadline, s.t_tag, s.t_src, s.alive,
            s.paused, s.prio_nudge, s.halted, k_sched, s.sched_hash)
        ev_node = torch.clamp(ev_node_raw, 0, N - 1)
        ev_payload = sel.take_row(s.t_payload, idx)

        # causal lineage (recorder plane): the dispatched row's provenance
        # — the dispatch that enqueued it (-1: external) and the Lamport
        # clock it carried; selects only, no randomness consumed
        if trace:
            disp_idx = s.steps
            prov = sel.take_row(s.ev_prov, idx)                  # [B, 2]
            ev_parent = torch.where(valid, prov[:, 0],
                                    torch.full_like(prov[:, 0], -1))

        # ---- duplicate delivery: both draws ride keys folded off k_sched
        dup_keys = prng.fold_in(k_sched[:, None, :], dup_fold)   # [B, 2, 2]
        dup_p = (sel.take1(s.dup_rate, ev_node).to(torch.float32)
                 * per_million)
        dup_fire = (valid & (ev_kind == T.EV_MSG)
                    & prng.bernoulli(dup_keys[:, 0], dup_p))

        # pop the slot; the clock never runs backward
        now = torch.where(valid, torch.maximum(s.now, dmin), s.now)
        time_over = now > s.tlimit
        redeliver = now + torch.clamp(
            prng.randint(dup_keys[:, 1], s.lat_lo, s.lat_hi), min=1)
        inf = torch.full_like(now, int(T.T_INF))
        s = s.replace(
            key=key, now=now, sched_hash=sched_hash,
            t_kind=sel.put_row(s.t_kind, idx, T.EV_FREE, valid & ~dup_fire),
            t_deadline=sel.put_row(s.t_deadline, idx,
                                   torch.where(dup_fire, redeliver, inf),
                                   valid))

        # ---- 2. supervisor op -------------------------------------------
        is_super = valid & (ev_kind == T.EV_SUPER)
        op = torch.where(is_super, ev_tag, torch.zeros_like(ev_tag))
        ext_keys = prng.split(k_super, 1 + max(len(extensions), 1))
        s, init_node, reset_target, reset_mask = _apply_super(
            cfg, spec_default, persist_mask, s, op, ev_node_raw, ev_src,
            ev_payload, ext_keys[:, 0])
        if extensions:
            new_ext = dict(s.ext)
            for i, e in enumerate(extensions):
                sub = e.on_op(cfg, new_ext[e.name], op, reset_target,
                              ev_src, ev_payload, ext_keys[:, 1 + i])
                new_ext[e.name] = e.reset_node(cfg, sub, reset_target,
                                               reset_mask)
            s = s.replace(ext=new_ext)

        # Lamport rule at the node the dispatch acted on (for supervisor
        # ops the target _apply_super resolved): max(own, carried) + 1
        if trace:
            lam_node = torch.where(is_super, reset_target, ev_node)
            ev_lamport = torch.maximum(sel.take1(s.lamport, lam_node),
                                       prov[:, 1]) + 1
            s = s.replace(lamport=sel.put_row(s.lamport, lam_node,
                                              ev_lamport, valid))

        # ---- 3. protocol handler dispatch -------------------------------
        node_ok = (sel.take1(s.alive, ev_node)
                   & ~sel.take1(s.paused, ev_node))
        is_msg = valid & (ev_kind == T.EV_MSG) & node_ok
        is_timer = valid & (ev_kind == T.EV_TIMER) & node_ok
        is_init = init_node >= 0
        dropped = valid & (ev_kind == T.EV_MSG) & ~node_ok
        h_node = torch.where(is_init, torch.clamp(init_node, 0, N - 1),
                             ev_node)
        base_slice = _slice_node(s.node_state, h_node)

        # gray-failure reads: the acting node's clock skew and disk stall
        sk_h = sel.take1(s.skew, h_node)
        h_now = s.now + drift(s.now, sk_h)
        dlat_h = sel.take1(s.disk_lat, h_node)

        combos = []  # (mask, ctx) pairs; masks are mutually exclusive
        draws: dict = {}   # handler draw memo (see Ctx)
        h_prog = sel.take1(node_prog_t, h_node)
        for p_idx, prog in enumerate(programs):
            pmask = h_prog == p_idx
            for hkind, run in (
                    (is_init, lambda c: prog.init(c)),
                    (is_msg, lambda c: prog.on_message(c, ev_src, ev_tag,
                                                       ev_payload)),
                    (is_timer, lambda c: prog.on_timer(c, ev_tag,
                                                       ev_payload))):
                ctx = Ctx(cfg, h_node, h_now, k_handler, base_slice,
                          hash_base=s.hash_base, draws=draws)
                run(ctx)
                combos.append((hkind & pmask, ctx))

        any_h = functools.reduce(torch.logical_or, [m for m, _ in combos])
        new_slice = base_slice
        zb = torch.zeros(B, dtype=torch.bool, device=dev)
        zi = torch.zeros(B, dtype=_I32, device=dev)
        crash, crash_code, halt_req = zb, zi, zb
        n_sends = max((len(c._sends) for _, c in combos), default=0)
        n_timers = max((len(c._timers) for _, c in combos), default=0)
        n_cancels = max((len(c._cancels) for _, c in combos), default=0)
        zp = torch.zeros((B, P), dtype=_I32, device=dev)
        sends = [dict(m=zb, dst=zi, tag=zi, payload=zp)
                 for _ in range(n_sends)]
        timers = [dict(m=zb, delay=zi, tag=zi, payload=zp)
                  for _ in range(n_timers)]
        cancels = [dict(m=zb, tag=zi) for _ in range(n_cancels)]
        for m, ctx in combos:
            new_slice = _where_tree(m, ctx.state, new_slice)
            crash = crash | (m & ctx._crash)
            crash_code = torch.where(m & ctx._crash, ctx._crash_code,
                                     crash_code)
            halt_req = halt_req | (m & ctx._halt)
            for staged, effects in ((sends, ctx._sends),
                                    (timers, ctx._timers),
                                    (cancels, ctx._cancels)):
                for j, e in enumerate(effects):
                    e = dict(e, m=e["m"] & m)
                    staged[j] = _where_tree(m, e, staged[j])

        s = s.replace(node_state=_scatter_node(s.node_state, h_node,
                                               new_slice, any_h))

        # timer cancellation first: freed rows are reusable below
        for e in cancels:
            hit = (e["m"][:, None] & (s.t_kind == T.EV_TIMER)
                   & (s.t_node == h_node[:, None])
                   & (s.t_tag == e["tag"][:, None]))
            s = s.replace(
                t_kind=torch.where(hit, torch.zeros_like(s.t_kind),
                                   s.t_kind),
                t_deadline=torch.where(hit, torch.full_like(
                    s.t_deadline, int(T.T_INF)), s.t_deadline))

        # ---- 4. write emissions into the event table (the emit_write
        # kernel), with the flight-recorder ring row as its epilogue
        E = n_sends + n_timers
        if E > 0 or trace:
            if E > 0:
                staged = sends + timers
                em = dict(
                    m=torch.stack([e["m"] for e in staged], -1),
                    a=torch.stack([e["dst"] for e in sends]
                                  + [e["delay"] for e in timers], -1),
                    tag=torch.stack([e["tag"] for e in staged], -1),
                    payload=torch.stack([e["payload"] for e in staged], 1))
            else:
                em = dict(m=zb.new_zeros((B, 0)), a=zi.new_zeros((B, 0)),
                          tag=zi.new_zeros((B, 0)),
                          payload=zi.new_zeros((B, 0, P)))
            lane = dict(now=s.now, h_node=h_node, sk_h=sk_h, dlat_h=dlat_h,
                        loss=s.loss, lat_lo=s.lat_lo, lat_hi=s.lat_hi,
                        jitter=s.jitter, k_net=k_net.contiguous(),
                        clog_node=s.clog_node, clog_link=s.clog_link,
                        disp_idx=disp_idx if trace else zi,
                        ev_lamport=ev_lamport if trace else zi)
            ring = None
            if trace:
                ring = dict(fired=valid, trace_on=s.trace_on,
                            trace_pos=s.trace_pos, trace_cap=s.trace_cap,
                            kind=ev_kind.contiguous(), node=ev_node,
                            src=ev_src.contiguous(),
                            tag=ev_tag.contiguous(), parent=ev_parent,
                            cols={k: getattr(s, k) for k in RING_COLS})
            # the tables and ring columns are written in place
            _, st, ring = emit_write(
                {k: getattr(s, k) for k in TABLE_COLS}, em, lane, ring,
                n_sends, use_jitter)
            if ring is not None:
                s = s.replace(trace_pos=ring["trace_pos"])
            sent, delivered_drop = st["sent"], st["delivered_drop"]
            overflow, high_water = st["overflow"], st["high_water"]
        else:
            sent = delivered_drop = high_water = zi
            overflow = zb

        if cfg.collect_stats:
            s = s.replace(
                msg_sent=s.msg_sent + sent,
                msg_delivered=s.msg_delivered + is_msg.to(_I32),
                msg_dropped=s.msg_dropped + delivered_drop
                + dropped.to(_I32),
                ev_peak=torch.maximum(s.ev_peak, high_water))
        s = s.replace(
            oops=s.oops
            | torch.where(overflow, T.OOPS_EVENT_OVERFLOW, 0).to(_I32)
            | torch.where(s.now > int(T.T_INF) - 64 * T.TICKS_PER_SEC,
                          T.OOPS_TIME_OVERFLOW, 0).to(_I32),
            steps=s.steps + valid.to(_I32))

        # ---- 5. end conditions -------------------------------------------
        crash = crash | ((~any_ev | time_over) & live)
        crash_code = torch.where(
            ~any_ev & live, torch.full_like(crash_code, T.CRASH_DEADLOCK),
            torch.where(time_over & live & (crash_code == 0),
                        torch.full_like(crash_code, T.CRASH_TIME_LIMIT),
                        crash_code))
        halted_now = halt_req | (is_super & (op == T.OP_HALT))
        if halt_when is not None:
            halted_now = halted_now | (halt_when(s) & live)
        if invariant is not None:
            bad, code = invariant(s)
            bad = bad & live
            first = bad & ~crash
            crash_code = torch.where(first, code.to(_I32), crash_code)
            crash = crash | bad
        s = s.replace(
            crashed=s.crashed | crash,
            crash_code=torch.where(crash & (s.crash_code == 0), crash_code,
                                   s.crash_code),
            crash_node=torch.where(crash & (s.crash_node < 0), h_node,
                                   s.crash_node),
            halted=s.halted | halted_now | crash)

        record = dict(now=s.now, kind=ev_kind, node=ev_node, src=ev_src,
                      tag=ev_tag, payload=ev_payload, fired=valid)
        if extensions:
            new_ext = dict(s.ext)
            for e in extensions:
                new_ext[e.name] = e.on_event(cfg, new_ext[e.name], s, record)
            s = s.replace(ext=new_ext)
        return s, record

    return live_step


def _apply_super(cfg, spec_default, persist_mask, s: SimState, op, node,
                 src, payload, key):
    """Apply one supervisor opcode per lane as masked state edits.

    Returns (state, init_node, target, reset_mask); init_node >= 0 asks
    the program's `init` handler to run on that node this step."""
    k = prng.split(key, 2)
    k_t, k_tear = k[:, 0], k[:, 1]
    N, P = cfg.n_nodes, cfg.payload_words
    dev = op.device

    def is_op(*codes):
        return functools.reduce(torch.logical_or, [op == c for c in codes])

    # NODE_RANDOM targets draw from the pool each op can act on; a nonzero
    # payload pool (31 nodes per word) restricts the candidates
    col = lambda m: m[:, None]     # noqa: E731 - [B] -> [B, 1]
    ones = torch.ones((op.shape[0], N), dtype=torch.bool, device=dev)
    pool = torch.where(
        col(is_op(T.OP_KILL, T.OP_PAUSE, T.OP_CLOG_NODE)), s.alive,
        torch.where(col(op == T.OP_RESTART), ~s.alive,
                    torch.where(col(op == T.OP_RESUME), s.paused,
                                torch.where(col(op == T.OP_UNCLOG_NODE),
                                            s.clog_node, ones))))
    ids = torch.arange(N, dtype=_I32, device=dev)
    word = ids // 31
    words = torch.where(word < P, payload[:, word.clamp(max=P - 1)],
                        torch.zeros((), dtype=_I32, device=dev))  # [B, N]
    in_bits = ((words >> (ids % 31)) & 1) == 1
    n_pool_words = min(P, (N + 30) // 31)
    pool = pool & torch.where(
        col((payload[:, :n_pool_words] != 0).any(-1)), in_bits, ones)
    rnd, rnd_ok = sel.masked_choice(k_t, pool)
    is_random = node == T.NODE_RANDOM
    target = torch.clamp(torch.where(is_random, rnd, node), 0, N - 1)
    effective = ~is_random | rnd_ok
    src_c = torch.clamp(src, 0, N - 1)

    def when(cond):
        return cond & effective

    kill = when(is_op(T.OP_KILL, T.OP_RESTART))
    boot = when(is_op(T.OP_INIT, T.OP_RESTART))

    # KILL drops the node's queued messages and timers
    clear = (col(kill) & (s.t_node == col(target))
             & ((s.t_kind == T.EV_MSG) | (s.t_kind == T.EV_TIMER)))
    t_kind = torch.where(clear, torch.zeros_like(s.t_kind), s.t_kind)
    t_deadline = torch.where(clear, torch.full_like(s.t_deadline,
                                                    int(T.T_INF)),
                             s.t_deadline)

    ohT = sel.row_onehot(N, target)                         # [B, N]
    alive = torch.where(ohT & col(kill & ~boot), False,
                        torch.where(ohT & col(boot), True, s.alive))
    paused = torch.where(ohT & col(kill | boot | when(op == T.OP_RESUME)),
                         False,
                         torch.where(ohT & col(when(op == T.OP_PAUSE)), True,
                                     s.paused))

    ns = s.node_state
    # torn-write kill flush (fs-layer state schemas only): a KILL of a
    # live torn-mode node flushes a random prefix of each file's unsynced
    # tail into the durable view
    if isinstance(ns, dict) and {"fs_mem", "fs_mlen", "fs_disk",
                                 "fs_dlen"} <= set(ns):
        tearing = kill & sel.take1(s.torn & s.alive, target)
        mem_t = sel.take_row(ns["fs_mem"], target)      # [B, F, S]
        mlen_t = sel.take_row(ns["fs_mlen"], target)    # [B, F]
        disk_t = sel.take_row(ns["fs_disk"], target)
        dlen_t = sel.take_row(ns["fs_dlen"], target)
        F, S = mem_t.shape[1:]
        gap = torch.clamp(mlen_t - dlen_t, min=0)
        draw = prng.randint_raw(k_tear, 0, 2 ** 30, (F,))
        cut = dlen_t + torch.remainder(draw, gap + 1)
        ws = torch.arange(S, dtype=_I32, device=dev)
        flushed = ((ws >= dlen_t[..., None]) & (ws < cut[..., None]))
        ns = dict(ns,
                  fs_disk=sel.put_row(ns["fs_disk"], target,
                                      torch.where(flushed, mem_t, disk_t),
                                      tearing),
                  fs_dlen=sel.put_row(ns["fs_dlen"], target,
                                      torch.maximum(dlen_t, cut), tearing))

    # connection-fault tear: OP_RESET_PEER closes every conn/stream entry
    # touching the target on both sides and bumps both incarnation epochs
    rp = when(op == T.OP_RESET_PEER)
    if isinstance(ns, dict):
        touched = ((ohT[:, :, None] | ohT[:, None, :])
                   & rp[:, None, None])                     # [B, N, N]

        def _cut(leaf, zero):
            m = touched.reshape(touched.shape + (1,) * (leaf.ndim - 3))
            return torch.where(m, zero, leaf)

        if {"cn_state", "cn_epoch"} <= set(ns):
            ns = dict(ns, cn_state=_cut(ns["cn_state"], 0),
                      cn_epoch=ns["cn_epoch"] + touched.to(_I32))
        if {"sx_seq", "sx_base", "sx_val", "sr_next", "sr_val",
                "sr_have", "st_epoch"} <= set(ns):
            ns = dict(ns,
                      st_epoch=ns["st_epoch"] + touched.to(_I32),
                      sx_seq=_cut(ns["sx_seq"], 0),
                      sx_base=_cut(ns["sx_base"], 0),
                      sr_next=_cut(ns["sr_next"], 0),
                      sx_val=_cut(ns["sx_val"], 0),
                      sr_val=_cut(ns["sr_val"], 0),
                      sr_have=_cut(ns["sr_have"], False))

    # boot/restart resets volatile protocol state to the spec default;
    # persistent leaves (stable storage) survive
    node_state = tree_map(
        lambda full, dflt, keep: full if keep
        else sel.put_row(full, target, dflt.unsqueeze(0), boot),
        ns, spec_default, persist_mask)

    clog_node = torch.where(
        ohT & col(when(op == T.OP_CLOG_NODE)), True,
        torch.where(ohT & col(when(op == T.OP_UNCLOG_NODE)), False,
                    s.clog_node))
    oh_link = sel.row_onehot(N, src_c)[:, :, None] & ohT[:, None, :]
    cube = lambda m: m[:, None, None]   # noqa: E731 - [B] -> [B, 1, 1]
    clog_link = torch.where(
        oh_link & cube(when(op == T.OP_CLOG_LINK)), True,
        torch.where(oh_link & cube(when(op == T.OP_UNCLOG_LINK)), False,
                    s.clog_link))

    # whole-matrix ops: PARTITION replaces the link matrix with the cut
    # A <-> not-A, PARTITION_ONEWAY ORs a directional cut in, HEAL clears
    in_a = in_bits
    cut = in_a[:, :, None] != in_a[:, None, :]
    clog_link = torch.where(cube(when(op == T.OP_PARTITION)), cut, clog_link)
    a_out = in_a[:, :, None] & ~in_a[:, None, :]
    cut_dir = torch.where(cube((src & 1) == 1), a_out.transpose(1, 2), a_out)
    clog_link = torch.where(cube(when(op == T.OP_PARTITION_ONEWAY)),
                            clog_link | cut_dir, clog_link)
    heal = when(op == T.OP_HEAL)
    clog_link = torch.where(cube(heal), False, clog_link)
    clog_node = torch.where(col(heal), False, clog_node)

    loss = torch.where(when(op == T.OP_SET_LOSS),
                       payload[:, 0].to(torch.float32) / 1e6, s.loss)
    set_lat = when(op == T.OP_SET_LATENCY)
    lat_lo = torch.where(set_lat, payload[:, 0], s.lat_lo)
    lat_hi = torch.where(set_lat, torch.maximum(payload[:, 1], payload[:, 0]),
                         s.lat_hi)

    # gray-failure per-node knobs: values ride the TAIL payload words
    last = payload[:, P - 1]
    ohSk = ohT & col(when(op == T.OP_SET_SKEW))
    skew = torch.where(ohSk, col(torch.clamp(last, -T.SKEW_CAP, T.SKEW_CAP)),
                       s.skew)
    ohDk = ohT & col(when(op == T.OP_SET_DISK))
    disk_lat = torch.where(ohDk, col(torch.clamp(last, 0, T.DISK_LAT_CAP)),
                           s.disk_lat)
    torn = torch.where(ohDk, col(payload[:, P - 2] != 0), s.torn)
    ohDup = ohT & col(when(op == T.OP_SET_DUP))
    dup_rate = torch.where(ohDup, col(torch.clamp(last, 0, T.DUP_RATE_CAP)),
                           s.dup_rate)

    init_node = torch.where(boot, target, torch.full_like(target, -1))
    s = s.replace(t_kind=t_kind, t_deadline=t_deadline, alive=alive,
                  paused=paused, node_state=node_state, clog_node=clog_node,
                  clog_link=clog_link, loss=loss, lat_lo=lat_lo,
                  lat_hi=lat_hi, skew=skew, disk_lat=disk_lat, torn=torn,
                  dup_rate=dup_rate)
    return s, init_node, target, kill | boot
