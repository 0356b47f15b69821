"""The event engine: one batched `step(state) -> (state, record)`.

The counterpart of `madsim_tpu.core.step.make_step` for B lanes held in
explicit [B, ...] tensors. Every lane advances by one event per step:

  1. pick the next event — the earliest eligible deadline, ties broken by
     a threefry draw or the PCT priority nudge — with the `sched_pick`
     kernel (ops/sched_pick.py), and fold it into `sched_hash`;
  2. apply a supervisor op (kill, restart, partition, heal, ...) with the
     `apply_super` kernel (ops/apply_super.py);
  3. run the protocol handlers, merged per lane by one-hot program masks;
  4. write the handlers' emissions (sends with clog / loss / latency,
     timers with skew and disk delay) into free event-table rows, and the
     dispatched event into the flight-recorder ring, with the
     `emit_write` kernel (ops/emit_write.py);
  5. check the end conditions: deadlock, time limit, invariant (for
     Raft, the `raft_invariant_check` kernel, ops/raft_invariant.py),
     halt.

Every branch runs for every lane and masks decide what commits, as in the
JAX package; the PRNG is split in the same static order, so a seed gives
the same trajectory, leaf for leaf, in both packages. With
`cfg.trace_cap > 0` the flight recorder and causal lineage ride along
(the ring, `ev_prov`, `lamport`); with `cfg.profile` the sim profiler's
counters (`pf_*`, the ring's `tr_qlen`) and with `cfg.latency_hist > 0`
the latency plane (`lh_*`, the root column `ev_root_t`, the ring's
`tr_lat`), with `cfg.sketch_slots > 0` the prefix-coverage sketch
(`cov_sketch`), with `cfg.series_windows > 0` the windowed series
(`sr_*`) and with `cfg.span_attr` the span plane (the carried column
`ev_span`, the ring's `tr_qw`, the tail attribution `sa_*`): their
captures are taken in the select and dup sections (the span plane's
carried read and accumulation in its own `spans` section, plain
PyTorch), `emit_write` writes their table and ring columns, and one
`obs_fold` launch (ops/obs_fold.py) folds every plane after the stats,
before the end checks, so an invariant (`harness.slo.slo_invariant`,
`harness.recovery.recovery_invariant`) sees this dispatch's completion
and window. They consume no randomness and touch no other leaf.

The step's threefry draws outside those kernels go through
`ops/threefry.py`: its own keys (the select's 5-way split, the
duplicate-delivery fold_ins, the supervisor section's extension split)
in one `step_keys` launch in the select section, the duplicate-delivery
section in one `dup_draws` launch, a handler's `Ctx.randint` with int
bounds in one `split_randint` launch and every other handler draw
through `threefry_keys` and `threefry_draw` (the kernels on CUDA); its
node-row slice and writes go through `ops/node_rows.py` (`node_gather`,
`put_rows_`).

The step writes the state it is given in place: the popped event row's
kind and deadline (`put_rows_`), the supervisor op's edits (section 2,
on CUDA: `apply_super` writes the table rows a kill clears, the target's
node vectors, the link matrix, the lane's network scalars and a booted
node's protocol-state rows), with the recorder the acting node's Lamport
clock, the acting node's protocol-state rows (the scatter, `put_rows_`),
and the event table and ring (section 4, `emit_write`: the rows
emissions take and the one ring row), and the observation planes'
leaves (`obs_fold`: the one element of each counter a dispatch
selects).
Every other leaf of its result is
a new tensor or one the step did not touch. So the step must own its
input: the runners step a private copy of the caller's state
(runtime/runtime.py `run`, and `run_fused`'s static buffers), and a
direct call of the step function writes the caller's tensors. Handlers
never write in place: every handler context reads the same slice.

Each section runs inside a profiler range (`_section`), so a profile of
the eager step splits its device time by section; the handlers section
holds finer ranges (`_handler_range`).
"""

from __future__ import annotations

import functools
from typing import Any, Callable, Sequence

import numpy as np
import torch
from torch.profiler import record_function

from ..ops import node_rows as nr
from ..ops import select as sel
from ..ops import threefry as tf
from ..ops.apply_super import SuperPlan, apply_super
from ..ops.emit_write import (PLANE_RING_COLS, PLANE_TABLE_COLS, RING_COLS,
                              TABLE_COLS, drift, emit_write)
from ..ops.obs_fold import LEAVES as FOLD_LEAVES
from ..ops.obs_fold import FoldPlan, obs_fold
from ..ops.sched_pick import sched_pick
from . import types as T
from .api import Ctx, Program
from .device import resolve_device
from .state import N_EV_KINDS, SimState, tree_map

_I32 = torch.int32


def _lane(mask: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A [B] mask reshaped to broadcast against a [B, ...] tensor."""
    return mask.reshape((mask.shape[0],) + (1,) * (like.ndim - 1))


def _where_tree(mask, new, old):
    return tree_map(lambda a, b: torch.where(_lane(mask, b), a, b), new, old)


def _slice_node(tree, node):
    """Every node-state leaf at each lane's `node` (the node_gather
    kernel): new tensors."""
    return nr.node_gather(tree, node)


def _scatter_node(tree, node, new, mask):
    """`new`'s rows into `tree` at each lane's `node` where `mask` holds,
    IN PLACE (the put_rows_ kernel): the step owns its node state."""
    pairs = []
    tree_map(lambda full, val: pairs.append((full, node, val, mask)), tree,
             new)
    written = iter(nr.put_rows_(pairs))
    return tree_map(lambda _: next(written), tree)


# the step's sections, as profiler ranges "live_step.<name>": select, dup,
# super, handlers, scatter, emit, stats, invariant, end. A range is a
# host-side marker: a profiler attributes the device time of the kernels
# launched inside it, and a CUDA graph captures none of it
def _section(name: str):
    return record_function("live_step." + name)


# ranges inside the handlers section, "live_handler.<name>": slice (the
# acting node's slice and reads), p<i>.<kind> (program i's init,
# on_message or on_timer), merge (the per-lane merge of their effects)
def _handler_range(name: str):
    return record_function("live_handler." + name)


def make_step(cfg: T.SimConfig, programs: Sequence[Program],
              node_prog: np.ndarray, state_spec: Any,
              invariant: Callable | None = None, persist: Any = None,
              halt_when: Callable | None = None, extensions: Sequence = (),
              device=None) -> Callable[[SimState], tuple]:
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
      device: where the step's constant tables live: CUDA unless another
        is named (core/device.py; with no GPU and no device, it raises).

    The step function writes its input in place (see the module
    docstring): hand it a state it may overwrite.
    """
    device = resolve_device(device)
    node_prog = np.asarray(node_prog, np.int32)
    assert node_prog.shape == (cfg.n_nodes,)
    assert node_prog.min() >= 0 and node_prog.max() < len(programs)
    for prog in programs:
        prog.validate(cfg)
    node_prog_t = torch.as_tensor(node_prog, device=device)
    N, C, P = cfg.n_nodes, cfg.event_capacity, cfg.payload_words
    spec_default = tree_map(lambda a: torch.as_tensor(a, device=device),
                            state_spec)
    persist_mask = (tree_map(lambda a: False, spec_default)
                    if persist is None else persist)
    use_jitter = cfg.net.op_jitter_max > 0
    trace = cfg.trace_cap > 0
    # the dup section's fold words; the extension split's width, and the
    # extension keys the step reads (only the first without extensions)
    dup_words = (0x44555031, 0x44555032)
    n_ext = 1 + max(len(extensions), 1)
    n_ext_read = n_ext if extensions else 1
    super_plan = SuperPlan(cfg, spec_default, persist_mask)
    profile = cfg.profile
    lh = cfg.latency_hist > 0
    has_cpl = lh and bool(cfg.complete_kinds)
    series = cfg.series_windows > 0
    span = cfg.span_attr
    # the queue depth at dispatch and the clock advance: the profiler's
    # and the series plane's captures
    occ_on = profile or series
    fold_plan = (FoldPlan(N, N_EV_KINDS, cfg.latency_hist, device,
                          sketch_slots=cfg.sketch_slots,
                          windows=cfg.series_windows, span=span)
                 if profile or lh or cfg.sketch_slots > 0 or series
                 or span else None)
    # a row's carried span vector with nothing inherited (SP_QWAIT,
    # SP_NET, SP_HOPS, SP_DOM_NODE, SP_DOM_MAG, SP_EMIT_T)
    span_none = torch.tensor([0, 0, 0, -1, 0, -1], dtype=_I32,
                             device=device)

    def kinds_match(pairs, ev_kind, ev_tag):
        """Whether the dispatched (kind, tag) is one of `pairs`."""
        return functools.reduce(torch.logical_or, [
            (ev_kind == k) & (ev_tag == t) for k, t in pairs])

    def live_step(s: SimState):
        B = s.now.shape[0]
        dev = s.now.device
        # ---- 1. pick the next event (the sched_pick kernel) ------------
        with _section("select"):
            live = ~s.halted
            # every key of the select, dup and super sections, one launch
            (key, k_sched, k_handler, k_net, k_dupf, k_dupd,
             *ext_keys) = tf.step_keys(s.key, s.halted, dup_words, n_ext,
                                       n_ext_read)
            # ev_node_raw may be NODE_RANDOM; with the profiler the select
            # also counts the occupied rows before the pop (its queue depth
            # at dispatch, so the dispatched row counts)
            (idx, dmin, valid, any_ev, sched_hash, ev_kind, ev_node_raw,
             ev_src, ev_tag, *occ) = sched_pick(
                s.t_kind, s.t_node, s.t_deadline, s.t_tag, s.t_src,
                s.alive, s.paused, s.prio_nudge, s.halted, k_sched,
                s.sched_hash, *((True,) if occ_on else ()))
            ev_node = torch.clamp(ev_node_raw, 0, N - 1)
            ev_payload = sel.take_row(s.t_payload, idx)
            if occ_on:
                (occ_disp,) = occ
            # the latency plane's root read, before the pop and emissions
            # (this dispatch may reuse its own row)
            if lh:
                root_raw = sel.take1(s.ev_root_t, idx)

            # causal lineage (recorder plane): the dispatched row's
            # provenance — the dispatch that enqueued it (-1: external) and
            # the Lamport clock it carried; selects only, no randomness
            if trace:
                disp_idx = s.steps
                prov = sel.take_row(s.ev_prov, idx)              # [B, 2]
                ev_parent = torch.where(valid, prov[:, 0],
                                        torch.full_like(prov[:, 0], -1))

        # ---- duplicate delivery: both draws ride keys folded off k_sched
        # (the dup_draws kernel: the clock, the end of time, the Bernoulli
        # and the redelivery's latency draw in one launch)
        with _section("dup"):
            now, time_over, dup_fire, deadline, free = tf.dup_draws(
                k_dupf, k_dupd, valid, ev_kind, ev_node, s.dup_rate, s.now,
                dmin, s.lat_lo, s.lat_hi, s.tlimit)
            if occ_on:
                now_delta = now - s.now        # >= 0; 0 when not valid
            if lh:
                # the root a row with an unset root (-1: an external
                # cause) mints at dispatch; a completion measures against
                # the inherited root, emissions carry the post-mint one
                # (a root kind re-mints on an inherited chain)
                inherit = valid & (root_raw >= 0)
                root_measured = torch.where(inherit, root_raw, now)
                if cfg.root_kinds:
                    inherit = inherit & ~kinds_match(cfg.root_kinds,
                                                     ev_kind, ev_tag)
                ev_root = torch.where(inherit, root_raw, now)
                lat_sojourn = torch.clamp(
                    torch.where(valid, now - dmin, 0), min=0)
                if has_cpl:
                    is_complete = valid & kinds_match(cfg.complete_kinds,
                                                      ev_kind, ev_tag)
                    lat_e2e = torch.clamp(now - root_measured, min=0)
                    # the ring's latency value: a completion's e2e, else -1
                    lat_ring = torch.where(is_complete, lat_e2e, -1)
                else:
                    lat_ring = torch.full_like(now, -1)
            # pop the slot, or re-arm it at the redelivery
            t_kind, t_deadline = nr.put_rows_([
                (s.t_kind, idx, T.EV_FREE, free),
                (s.t_deadline, idx, deadline, valid)])
            s = s.replace(key=key, now=now, sched_hash=sched_hash,
                          t_kind=t_kind, t_deadline=t_deadline)

        # ---- 2. supervisor op (the apply_super kernel) -------------------
        with _section("super"):
            is_super = valid & (ev_kind == T.EV_SUPER)
            op = torch.where(is_super, ev_tag, torch.zeros_like(ev_tag))
            s, init_node, reset_target, reset_mask = apply_super(
                super_plan, s, op, ev_node_raw.contiguous(),
                ev_src.contiguous(), ev_payload, ext_keys[0])
            if extensions:
                new_ext = dict(s.ext)
                for i, e in enumerate(extensions):
                    sub = e.on_op(cfg, new_ext[e.name], op, reset_target,
                                  ev_src, ev_payload, ext_keys[1 + i])
                    new_ext[e.name] = e.reset_node(cfg, sub, reset_target,
                                                   reset_mask)
                s = s.replace(ext=new_ext)

            # Lamport rule at the node the dispatch acted on (for
            # supervisor ops the target apply_super resolved):
            # max(own, carried) + 1
            if trace:
                lam_node = torch.where(is_super, reset_target, ev_node)
                ev_lamport = torch.maximum(sel.take1(s.lamport, lam_node),
                                           prov[:, 1]) + 1
                (lamport,) = nr.put_rows_([(s.lamport, lam_node, ev_lamport,
                                            valid)])
                s = s.replace(lamport=lamport)

        # ---- the span plane's carried read and accumulation (plain
        # PyTorch): the dispatched row's carried vector (only emissions
        # write ev_span, so the pop and the op left it as it was), the
        # incoming edge's transit, and this hop folded into the chain
        if span:
            with _section("spans"):
                # the carried vector follows the root's split: the
                # completion measures the inherited chain (pre-mint),
                # emissions carry the post-mint one
                inherit_sp = valid & (root_raw >= 0)
                in_sq, in_sn, in_sh, in_dnode, in_dmag, in_emit = \
                    torch.where(inherit_sp[:, None],
                                sel.take_row(s.ev_span, idx),
                                span_none).unbind(1)
                net_seg = torch.where(inherit_sp & (in_emit >= 0),
                                      torch.clamp(dmin - in_emit, min=0), 0)
                act_sp = torch.where(is_super, reset_target, ev_node)
                meas_sq = torch.where(inherit_sp, in_sq + lat_sojourn, 0)
                meas_sn = torch.where(inherit_sp, in_sn + net_seg, 0)
                meas_sh = in_sh
                seg_sp = net_seg + lat_sojourn          # this hop's cost
                dom_up = inherit_sp & (seg_sp > in_dmag)     # strict >
                meas_dnode = torch.where(dom_up, act_sp, in_dnode)
                meas_dmag = torch.where(dom_up, seg_sp, in_dmag)
                # what this dispatch's emissions carry: a re-minted root
                # restarts at zero, the hop index is this one's plus one,
                # every emission is stamped with this dispatch's `now`
                span_new = torch.stack([
                    torch.where(inherit, meas_sq, 0),
                    torch.where(inherit, meas_sn, 0),
                    torch.where(inherit, meas_sh, 0) + 1,
                    torch.where(inherit, meas_dnode, -1),
                    torch.where(inherit, meas_dmag, 0), s.now], -1)

        # ---- 3. protocol handler dispatch -------------------------------
        with _section("handlers"):
            with _handler_range("slice"):
                node_ok = (sel.take1(s.alive, ev_node)
                           & ~sel.take1(s.paused, ev_node))
                is_msg = valid & (ev_kind == T.EV_MSG) & node_ok
                is_timer = valid & (ev_kind == T.EV_TIMER) & node_ok
                is_init = init_node >= 0
                dropped = valid & (ev_kind == T.EV_MSG) & ~node_ok
                h_node = torch.where(is_init,
                                     torch.clamp(init_node, 0, N - 1),
                                     ev_node)
                base_slice = _slice_node(s.node_state, h_node)

                # gray-failure reads: the acting node's clock skew, disk
                # stall
                sk_h = sel.take1(s.skew, h_node)
                h_now = s.now + drift(s.now, sk_h)
                dlat_h = sel.take1(s.disk_lat, h_node)
                h_prog = sel.take1(node_prog_t, h_node)
                pmasks = [h_prog == p for p in range(len(programs))]

            combos = []  # (mask, ctx) pairs; masks are mutually exclusive
            draws: dict = {}   # handler draw memo (see Ctx)
            for p_idx, prog in enumerate(programs):
                for kind, hkind, run in (
                        ("init", is_init, lambda c: prog.init(c)),
                        ("on_message", is_msg, lambda c: prog.on_message(
                            c, ev_src, ev_tag, ev_payload)),
                        ("on_timer", is_timer, lambda c: prog.on_timer(
                            c, ev_tag, ev_payload))):
                    with _handler_range(f"p{p_idx}.{kind}"):
                        ctx = Ctx(cfg, h_node, h_now, k_handler, base_slice,
                                  hash_base=s.hash_base, draws=draws)
                        run(ctx)
                        combos.append((hkind & pmasks[p_idx], ctx))

            with _handler_range("merge"):
                any_h = functools.reduce(torch.logical_or,
                                         [m for m, _ in combos])
                new_slice = base_slice
                zb = torch.zeros(B, dtype=torch.bool, device=dev)
                zi = torch.zeros(B, dtype=_I32, device=dev)
                crash, crash_code, halt_req = zb, zi, zb
                n_sends = max((len(c._sends) for _, c in combos), default=0)
                n_timers = max((len(c._timers) for _, c in combos),
                               default=0)
                n_cancels = max((len(c._cancels) for _, c in combos),
                                default=0)
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

        with _section("scatter"):
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
        with _section("emit"):
            E = n_sends + n_timers
            if E > 0 or trace:
                if E > 0:
                    staged = sends + timers
                    em = dict(
                        m=torch.stack([e["m"] for e in staged], -1),
                        a=torch.stack([e["dst"] for e in sends]
                                      + [e["delay"] for e in timers], -1),
                        tag=torch.stack([e["tag"] for e in staged], -1),
                        payload=torch.stack([e["payload"] for e in staged],
                                            1))
                else:
                    em = dict(m=zb.new_zeros((B, 0)),
                              a=zi.new_zeros((B, 0)),
                              tag=zi.new_zeros((B, 0)),
                              payload=zi.new_zeros((B, 0, P)))
                lane = dict(now=s.now, h_node=h_node, sk_h=sk_h,
                            dlat_h=dlat_h, loss=s.loss, lat_lo=s.lat_lo,
                            lat_hi=s.lat_hi, jitter=s.jitter,
                            k_net=k_net,
                            clog_node=s.clog_node, clog_link=s.clog_link,
                            disp_idx=disp_idx if trace else zi,
                            ev_lamport=ev_lamport if trace else zi)
                if profile:
                    lane["occ_disp"] = occ_disp
                if lh:
                    lane.update(ev_root=ev_root, lat_ring=lat_ring)
                if span:
                    lane.update(span_new=span_new, lat_sojourn=lat_sojourn)
                ring = None
                if trace:
                    ring = dict(fired=valid, trace_on=s.trace_on,
                                trace_pos=s.trace_pos,
                                trace_cap=s.trace_cap,
                                kind=ev_kind.contiguous(), node=ev_node,
                                src=ev_src.contiguous(),
                                tag=ev_tag.contiguous(), parent=ev_parent,
                                cols={k: getattr(s, k)
                                      for k in RING_COLS + PLANE_RING_COLS})
                # the tables and ring columns are written in place
                # (the delay sum, a seventh operand, only with the
                # profiler)
                _, st, ring = emit_write(
                    {k: getattr(s, k) for k in TABLE_COLS + PLANE_TABLE_COLS},
                    em, lane, ring, n_sends, use_jitter,
                    *((True,) if profile else ()))
                if ring is not None:
                    s = s.replace(trace_pos=ring["trace_pos"])
                sent, delivered_drop = st["sent"], st["delivered_drop"]
                overflow, high_water = st["overflow"], st["high_water"]
                delay_acc = st.get("delay_acc", zi)
            else:
                sent = delivered_drop = high_water = delay_acc = zi
                overflow = zb

        with _section("stats"):
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

        # ---- the observation folds (the obs_fold kernel), in place,
        # before the end checks; the sketch reads the post-select hash and
        # the incremented step count
        if fold_plan is not None:
            with _section("obs"):
                act = torch.where(is_super, reset_target, ev_node)
                obs_fold(fold_plan, {k: getattr(s, k) for k in FOLD_LEAVES},
                         dict(valid=valid, pf_on=s.pf_on, lh_on=s.lh_on,
                              reset_mask=reset_mask, dropped=dropped,
                              is_complete=is_complete if has_cpl else zb,
                              sr_on=s.sr_on, sp_on=s.sp_on,
                              dup_fire=dup_fire,
                              act_node=act, cpl_node=ev_node,
                              ev_kind=ev_kind, op=op,
                              now_delta=now_delta if occ_on else zi,
                              occ_disp=occ_disp if occ_on else zi,
                              high_water=high_water,
                              delivered_drop=delivered_drop,
                              delay_acc=delay_acc,
                              lat_sojourn=lat_sojourn if lh else zi,
                              lat_e2e=lat_e2e if has_cpl else zi,
                              slo_target=s.slo_target, steps=s.steps,
                              sketch_every=s.sketch_every,
                              window_len=s.window_len, now=s.now,
                              meas_sq=meas_sq if span else zi,
                              meas_sn=meas_sn if span else zi,
                              meas_sh=meas_sh if span else zi,
                              meas_dnode=meas_dnode if span else zi,
                              sched_hash=s.sched_hash), has_cpl)

        # ---- 5. end conditions -------------------------------------------
        with _section("end"):
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
            with _section("invariant"):
                bad, code = invariant(s)
                bad = bad & live
                first = bad & ~crash
                crash_code = torch.where(first, code.to(_I32), crash_code)
                crash = crash | bad
        with _section("end"):
            s = s.replace(
                crashed=s.crashed | crash,
                crash_code=torch.where(crash & (s.crash_code == 0),
                                       crash_code, s.crash_code),
                crash_node=torch.where(crash & (s.crash_node < 0), h_node,
                                       s.crash_node),
                halted=s.halted | halted_now | crash)

            record = dict(now=s.now, kind=ev_kind, node=ev_node, src=ev_src,
                          tag=ev_tag, payload=ev_payload, fired=valid)
            if extensions:
                new_ext = dict(s.ext)
                for e in extensions:
                    new_ext[e.name] = e.on_event(cfg, new_ext[e.name], s,
                                                 record)
                s = s.replace(ext=new_ext)
        return s, record

    return live_step
