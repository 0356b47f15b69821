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
(the ring, `ev_prov`, `lamport`); they consume no randomness and touch no
other leaf. The other observation planes (profiler, latency, spans,
sketch, series) are not ported yet: `Runtime` refuses configs that
enable them.

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
emissions take and the one ring row). Every other leaf of its result is
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
from ..ops.emit_write import RING_COLS, TABLE_COLS, drift, emit_write
from ..ops.sched_pick import sched_pick
from . import types as T
from .api import Ctx, Program
from .device import resolve_device
from .state import SimState, tree_map

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
            # ev_node_raw may be NODE_RANDOM
            (idx, dmin, valid, any_ev, sched_hash, ev_kind, ev_node_raw,
             ev_src, ev_tag) = sched_pick(
                s.t_kind, s.t_node, s.t_deadline, s.t_tag, s.t_src,
                s.alive, s.paused, s.prio_nudge, s.halted, k_sched,
                s.sched_hash)
            ev_node = torch.clamp(ev_node_raw, 0, N - 1)
            ev_payload = sel.take_row(s.t_payload, idx)

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
            now, time_over, _, deadline, free = tf.dup_draws(
                k_dupf, k_dupd, valid, ev_kind, ev_node, s.dup_rate, s.now,
                dmin, s.lat_lo, s.lat_hi, s.tlimit)
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
                ring = None
                if trace:
                    ring = dict(fired=valid, trace_on=s.trace_on,
                                trace_pos=s.trace_pos,
                                trace_cap=s.trace_cap,
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
