"""The simulation state: one batched struct of tensors.

A `SimState` holds B whole simulated clusters, one per lane: virtual
clock, PRNG key, the event table (timers, in-flight messages and
scheduled supervisor ops), per-node liveness and protocol state, and the
network fault matrix. Every field carries an explicit leading `[B]` lane
axis; the field NAMES, per-lane SHAPES and (exported) DTYPES are those of
`madsim_tpu.core.state.SimState`, including the zero-size leaves of
observation planes that are compiled out, so a state moves between the
two packages leaf for leaf (`madsim_tpu_torch.interop`).

uint32 leaves (`key`, `hash_base`, `sched_hash`, `cov_sketch`) are held
as int32 tensors with the same bits (see core/prng.py); `interop`
exports them as uint32.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from . import types as T
from .device import resolve_device
from .prng import u32

# Observation-only fields: excluded from fingerprints (the JAX package's
# TRACE_FIELDS, same members in the same order).
TRACE_FIELDS = ("trace_on", "trace_pos", "trace_cap", "tr_now", "tr_step",
                "tr_kind", "tr_node", "tr_src", "tr_tag",
                "tr_parent", "tr_lamport", "tr_qlen", "tr_lat", "tr_qw",
                "ev_prov", "lamport",
                "cov_sketch", "sketch_every",
                "pf_on", "pf_dispatch", "pf_busy", "pf_kill", "pf_restart",
                "pf_qmax", "pf_drop", "pf_delay",
                "lh_on", "ev_root_t", "lh_sojourn", "lh_e2e",
                "lh_slo_miss", "slo_target",
                "sr_on", "window_len", "sr_dispatch", "sr_busy", "sr_qhw",
                "sr_drop", "sr_dup", "sr_complete", "sr_slo_miss",
                "sr_lat", "sr_fault",
                "sp_on", "ev_span", "sa_tail", "sa_bottleneck",
                "hash_base")

# fields whose JAX dtype is uint32 (held here as int32 bit patterns)
U32_FIELDS = frozenset({"key", "hash_base", "sched_hash", "cov_sketch"})

N_EV_KINDS = T.EV_SUPER + 1
SA_COMPONENTS = 4


@dataclasses.dataclass
class SimState:
    """B lanes of simulation state; see `madsim_tpu.core.state.SimState`
    for the meaning of every field. Per-lane shapes below, each with a
    leading [B] axis."""

    # clock, rng, lifecycle
    now: Any            # int32
    key: Any            # uint32[2] (int32 bits)
    hash_base: Any      # uint32[2] (int32 bits)
    halted: Any         # bool
    crashed: Any        # bool
    crash_code: Any     # int32
    crash_node: Any     # int32
    oops: Any           # int32 bitmask
    steps: Any          # int32
    sched_hash: Any     # uint32[2] (int32 bits)
    tlimit: Any         # int32
    # event table
    t_deadline: Any     # int32[C]
    t_kind: Any         # int32[C] (int16 with table_dtype="int16")
    t_node: Any         # int32[C] (idem)
    t_src: Any          # int32[C] (idem)
    t_tag: Any          # int32[C]
    t_payload: Any      # int32[C, P]
    # causal lineage (recorder plane; zero-size when compiled out)
    ev_prov: Any        # int32[C, 2]
    lamport: Any        # int32[N]
    # nodes
    alive: Any          # bool[N]
    paused: Any         # bool[N]
    node_state: Any     # dict of [N, ...] leaves
    # network fault matrix
    clog_node: Any      # bool[N]
    clog_link: Any      # bool[N, N]
    loss: Any           # float32
    lat_lo: Any         # int32
    lat_hi: Any         # int32
    jitter: Any         # int32
    # gray-failure and connection-fault planes
    skew: Any           # int32[N]
    disk_lat: Any       # int32[N]
    torn: Any           # bool[N]
    dup_rate: Any       # int32[N]
    # schedule search
    prio_nudge: Any     # int32
    # stats
    msg_sent: Any
    msg_delivered: Any
    msg_dropped: Any
    ev_peak: Any
    # flight-recorder ring
    trace_on: Any
    trace_pos: Any
    trace_cap: Any
    tr_now: Any
    tr_step: Any
    tr_kind: Any
    tr_node: Any
    tr_src: Any
    tr_tag: Any
    tr_parent: Any
    tr_lamport: Any
    tr_qlen: Any
    tr_lat: Any
    # prefix-coverage sketch
    cov_sketch: Any     # uint32[slots] (int32 bits)
    sketch_every: Any
    # sim-profiler counters
    pf_on: Any
    pf_dispatch: Any
    pf_busy: Any
    pf_kill: Any
    pf_restart: Any
    pf_qmax: Any
    pf_drop: Any
    pf_delay: Any
    # SLO latency plane
    lh_on: Any
    ev_root_t: Any
    lh_sojourn: Any
    lh_e2e: Any
    lh_slo_miss: Any
    slo_target: Any
    # windowed telemetry plane
    sr_on: Any
    window_len: Any
    sr_dispatch: Any
    sr_busy: Any
    sr_qhw: Any
    sr_drop: Any
    sr_dup: Any
    sr_complete: Any
    sr_slo_miss: Any
    sr_lat: Any
    sr_fault: Any
    # critical-path attribution plane
    sp_on: Any
    ev_span: Any
    sa_tail: Any
    sa_bottleneck: Any
    tr_qw: Any
    # extensions: name -> state subtree
    ext: Any

    def replace(self, **changes) -> "SimState":
        return dataclasses.replace(self, **changes)

    @classmethod
    def field_names(cls) -> tuple:
        return tuple(f.name for f in dataclasses.fields(cls))


def tree_map(fn, tree, *rest):
    """Map `fn` over the leaves of nested dicts (and bare tensors)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    return fn(tree, *rest)


def map_state(fn, state: SimState) -> SimState:
    """Apply `fn` to every tensor leaf of a state."""
    return SimState(**{f: tree_map(fn, getattr(state, f))
                       for f in SimState.field_names()})


def init_state(cfg: T.SimConfig, node_state: Any, ext_state: Any = None,
               device=None) -> SimState:
    """One lane's fresh state WITHOUT the lane axis (Runtime broadcasts it
    into a batch). `node_state` leaves already carry the leading [N] axis.
    The key is the all-zero placeholder; init_batch writes each lane's.
    `device`: CUDA unless another is named (core/device.py)."""
    C, P, N = cfg.event_capacity, cfg.payload_words, cfg.n_nodes
    i32, b8, dev = torch.int32, torch.bool, resolve_device(device)
    ti = torch.int16 if cfg.table_dtype == "int16" else i32
    tc = cfg.trace_cap_bucket
    lh = cfg.latency_hist
    W = cfg.series_windows

    def z(*shape, dtype=i32):
        return torch.zeros(shape, dtype=dtype, device=dev)

    def c(value, dtype=i32):
        return torch.tensor(value, dtype=dtype, device=dev)

    def full(shape, value, dtype=i32):
        return torch.full(shape, value, dtype=dtype, device=dev)

    nN = N if cfg.profile else 0
    nL = N if lh > 0 else 0
    nS = N if cfg.span_attr else 0
    return SimState(
        now=c(0), key=z(2), hash_base=z(2),
        halted=c(False, b8), crashed=c(False, b8),
        crash_code=c(T.CRASH_NONE), crash_node=c(-1), oops=c(0), steps=c(0),
        # FNV-1a 32 offset basis; low half of the FNV-1a 64 offset basis
        sched_hash=torch.tensor([u32(2166136261), u32(0x84222325)],
                                dtype=i32, device=dev),
        tlimit=c(cfg.time_limit),
        t_deadline=full((C,), int(T.T_INF)),
        t_kind=z(C, dtype=ti), t_node=z(C, dtype=ti), t_src=z(C, dtype=ti),
        t_tag=z(C), t_payload=z(C, P),
        ev_prov=torch.tensor([[-1, 0]], dtype=i32, device=dev).repeat(
            C if cfg.trace_cap > 0 else 0, 1),
        lamport=z(N if cfg.trace_cap > 0 else 0),
        alive=z(N, dtype=b8), paused=z(N, dtype=b8),
        node_state=node_state,
        clog_node=z(N, dtype=b8), clog_link=z(N, N, dtype=b8),
        loss=c(cfg.net.packet_loss_rate, torch.float32),
        lat_lo=c(cfg.net.send_latency_min), lat_hi=c(cfg.net.send_latency_max),
        jitter=c(cfg.net.op_jitter_max),
        skew=z(N), disk_lat=z(N), torn=z(N, dtype=b8), dup_rate=z(N),
        prio_nudge=c(0),
        msg_sent=c(0), msg_delivered=c(0), msg_dropped=c(0), ev_peak=c(0),
        trace_on=c(cfg.trace_cap > 0, b8), trace_pos=c(0),
        trace_cap=c(cfg.trace_cap),
        tr_now=z(tc), tr_step=z(tc), tr_kind=z(tc), tr_node=z(tc),
        tr_src=z(tc), tr_tag=z(tc), tr_parent=z(tc), tr_lamport=z(tc),
        tr_qlen=z(tc if cfg.profile else 0),
        tr_lat=full((tc if lh > 0 else 0,), -1),
        cov_sketch=z(cfg.sketch_slots), sketch_every=c(cfg.sketch_every),
        pf_on=c(cfg.profile, b8), pf_dispatch=z(nN, N_EV_KINDS),
        pf_busy=z(nN), pf_kill=z(nN), pf_restart=z(nN),
        pf_qmax=c(0), pf_drop=c(0), pf_delay=c(0),
        lh_on=c(lh > 0, b8), ev_root_t=full((C if lh > 0 else 0,), -1),
        lh_sojourn=z(nL, lh), lh_e2e=z(nL, lh), lh_slo_miss=z(nL),
        slo_target=c(cfg.slo_target),
        sr_on=c(W > 0, b8), window_len=c(cfg.window_len),
        sr_dispatch=z(W, N), sr_busy=z(W, N), sr_qhw=z(W), sr_drop=z(W),
        sr_dup=z(W), sr_complete=z(W), sr_slo_miss=z(W),
        sr_lat=z(W if lh > 0 else 0, lh), sr_fault=z(W),
        sp_on=c(cfg.span_attr, b8),
        ev_span=torch.tensor([[0, 0, 0, -1, 0, -1]], dtype=i32,
                             device=dev).repeat(
                                 C if cfg.span_attr else 0, 1),
        sa_tail=z(nS, SA_COMPONENTS), sa_bottleneck=z(nS),
        tr_qw=z(tc if cfg.span_attr else 0),
        ext=ext_state if ext_state is not None else {},
    )
