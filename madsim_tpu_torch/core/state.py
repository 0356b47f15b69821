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

import numpy as np
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


# ---------------------------------------------------------------------------
# lane checkpoints (the JAX package's core/state.py lane checkpoint API)
# ---------------------------------------------------------------------------
# Observation planes a checkpoint may be re-seeded into a runtime with a
# different observability build than it was captured under (window replay
# upgrades the ring, profiler and latency planes mid-trajectory). A plane
# adapts as a unit: when every leaf of the plane matches the target
# runtime's shapes and dtypes the checkpoint's values are kept (the
# bit-identical continuation); else the whole plane is re-initialized from
# the target runtime's template. Legal because the planes are
# observation-only (TRACE_FIELDS): they never feed the replay domain.
# hash_base, the one TRACE_FIELDS member outside the planes, is consumed by
# the replay domain (ctx.hash_key) and is always carried over.
_CKPT_PLANES = {
    "ring": ("trace_on", "trace_pos", "trace_cap", "tr_now", "tr_step",
             "tr_kind", "tr_node", "tr_src", "tr_tag", "tr_parent",
             "tr_lamport", "tr_qlen", "tr_lat", "tr_qw"),
    "lineage": ("ev_prov", "lamport"),
    "sketch": ("cov_sketch", "sketch_every"),
    "profile": ("pf_on", "pf_dispatch", "pf_busy", "pf_kill", "pf_restart",
                "pf_qmax", "pf_drop", "pf_delay"),
    "latency": ("lh_on", "ev_root_t", "lh_sojourn", "lh_e2e",
                "lh_slo_miss", "slo_target"),
    "series": ("sr_on", "window_len", "sr_dispatch", "sr_busy", "sr_qhw",
               "sr_drop", "sr_dup", "sr_complete", "sr_slo_miss",
               "sr_lat", "sr_fault"),
    "span": ("sp_on", "ev_span", "sa_tail", "sa_bottleneck"),
}

# The world slice of a structural signature: the fields two runtimes must
# agree on for a checkpoint to continue bit-identically (the version
# string, n_nodes, event_capacity, payload_words, table_dtype,
# collect_stats, the jitter gate). Observability fields may differ: that
# is window replay's upgrade path.
_SIG_WORLD_IDX = (0, 1, 2, 3, 4, 6, 9)

_LANE_CKPT_FORMAT = "madsim-lane-ckpt-r20"


class CheckpointMismatch(ValueError):
    """A LaneCheckpoint does not fit the target runtime's world shape
    (cluster size, event capacity, table dtype, model state schema), or a
    file without the versioned lane-checkpoint header."""


def _world_slice(sig) -> tuple:
    sig = tuple(sig)
    return tuple(sig[i] for i in _SIG_WORLD_IDX if i < len(sig))


def packed_copy(state: SimState, device) -> SimState:
    """A copy of every leaf of `state` on `device` in ONE transfer: the
    leaves' bytes are packed into one buffer (16-byte aligned pieces), the
    buffer is copied, and the result's leaves are views of the copy (owned
    by it alone, sharing nothing with `state`)."""
    leaves = []
    map_state(leaves.append, state)
    src_dev = leaves[0].device
    offs, off = [], 0
    for t in leaves:
        offs.append(off)
        off += -(-(t.numel() * t.element_size()) // 16) * 16
    buf = torch.zeros(max(off, 16), dtype=torch.uint8, device=src_dev)
    for t, o in zip(leaves, offs):
        n = t.numel() * t.element_size()
        if n:
            buf[o:o + n].copy_(t.contiguous().reshape(-1).view(torch.uint8))
    out = buf.to(device, copy=True)
    it = iter(zip(leaves, offs))

    def unpack(_):
        t, o = next(it)
        n = t.numel() * t.element_size()
        return out[o:o + n].view(t.dtype).reshape(t.shape)

    return map_state(unpack, state)


def checkpoint_lane(batch_state: SimState, lane: int,
                    signature=None) -> "LaneCheckpoint":
    """Snapshot ONE lane of a batched SimState: one `lane_take` of [lane]
    over every leaf (the K14 kernel on the card), then one copy to the
    host, owned by the checkpoint (it outlives later in-place steps of the
    batch's buffers).

    `signature` (the capturing runtime's `cfg.structural_signature()`)
    rides along for the save/load contract and the world-shape check in
    `seed_batch_from(rt=...)`; None skips the signature check (leaf shapes
    and dtypes are still checked)."""
    from ..ops.lane_rows import lane_take
    if batch_state.now.ndim < 1:
        raise ValueError("checkpoint_lane takes a BATCHED state "
                         "(leading lane axis); got an unbatched state")
    one = lane_take(batch_state, [int(lane)])
    lane_state = map_state(lambda t: t[0],
                           packed_copy(one, torch.device("cpu")))
    return LaneCheckpoint(state=lane_state, steps=int(lane_state.steps),
                          signature=(tuple(signature)
                                     if signature is not None else None))


@dataclasses.dataclass
class LaneCheckpoint:
    """One lane's full simulation state on the host, without the lane
    axis: everything the step needs to continue the trajectory plus
    whatever observation-plane state the capturing build carried.

    `steps` is the lane's dispatch count at capture; `signature` the
    capturing runtime's structural signature (None when captured without
    one)."""

    state: Any
    steps: int
    signature: tuple | None = None

    def save(self, path: str) -> None:
        """Write the checkpoint as an .npz with the JAX package's versioned
        header (format marker, signature, step count) and its leaves
        `leaf_{i}` in `interop.state_leaves` order with the JAX dtypes, so
        either package's `load` reads it. `__treedef__` lists the leaf
        paths and is never read."""
        from ..interop import state_to_numpy
        leaves = state_to_numpy(self.state)
        np.savez_compressed(
            path,
            __lane_ckpt__=np.frombuffer(_LANE_CKPT_FORMAT.encode(),
                                        dtype=np.uint8),
            __signature__=np.frombuffer(repr(self.signature).encode(),
                                        dtype=np.uint8),
            __steps__=np.asarray(int(self.steps), np.int64),
            __treedef__=np.frombuffer("\n".join(leaves).encode(),
                                      dtype=np.uint8),
            **{f"leaf_{i}": a for i, a in enumerate(leaves.values())})

    @staticmethod
    def load(path: str, rt=None, like: SimState | None = None
             ) -> "LaneCheckpoint":
        """Read a checkpoint written by `save` (of this package or the JAX
        package) onto the host. Pass the runtime it will be seeded into
        (`rt`: the structure and the structural signature) or a
        single-lane `like` state (structure only).

        A file without the lane-checkpoint header (a batch snapshot of
        `runtime.checkpoint.save`) or of another format version raises
        CheckpointMismatch, and so does a stored signature whose world
        slice differs from `rt`'s (observability fields may differ: the
        upgrade is `seed_batch_from`'s) or a leaf count that differs."""
        import ast
        from ..interop import state_from_numpy, state_leaves
        if rt is not None and like is None:
            like = rt._template
        if like is None:
            raise ValueError("LaneCheckpoint.load needs rt= or like= "
                             "to supply the state structure")
        with np.load(path) as z:
            if "__lane_ckpt__" not in z.files:
                raise CheckpointMismatch(
                    f"{path}: no lane-checkpoint header — a pre-r20 "
                    "snapshot (runtime.checkpoint.save batch format?) "
                    "cannot be loaded as a LaneCheckpoint")
            fmt = bytes(z["__lane_ckpt__"]).decode()
            if fmt != _LANE_CKPT_FORMAT:
                raise CheckpointMismatch(
                    f"{path}: lane-checkpoint format {fmt!r} != "
                    f"{_LANE_CKPT_FORMAT!r}")
            sig = ast.literal_eval(bytes(z["__signature__"]).decode())
            steps = int(z["__steps__"])
            # the signature is the world contract: checked before the
            # leaf count, so a foreign world is named as such
            if (rt is not None and sig is not None
                    and _world_slice(sig)
                    != _world_slice(rt.cfg.structural_signature())):
                raise CheckpointMismatch(
                    f"{path}: checkpoint world signature "
                    f"{_world_slice(sig)} != runtime's "
                    f"{_world_slice(rt.cfg.structural_signature())}")
            paths = list(state_leaves(like))
            n = len([k for k in z.files if k.startswith("leaf_")])
            if n != len(paths):
                raise CheckpointMismatch(
                    f"{path}: checkpoint has {n} leaves, target expects "
                    f"{len(paths)} — different world/model?")
            state = state_from_numpy(
                {p: z[f"leaf_{i}"] for i, p in enumerate(paths)},
                torch.device("cpu"))
        return LaneCheckpoint(state=state, steps=steps, signature=sig)


def _spec_equal(a, b) -> bool:
    """Same structure, and every leaf the same shape and dtype."""
    if isinstance(a, dict) or isinstance(b, dict):
        return (isinstance(a, dict) and isinstance(b, dict)
                and sorted(a) == sorted(b)
                and all(_spec_equal(a[k], b[k]) for k in a))
    return tuple(a.shape) == tuple(b.shape) and a.dtype == b.dtype


def seed_batch_from(ckpt: LaneCheckpoint, batch: int, rt=None,
                    reset_planes: tuple = (), device=None) -> SimState:
    """A fresh [batch]-lane SimState, every lane a clone of the
    checkpointed lane, mid-trajectory. With unchanged knobs and nudge each
    lane continues leaf for leaf bit-identical to the parent; perturb lanes
    afterwards (`with_prio_nudge`, `KnobPlan.apply`) to fork the
    trajectory (the prefix-fork primitive).

    rt=None broadcasts the checkpoint verbatim (the caller promises a
    structurally identical runtime). With `rt`, the checkpoint is checked
    against that runtime: every replay-domain leaf must match in shape and
    dtype (CheckpointMismatch otherwise), while observation planes whose
    shape differs are re-initialized from the runtime's template (the
    observability upgrade). `reset_planes` names planes to re-initialize
    even when their shapes match (("ring",) for a window replay that
    starts from an empty ring).

    The plane choice is made on the host, on the one lane; that lane is
    copied to the device (rt.device, else `device`: CUDA unless another is
    named) and broadcast with one `lane_take` of B repeats of lane 0, so
    every leaf of the result owns its memory (the step writes its input in
    place: lanes sharing memory would all take every lane's writes)."""
    from ..ops.lane_rows import lane_take
    unknown = set(reset_planes) - set(_CKPT_PLANES)
    if unknown:
        raise ValueError(f"unknown reset_planes {sorted(unknown)} — "
                         f"valid planes: {sorted(_CKPT_PLANES)}")
    if reset_planes and rt is None:
        # fresh plane values come from the runtime's template
        raise ValueError("reset_planes needs rt= (the reset re-"
                         "initializes planes from the runtime template)")
    src = ckpt.state
    if rt is None:
        merged = src
        dev = resolve_device(device)
    else:
        if ckpt.signature is not None:
            want = _world_slice(rt.cfg.structural_signature())
            got = _world_slice(ckpt.signature)
            if got != want:
                raise CheckpointMismatch(
                    f"checkpoint world signature {got} != runtime's "
                    f"{want} — different cluster/world shape")
        tpl = rt._template
        dev = rt.device
        plane_of = {f: p for p, fs in _CKPT_PLANES.items() for f in fs}
        fresh = {p: (p in reset_planes
                     or not all(_spec_equal(getattr(src, f),
                                            getattr(tpl, f)) for f in fs))
                 for p, fs in _CKPT_PLANES.items()}
        vals = {}
        for f in SimState.field_names():
            s_v, t_v = getattr(src, f), getattr(tpl, f)
            plane = plane_of.get(f)
            if plane is not None:
                vals[f] = (tree_map(lambda t: t.cpu(), t_v) if fresh[plane]
                           else s_v)
                continue
            # a replay-domain leaf (hash_base included) must fit exactly
            if not _spec_equal(s_v, t_v):
                raise CheckpointMismatch(
                    f"checkpoint leaf {f!r} does not fit the target "
                    f"runtime (shape/dtype/structure mismatch) — "
                    f"different world or model schema")
            vals[f] = s_v
        merged = SimState(**vals)
    one = map_state(lambda t: t.unsqueeze(0), packed_copy(merged, dev))
    return lane_take(one, np.zeros(int(batch), np.int64))
