"""The observation fold of one step (K8): the sim profiler's counters
(`pf_*`), the latency plane's histograms (`lh_*`), the prefix-coverage
sketch (`cov_sketch`), the windowed series (`sr_*`) and the span plane's
tail attribution (`sa_*`) of every lane in one launch: `obs_fold`, a
hand-written CUDA kernel (csrc/obs_fold.cu), and `obs_fold_plain`, the
same function in plain PyTorch.

It replaces the XLA-lowered fold blocks of the JAX package's step
(`madsim_tpu/core/step.py` `live_step`: the profiler block at lines
673-714, the latency block at 716-768, the span fold at 770-792, the
sketch at 794-811 and the series fold at 813-902): saturating one-hot
increments over values the step already computed. Per lane, where the
dispatch was valid and the lane's plane gate is on:

  pf_dispatch [N, K]  +1 at (acting node, event kind)
  pf_busy [N]         + now_delta at the acting node
  pf_kill [N]         +1 at the acting node for an effective KILL/RESTART
  pf_restart [N]      +1 at the acting node for an effective INIT/RESTART
  pf_qmax             max(pf_qmax, occ_disp, high_water)
  pf_drop             + delivered_drop + dropped
  pf_delay            + delay_acc
  lh_sojourn [N, LB]  +1 at (acting node, bucket(lat_sojourn))
  lh_e2e [N, LB]      +1 at (completion node, bucket(lat_e2e)) for a
                      completion (gate: lh_on only, as the JAX package)
  lh_slo_miss [N]     +1 at the completion node where slo_target > 0 and
                      lat_e2e > slo_target
  cov_sketch [S]      sched_hash[0] ^ sched_hash[1] into slot ck - 1 where
                      steps == ck * period, 1 <= ck <= S (period =
                      max(sketch_every, 1); no lane gate)
  sr_* [W, ...]       in window w = min(now // max(window_len, 1), W - 1)
                      (gate sr_on): sr_dispatch [W, N] +1 and sr_busy
                      [W, N] + now_delta at the acting node, sr_qhw the
                      max of occ_disp and high_water (not saturating),
                      sr_drop + delivered_drop + dropped, sr_dup +
                      dup_fire, sr_fault |= the SRF_* bits of the op
                      (kill and boot bits only where reset_mask holds);
                      with complete_kinds, for a completion: sr_complete
                      +1, sr_slo_miss +1 on a miss and sr_lat [W, LB] +1
                      at bucket(lat_e2e)
  sa_tail [N, 4]      for a tail completion (sp_on, slo_target > 0,
                      lat_e2e > slo_target): + [1, meas_sq, meas_sn,
                      meas_sh] at the completion node
  sa_bottleneck [N]   +1 at min(meas_dnode, N - 1) for a tail completion
                      where meas_dnode >= 0

Every add saturates at int32 max (`_sat_add`, step.py:46-51); a log2
bucket counts the thresholds 2^j <= d for j < LB - 1, exact in integers.
The acting node is the supervisor op's resolved target for an op,
else the event's node; an acting node out of [0, N) selects nothing, as
the JAX one-hot does. `lat_e2e` is the completion's e2e before the
ring's -1 sentinel (the JAX step's `lat_e2e_raw`); `steps` and
`sched_hash` are the step's values after its select and its increment;
`sketch_every` and `window_len` are read from the state a lane at a
time, so a retune between two runs reaches a captured graph (F7).

Both versions write IN PLACE into the plane leaves they are handed and
touch no other tensor (the step owns its state, ROADMAP F18). The plain
version writes every element of the one-hot the way the JAX package
does; the kernel gives each lane one thread, which reads and writes only
the one element each counter's one-hot selects.

Operands: `plan`, a `FoldPlan` naming which planes are compiled in;
`planes`, a dict of the leaves in LEAVES with the lane axis ([B, 0, ...]
where a plane is compiled out); `ops`, a dict of [B] tensors: BOOL_OPS
(bool), INT_OPS (int32) and `sched_hash` int32 [B, 2]. `has_cpl`: the
config declares complete_kinds.

`obs_fold` takes the plain version only for tensors on the CPU; for CUDA
tensors it launches the kernel or raises. `launches` counts kernel
launches and `captured` launches recorded into a CUDA graph.
"""

from __future__ import annotations

import ctypes

import torch

from ..core import types as T
from .kernels import CKernel, on_cpu

I32_MAX = 2**31 - 1
_I32 = torch.int32

PF_LEAVES = ("pf_dispatch", "pf_busy", "pf_kill", "pf_restart", "pf_qmax",
             "pf_drop", "pf_delay")
LH_LEAVES = ("lh_sojourn", "lh_e2e", "lh_slo_miss")
SK_LEAVES = ("cov_sketch",)
SR_LEAVES = ("sr_dispatch", "sr_busy", "sr_qhw", "sr_drop", "sr_dup",
             "sr_complete", "sr_slo_miss", "sr_lat", "sr_fault")
SP_LEAVES = ("sa_tail", "sa_bottleneck")
LEAVES = PF_LEAVES + LH_LEAVES + SK_LEAVES + SR_LEAVES + SP_LEAVES
BOOL_OPS = ("valid", "pf_on", "lh_on", "reset_mask", "dropped",
            "is_complete", "sr_on", "sp_on", "dup_fire")
INT_OPS = ("act_node", "cpl_node", "ev_kind", "op", "now_delta", "occ_disp",
           "high_water", "delivered_drop", "delay_acc", "lat_sojourn",
           "lat_e2e", "slo_target", "steps", "sketch_every", "window_len",
           "now", "meas_sq", "meas_sn", "meas_sh", "meas_dnode")
SA_COMPONENTS = 4

# the series plane's fault-marker bits (core/types.py SRF_*) of each
# supervisor op class that marks on dispatch
_SRF_OPS = ((T.SRF_PARTITION, (T.OP_CLOG_NODE, T.OP_CLOG_LINK,
                               T.OP_PARTITION, T.OP_PARTITION_ONEWAY)),
            (T.SRF_HEAL, (T.OP_HEAL, T.OP_UNCLOG_NODE, T.OP_UNCLOG_LINK)),
            (T.SRF_NET, (T.OP_SET_LOSS, T.OP_SET_LATENCY)),
            (T.SRF_GRAY, (T.OP_SET_SKEW, T.OP_SET_DISK)),
            (T.SRF_CONN, (T.OP_RESET_PEER, T.OP_SET_DUP)))


def sat_add(a: torch.Tensor, d) -> torch.Tensor:
    """a + d for nonnegative int32 d, saturating at int32 max (the JAX
    step's `_sat_add`; the wrapped sum on the saturating branch is never
    selected)."""
    return torch.where(a > I32_MAX - d, I32_MAX, a + d)


def fault_bits(op: torch.Tensor, reset_mask: torch.Tensor) -> torch.Tensor:
    """int32 [B]: the SRF_* bits of each lane's supervisor op (0 where
    there is none): kill and boot only where the op was effective."""
    kill = reset_mask & ((op == T.OP_KILL) | (op == T.OP_RESTART))
    boot = reset_mask & ((op == T.OP_INIT) | (op == T.OP_RESTART))
    bits = (torch.where(kill, T.SRF_KILL, 0)
            | torch.where(boot, T.SRF_BOOT, 0))
    for bit, ops in _SRF_OPS:
        hit = op == ops[0]
        for o in ops[1:]:
            hit = hit | (op == o)
        bits = bits | torch.where(hit, bit, 0)
    return bits.to(_I32)


class FoldPlan:
    """The fold's shape and its constant tables, built once (ROADMAP
    F4/F7: no constant is built inside a step): which planes are
    compiled in (the profiler and latency planes by their leaves'
    shapes; `sketch_slots`, `windows` and `span` name the sketch, series
    and span groups: with 0 / False the launch does the profiler and
    latency folds alone), the node, kind, bucket, slot and window
    indices and the log2 bucket thresholds 2^j, j < LB - 1."""

    def __init__(self, n_nodes: int, n_kinds: int, buckets: int, device,
                 sketch_slots: int = 0, windows: int = 0,
                 span: bool = False):
        self.N, self.K, self.LB = n_nodes, n_kinds, buckets
        self.S, self.W, self.span = sketch_slots, windows, bool(span)
        self.kinds = torch.arange(n_kinds, dtype=_I32, device=device)
        self.nodes = torch.arange(n_nodes, dtype=_I32, device=device)
        self.bucket_ids = torch.arange(buckets, dtype=_I32, device=device)
        self.slots = torch.arange(sketch_slots, dtype=_I32, device=device)
        self.window_ids = torch.arange(windows, dtype=_I32, device=device)
        self.thresholds = torch.tensor(
            [1 << j for j in range(max(buckets - 1, 0))], dtype=_I32,
            device=device)

    def bucket_onehot(self, d: torch.Tensor) -> torch.Tensor:
        """bool [B, LB]: the one-hot of each lane's log2 bucket of d."""
        b = (d[:, None] >= self.thresholds).sum(-1).to(_I32)
        return self.bucket_ids == b[:, None]


def _fold_pf_lh(plan: FoldPlan, planes: dict, ops: dict, has_cpl: bool):
    valid = ops["valid"]
    act_oh = plan.nodes == ops["act_node"][:, None]           # [B, N]
    if planes["pf_busy"].shape[1] > 0:
        rec = valid & ops["pf_on"]
        k_oh = plan.kinds == ops["ev_kind"][:, None]          # [B, K]
        rm, op = ops["reset_mask"], ops["op"]
        was_kill = rm & ((op == T.OP_KILL) | (op == T.OP_RESTART))
        was_boot = rm & ((op == T.OP_INIT) | (op == T.OP_RESTART))
        oh = act_oh & rec[:, None]
        zero = torch.zeros_like(ops["now_delta"])
        planes["pf_dispatch"].copy_(sat_add(
            planes["pf_dispatch"],
            (oh[:, :, None] & k_oh[:, None, :]).to(_I32)))
        planes["pf_busy"].copy_(sat_add(
            planes["pf_busy"],
            torch.where(oh, ops["now_delta"][:, None], zero[:, None])))
        planes["pf_kill"].copy_(sat_add(
            planes["pf_kill"], (oh & was_kill[:, None]).to(_I32)))
        planes["pf_restart"].copy_(sat_add(
            planes["pf_restart"], (oh & was_boot[:, None]).to(_I32)))
        planes["pf_qmax"].copy_(torch.where(
            rec, torch.maximum(planes["pf_qmax"], torch.maximum(
                ops["occ_disp"], ops["high_water"])), planes["pf_qmax"]))
        planes["pf_drop"].copy_(sat_add(planes["pf_drop"], torch.where(
            rec, ops["delivered_drop"] + ops["dropped"].to(_I32), zero)))
        planes["pf_delay"].copy_(sat_add(
            planes["pf_delay"], torch.where(rec, ops["delay_acc"], zero)))
    if planes["lh_sojourn"].shape[1] > 0:
        rec = valid & ops["lh_on"]
        planes["lh_sojourn"].copy_(sat_add(
            planes["lh_sojourn"],
            (act_oh[:, :, None]
             & plan.bucket_onehot(ops["lat_sojourn"])[:, None, :]
             & rec[:, None, None]).to(_I32)))
        if has_cpl:
            done = ops["is_complete"] & ops["lh_on"]
            lat, target = ops["lat_e2e"], ops["slo_target"]
            miss = done & (target > 0) & (lat > target)
            cpl_oh = plan.nodes == ops["cpl_node"][:, None]   # [B, N]
            planes["lh_e2e"].copy_(sat_add(
                planes["lh_e2e"],
                (cpl_oh[:, :, None] & plan.bucket_onehot(lat)[:, None, :]
                 & done[:, None, None]).to(_I32)))
            planes["lh_slo_miss"].copy_(sat_add(
                planes["lh_slo_miss"], (cpl_oh & miss[:, None]).to(_I32)))


def _fold_span(plan: FoldPlan, planes: dict, ops: dict):
    lat, target = ops["lat_e2e"], ops["slo_target"]
    tail = ops["is_complete"] & ops["sp_on"] & (target > 0) & (lat > target)
    cpl_oh = plan.nodes == ops["cpl_node"][:, None]           # [B, N]
    comp = torch.stack([torch.ones_like(lat), ops["meas_sq"],
                        ops["meas_sn"], ops["meas_sh"]], -1)  # [B, 4]
    planes["sa_tail"].copy_(sat_add(planes["sa_tail"], torch.where(
        (cpl_oh & tail[:, None])[:, :, None], comp[:, None, :], 0)))
    dn = ops["meas_dnode"]
    dom = plan.nodes == torch.clamp(dn, 0, plan.N - 1)[:, None]
    planes["sa_bottleneck"].copy_(sat_add(
        planes["sa_bottleneck"],
        (dom & (tail & (dn >= 0))[:, None]).to(_I32)))


def _fold_sketch(plan: FoldPlan, planes: dict, ops: dict):
    steps = ops["steps"]
    period = torch.clamp(ops["sketch_every"], min=1)
    ck = torch.div(steps, period, rounding_mode="floor")
    at = (ops["valid"] & (steps == ck * period) & (ck >= 1)
          & (ck <= plan.S))
    oh = (plan.slots == torch.clamp(ck - 1, 0, plan.S - 1)[:, None]) \
        & at[:, None]
    sh = ops["sched_hash"]
    planes["cov_sketch"].copy_(torch.where(
        oh, (sh[:, 0] ^ sh[:, 1])[:, None], planes["cov_sketch"]))


def _fold_series(plan: FoldPlan, planes: dict, ops: dict, has_cpl: bool):
    W = plan.W
    rec = ops["valid"] & ops["sr_on"]
    wl = torch.clamp(ops["window_len"], min=1)
    w = torch.clamp(torch.div(ops["now"], wl, rounding_mode="floor"),
                    max=W - 1)
    oh_w = plan.window_ids == w[:, None]                      # [B, W]
    act_oh = plan.nodes == ops["act_node"][:, None]           # [B, N]
    cell = oh_w[:, :, None] & act_oh[:, None, :] & rec[:, None, None]
    ohr = oh_w & rec[:, None]
    planes["sr_dispatch"].copy_(sat_add(planes["sr_dispatch"],
                                        cell.to(_I32)))
    planes["sr_busy"].copy_(sat_add(planes["sr_busy"], torch.where(
        cell, ops["now_delta"][:, None, None], 0)))
    q = torch.maximum(ops["occ_disp"], ops["high_water"])
    planes["sr_qhw"].copy_(torch.where(
        ohr, torch.maximum(planes["sr_qhw"], q[:, None]), planes["sr_qhw"]))
    planes["sr_drop"].copy_(sat_add(planes["sr_drop"], torch.where(
        ohr, (ops["delivered_drop"] + ops["dropped"].to(_I32))[:, None],
        0)))
    planes["sr_dup"].copy_(sat_add(
        planes["sr_dup"], (ohr & ops["dup_fire"][:, None]).to(_I32)))
    bits = fault_bits(ops["op"], ops["reset_mask"])
    planes["sr_fault"].copy_(planes["sr_fault"]
                             | torch.where(ohr, bits[:, None], 0))
    if has_cpl and planes["sr_lat"].shape[2] > 0:
        done = ops["is_complete"] & ops["sr_on"]
        lat, target = ops["lat_e2e"], ops["slo_target"]
        miss = done & (target > 0) & (lat > target)
        planes["sr_complete"].copy_(sat_add(
            planes["sr_complete"], (oh_w & done[:, None]).to(_I32)))
        planes["sr_slo_miss"].copy_(sat_add(
            planes["sr_slo_miss"], (oh_w & miss[:, None]).to(_I32)))
        planes["sr_lat"].copy_(sat_add(planes["sr_lat"], (
            oh_w[:, :, None] & plan.bucket_onehot(lat)[:, None, :]
            & done[:, None, None]).to(_I32)))


def obs_fold_plain(plan: FoldPlan, planes: dict, ops: dict,
                   has_cpl: bool) -> None:
    """Plain PyTorch form of the fold, in place (operands in the module
    doc): the whole one-hot, as the JAX package writes it, in its order
    (the profiler, the latency plane, the spans, the sketch, the
    series)."""
    _fold_pf_lh(plan, planes, ops, has_cpl)
    if plan.span and has_cpl:
        _fold_span(plan, planes, ops)
    if plan.S > 0:
        _fold_sketch(plan, planes, ops)
    if plan.W > 0:
        _fold_series(plan, planes, ops, has_cpl)


class _FoldParams(ctypes.Structure):
    """csrc/obs_fold.cu `FoldParams`, field for field."""
    _fields_ = ([(n, ctypes.c_void_p) for n in LEAVES + BOOL_OPS + INT_OPS]
                + [("sched_hash", ctypes.c_void_p)]
                + [(n, ctypes.c_int) for n in (
                    "B", "N", "K", "LB", "has_pf", "has_lh", "has_cpl",
                    "S", "W", "has_sp")])


class _ObsFold(CKernel):
    """Callable wrapper: CPU tensors -> `obs_fold_plain`; CUDA tensors ->
    the kernel."""

    def __init__(self):
        super().__init__("obs_fold", "obs_fold", _FoldParams)

    def __call__(self, plan: FoldPlan, planes: dict, ops: dict,
                 has_cpl: bool) -> None:
        if on_cpu(ops["valid"], "obs_fold"):
            return obs_fold_plain(plan, planes, ops, has_cpl)
        return self.run(plan, planes, ops, has_cpl)

    def param_block(self, plan: FoldPlan, planes: dict, ops: dict,
                    has_cpl: bool) -> _FoldParams:
        """The parameter block of one launch; raises on what the kernel
        does not take (every operand is written or read where it lies, so
        it must be contiguous, of its dtype and on one device, and every
        leaf of the shape the plan names)."""
        B = ops["valid"].shape[0]
        dev = ops["valid"].device
        N, K, LB, S, W = plan.N, plan.K, plan.LB, plan.S, plan.W
        has_pf = planes["pf_busy"].shape[1] > 0
        has_lh = planes["lh_sojourn"].shape[1] > 0
        if not (has_pf or has_lh or S or W or plan.span):
            raise ValueError("obs_fold: every plane is compiled out")
        if plan.span and not (has_lh and has_cpl):
            raise ValueError("obs_fold: the span group needs the latency "
                             "plane and complete_kinds")
        nP, nL = (N if has_pf else 0), (N if has_lh else 0)
        nS = N if plan.span else 0
        shapes = dict(pf_dispatch=(B, nP, K), pf_busy=(B, nP),
                      pf_kill=(B, nP), pf_restart=(B, nP), pf_qmax=(B,),
                      pf_drop=(B,), pf_delay=(B,),
                      lh_sojourn=(B, nL, LB), lh_e2e=(B, nL, LB),
                      lh_slo_miss=(B, nL), cov_sketch=(B, S),
                      sr_dispatch=(B, W, N), sr_busy=(B, W, N),
                      sr_lat=(B, W if has_lh else 0, LB if has_lh else 0),
                      sa_tail=(B, nS, SA_COMPONENTS), sa_bottleneck=(B, nS))
        for n in ("sr_qhw", "sr_drop", "sr_dup", "sr_complete",
                  "sr_slo_miss", "sr_fault"):
            shapes[n] = (B, W)
        want = ([(n, planes[n], _I32, shapes[n]) for n in LEAVES]
                + [(n, ops[n], torch.bool, (B,)) for n in BOOL_OPS]
                + [(n, ops[n], _I32, (B,)) for n in INT_OPS]
                + [("sched_hash", ops["sched_hash"], _I32, (B, 2))])
        p = _FoldParams(B=B, N=N, K=K, LB=LB, has_pf=int(has_pf),
                        has_lh=int(has_lh), has_cpl=int(has_cpl and has_lh),
                        S=S, W=W, has_sp=int(plan.span))
        for name, t, dtype, shape in want:
            if t.device != dev or t.dtype != dtype \
                    or tuple(t.shape) != shape or not t.is_contiguous():
                raise ValueError(
                    f"obs_fold: {name} is {t.dtype} {tuple(t.shape)} on "
                    f"{t.device} (contiguous: {t.is_contiguous()}); the "
                    f"kernel takes a contiguous {dtype} {shape} on {dev}")
            setattr(p, name, t.data_ptr() if t.numel() else None)
        return p

    def run(self, plan: FoldPlan, planes: dict, ops: dict,
            has_cpl: bool) -> None:
        """The kernel's path, on any device (the CPU tests hand it a
        stand-in launcher). A strided operand is copied, and the copy
        held until the launch (ROADMAP F17); the plane leaves are written
        where they lie."""
        held = {k: v.contiguous() for k, v in ops.items()}
        p = self.param_block(plan, planes, held, has_cpl)
        if p.B:
            self._launch(p, held["valid"].device)


obs_fold = _ObsFold()
