"""The observation fold of one step (K8): the sim profiler's counters
(`pf_*`) and the latency plane's histograms (`lh_*`) of every lane in one
launch: `obs_fold`, a hand-written CUDA kernel (csrc/obs_fold.cu), and
`obs_fold_plain`, the same function in plain PyTorch.

It replaces the XLA-lowered fold blocks of the JAX package's step
(`madsim_tpu/core/step.py` `live_step`, the profiler block at lines
673-714 and the latency block at 716-768): saturating one-hot increments
over values the step already computed. Per lane, where the dispatch was
valid and the lane's plane gate is on:

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

Every add saturates at int32 max (`_sat_add`, step.py:46-51); a log2
bucket counts the thresholds 2^j <= d for j < LB - 1, exact in integers.
The acting node is the supervisor op's resolved target for an op,
else the event's node; an acting node out of [0, N) selects nothing, as
the JAX one-hot does.

Both versions write IN PLACE into the plane leaves they are handed and
touch no other tensor (the step owns its state, ROADMAP F18). The plain
version writes every element of the one-hot the way the JAX package
does; the kernel gives each lane one thread, which reads and writes only
the one element each counter's one-hot selects.

Operands: `planes`, a dict of the ten leaves above with the lane axis
([B, 0, ...] when a plane is compiled out; both may not be); `ops`, a
dict of [B] tensors: valid, pf_on, lh_on, reset_mask, dropped,
is_complete (bool), act_node, cpl_node, ev_kind, op, now_delta,
occ_disp, high_water, delivered_drop, delay_acc, lat_sojourn, lat_e2e,
slo_target (int32). `has_cpl`: the config declares complete_kinds.

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
LEAVES = PF_LEAVES + LH_LEAVES
BOOL_OPS = ("valid", "pf_on", "lh_on", "reset_mask", "dropped",
            "is_complete")
INT_OPS = ("act_node", "cpl_node", "ev_kind", "op", "now_delta", "occ_disp",
           "high_water", "delivered_drop", "delay_acc", "lat_sojourn",
           "lat_e2e", "slo_target")


def sat_add(a: torch.Tensor, d) -> torch.Tensor:
    """a + d for nonnegative int32 d, saturating at int32 max (the JAX
    step's `_sat_add`; the wrapped sum on the saturating branch is never
    selected)."""
    return torch.where(a > I32_MAX - d, I32_MAX, a + d)


class FoldPlan:
    """The fold's constant tables, built once (ROADMAP F4/F7: no
    constant is built inside a step): the node, kind and bucket indices
    and the log2 bucket thresholds 2^j, j < LB - 1."""

    def __init__(self, n_nodes: int, n_kinds: int, buckets: int, device):
        self.N, self.K, self.LB = n_nodes, n_kinds, buckets
        self.kinds = torch.arange(n_kinds, dtype=_I32, device=device)
        self.nodes = torch.arange(n_nodes, dtype=_I32, device=device)
        self.bucket_ids = torch.arange(buckets, dtype=_I32, device=device)
        self.thresholds = torch.tensor(
            [1 << j for j in range(max(buckets - 1, 0))], dtype=_I32,
            device=device)

    def bucket_onehot(self, d: torch.Tensor) -> torch.Tensor:
        """bool [B, LB]: the one-hot of each lane's log2 bucket of d."""
        b = (d[:, None] >= self.thresholds).sum(-1).to(_I32)
        return self.bucket_ids == b[:, None]


def obs_fold_plain(plan: FoldPlan, planes: dict, ops: dict,
                   has_cpl: bool) -> None:
    """Plain PyTorch form of the fold, in place (operands in the module
    doc): the whole one-hot, as the JAX package writes it."""
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


class _FoldParams(ctypes.Structure):
    """csrc/obs_fold.cu `FoldParams`, field for field."""
    _fields_ = ([(n, ctypes.c_void_p) for n in LEAVES + BOOL_OPS + INT_OPS]
                + [(n, ctypes.c_int) for n in (
                    "B", "N", "K", "LB", "has_pf", "has_lh", "has_cpl")])


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
        it must be contiguous, of its dtype and on one device)."""
        B = ops["valid"].shape[0]
        dev = ops["valid"].device
        N, K, LB = plan.N, plan.K, plan.LB
        has_pf = planes["pf_busy"].shape[1] > 0
        has_lh = planes["lh_sojourn"].shape[1] > 0
        if not (has_pf or has_lh):
            raise ValueError("obs_fold: both planes are compiled out")
        nP, nL = (N if has_pf else 0), (N if has_lh else 0)
        shapes = dict(pf_dispatch=(B, nP, K), pf_busy=(B, nP),
                      pf_kill=(B, nP), pf_restart=(B, nP), pf_qmax=(B,),
                      pf_drop=(B,), pf_delay=(B,),
                      lh_sojourn=(B, nL, LB), lh_e2e=(B, nL, LB),
                      lh_slo_miss=(B, nL))
        want = ([(n, planes[n], _I32, shapes[n]) for n in LEAVES]
                + [(n, ops[n], torch.bool, (B,)) for n in BOOL_OPS]
                + [(n, ops[n], _I32, (B,)) for n in INT_OPS])
        p = _FoldParams(B=B, N=N, K=K, LB=LB, has_pf=int(has_pf),
                        has_lh=int(has_lh), has_cpl=int(has_cpl and has_lh))
        for name, t, dtype, shape in want:
            if t.device != dev or t.dtype != dtype \
                    or tuple(t.shape) != shape or not t.is_contiguous():
                raise ValueError(
                    f"obs_fold: {name} is {t.dtype} {tuple(t.shape)} on "
                    f"{t.device} (contiguous: {t.is_contiguous()}); the "
                    f"kernel takes a contiguous {dtype} {shape} on {dev}")
            setattr(p, name, t.data_ptr())
        return p

    def run(self, plan: FoldPlan, planes: dict, ops: dict,
            has_cpl: bool) -> None:
        """The kernel's path, on any device (the CPU tests hand it a
        stand-in launcher). A strided [B] operand is copied, and the copy
        held until the launch (ROADMAP F17); the plane leaves are written
        where they lie."""
        held = {k: v.contiguous() for k, v in ops.items()}
        p = self.param_block(plan, planes, held, has_cpl)
        if p.B:
            self._launch(p, held["valid"].device)


obs_fold = _ObsFold()
