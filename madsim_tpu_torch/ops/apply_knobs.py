"""The knob write: `apply_knobs`, a hand-written CUDA kernel
(csrc/apply_knobs.cu), and `apply_knobs_plain`, the same function in plain
PyTorch.

It replaces the JAX package's `_apply_batch`
(`madsim_tpu/search/mutate.py:499`): write a batch of knob vectors into a
batched init state. Event-table rows n_init .. n_init + R hold the R
scenario rows and the next D rows the dup slots; the bounds are enforced
here, not trusted from the mutator:

  scenario row j  deadline = clip(row_time, 0, tlimit) where time_ok else
                  the base time, or T_INF where the row is off (only
                  droppable rows turn off); kind EV_SUPER or EV_FREE;
                  node = clip(row_node, -1, N - 1) where node_ok, and
                  NODE_RANDOM where that target is outside the row's pool;
                  src = row_flag & 1 where dir_ok; tag = the base opcode;
                  payload = the base payload with word P-1 =
                  clip(row_val, val_lo, val_hi) where val_ok and word P-2 =
                  row_flag & 1 where torn_ok
  dup slot d      the row s = clip(dup_src, 0, R - 1) as written above, at
                  clip(dup_time, 0, tlimit), on where dup_on and s is
                  droppable
  lane scalars    loss = clip(loss, 0, 0.99), lat_lo = clip(lat_lo, 0,
                  LAT_CAP), lat_hi = max(lat_lo, clip(lat_hi, 0, LAT_CAP)),
                  jitter = clip(jitter, 0, JIT_CAP) only with the build's
                  jitter gate (else the state's own), prio_nudge as given

The write works IN PLACE: rows [n_init, n_init + R + D) of the six table
columns in `cols` (t_deadline, t_kind, t_node, t_src, t_tag, t_payload)
are written into those tensors, which are returned as they were handed
in; every other row is left untouched. The five lane scalars (loss,
lat_lo, lat_hi, jitter, prio_nudge) are new [B] tensors. The written rows
depend only on the knobs, the plan and the lane's tlimit and jitter, not
on what the rows held, so writing twice is writing once. A caller that
goes on reading the columns it handed over must hand a copy. Every value
is an integer or a float32 clip, so kernel and plain version agree
exactly.

`apply_knobs` takes the plain version only for tensors on the CPU; for
CUDA tensors it launches the kernel or raises. `launches` counts kernel
launches; a launch recorded into a CUDA graph under capture counts in
`captured` instead.
"""

from __future__ import annotations

import ctypes

import torch

from ..core import types as T
from .mutate import GUARD_KEYS, JIT_CAP, KNOB_KEYS, LAT_CAP, guard_shapes, \
    knob_shapes

TABLE_COLS = ("t_deadline", "t_kind", "t_node", "t_src", "t_tag",
              "t_payload")
BASE_KEYS = ("time", "op", "node", "src", "payload")
SCALARS = ("loss", "lat_lo", "lat_hi", "jitter", "prio_nudge")


def apply_knobs_plain(cols: dict, tlimit, jitter, knobs: dict, base: dict,
                      guards: dict, n_init: int, jitter_gate: bool) -> dict:
    """Plain PyTorch form; see the module doc. `cols` holds the state's
    TABLE_COLS, written in place and returned; `tlimit` and `jitter` its
    [B] scalars; `base` the plan's scenario rows (time, op, node, src
    [R], payload [R, P])."""
    R = base["op"].shape[0]
    P = base["payload"].shape[1]
    N = guards["pool_ok"].shape[1] - 1
    D = knobs["dup_src"].shape[1]
    B = tlimit.shape[0]
    g = guards
    tl = tlimit[:, None]
    row_on = torch.where(g["drop_ok"], knobs["row_on"], True)
    row_time = torch.where(g["time_ok"],
                           torch.minimum(torch.clamp(knobs["row_time"],
                                                     min=0), tl),
                           base["time"])
    row_node = torch.where(g["node_ok"],
                           torch.clamp(knobs["row_node"], -1, N - 1),
                           base["node"])
    lanes = torch.arange(B, device=tlimit.device)[:, None]
    slot = (row_node + 1).long()
    in_pool = ((slot >= 0) & (slot <= N)) & g["pool_ok"][
        torch.arange(R, device=tlimit.device)[None, :],
        slot.clamp(0, N)]
    row_node = torch.where(g["node_ok"] & ~in_pool, T.NODE_RANDOM, row_node)
    row_val = torch.clamp(knobs["row_val"], g["val_lo"], g["val_hi"])
    row_pay = base["payload"].expand(B, R, P).clone()
    row_pay[:, :, P - 1] = torch.where(g["val_ok"], row_val,
                                       row_pay[:, :, P - 1])
    if P >= 2:
        row_pay[:, :, P - 2] = torch.where(g["torn_ok"],
                                           knobs["row_flag"] & 1,
                                           row_pay[:, :, P - 2])
    row_src = torch.where(g["dir_ok"], knobs["row_flag"] & 1, base["src"])
    seg = dict(
        t_deadline=[torch.where(row_on, row_time, int(T.T_INF))],
        t_kind=[torch.where(row_on, T.EV_SUPER, T.EV_FREE).to(torch.int32)],
        t_node=[row_node], t_src=[row_src],
        t_tag=[base["op"].expand(B, R)], t_payload=[row_pay])
    if D > 0:
        dsrc = torch.clamp(knobs["dup_src"], 0, R - 1).long()
        d_ok = knobs["dup_on"] & g["drop_ok"][dsrc]
        dup_time = torch.minimum(torch.clamp(knobs["dup_time"], min=0), tl)
        seg["t_deadline"].append(torch.where(d_ok, dup_time, int(T.T_INF)))
        seg["t_kind"].append(torch.where(d_ok, T.EV_SUPER, T.EV_FREE).to(
            torch.int32))
        seg["t_node"].append(row_node[lanes, dsrc])
        seg["t_src"].append(row_src[lanes, dsrc])
        seg["t_tag"].append(base["op"][dsrc])
        seg["t_payload"].append(row_pay[lanes, dsrc])
    lo, hi = n_init, n_init + R + D
    out = {}
    for name in TABLE_COLS:
        col = cols[name]
        col[:, lo:hi] = torch.cat(seg[name], 1).to(col.dtype)
        out[name] = col
    lat_lo = torch.clamp(knobs["lat_lo"], 0, LAT_CAP)
    out.update(
        loss=torch.clamp(knobs["loss"], 0.0, 0.99),
        lat_lo=lat_lo,
        lat_hi=torch.maximum(lat_lo, torch.clamp(knobs["lat_hi"], 0,
                                                 LAT_CAP)),
        jitter=(torch.clamp(knobs["jitter"], 0, JIT_CAP) if jitter_gate
                else jitter.clone()),
        prio_nudge=knobs["prio_nudge"].clone())
    return out


class _Params(ctypes.Structure):
    """csrc/apply_knobs.cu `ApplyParams`, field for field."""
    _fields_ = (
        [(n, ctypes.c_void_p) for n in TABLE_COLS]
        + [(n, ctypes.c_void_p) for n in ("tlimit", "jitter_in")]
        + [("k_" + n, ctypes.c_void_p) for n in KNOB_KEYS]
        + [("base_" + n, ctypes.c_void_p) for n in BASE_KEYS]
        + [(n, ctypes.c_void_p) for n in GUARD_KEYS]
        + [("o_" + n, ctypes.c_void_p) for n in SCALARS]
        + [(n, ctypes.c_int) for n in ("B", "C", "P", "R", "D", "N",
                                       "n_init", "jitter_gate")])


def _check(name, t, dtype, shape, device):
    if t.device != device:
        raise ValueError(f"apply_knobs: {name} is on {t.device}, expected "
                         f"{device}")
    if t.dtype != dtype:
        raise TypeError(f"apply_knobs: {name} has dtype {t.dtype}, "
                        f"expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"apply_knobs: {name} has shape "
                         f"{tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"apply_knobs: {name} must be contiguous")


class _ApplyKnobs:
    """Callable wrapper: CPU tensors -> `apply_knobs_plain`; CUDA tensors
    -> the kernel. `launches` counts kernel launches (and nothing else);
    `captured` counts launches recorded into a CUDA graph."""

    def __init__(self):
        self.launches = 0
        self.captured = 0
        self._fn = None

    def _kernel(self):
        if self._fn is None:
            from .kernels import load
            fn = load("apply_knobs").apply_knobs_launch
            fn.argtypes = [ctypes.POINTER(_Params), ctypes.c_void_p]
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn

    def __call__(self, cols: dict, tlimit, jitter, knobs: dict, base: dict,
                 guards: dict, n_init: int, jitter_gate: bool) -> dict:
        dev = tlimit.device
        B, C = cols["t_kind"].shape
        R, P = base["payload"].shape
        N = guards["pool_ok"].shape[1] - 1
        D = knobs["dup_src"].shape[1]
        cuda = dev.type == "cuda"
        if cuda and cols["t_kind"].dtype != torch.int32:
            raise NotImplementedError(
                "apply_knobs: the CUDA kernel takes int32 event tables only "
                f"(table_dtype='int32'); got {cols['t_kind'].dtype}")
        if P < 1 or n_init < 0 or n_init + R + D > C:
            raise ValueError(f"apply_knobs: rows {n_init}..{n_init + R + D} "
                             f"do not fit C={C} (P={P})")
        i32 = torch.int32
        checks = [(n, cols[n], cols["t_kind"].dtype if n in (
            "t_kind", "t_node", "t_src") else i32, (B, C))
            for n in TABLE_COLS[:5]]
        checks += [("t_payload", cols["t_payload"], i32, (B, C, P)),
                   ("tlimit", tlimit, i32, (B,)),
                   ("jitter", jitter, i32, (B,))]
        checks += [("knobs." + n, knobs[n], dt, sh)
                   for n, (dt, sh) in knob_shapes(B, R, D).items()]
        checks += [(n, guards[n], dt, sh)
                   for n, (dt, sh) in guard_shapes(R, N).items()]
        checks += [("base." + n, base[n], i32, (R,))
                   for n in BASE_KEYS[:4]]
        checks.append(("base.payload", base["payload"], i32, (R, P)))
        for name, t, dt, shape in checks:
            _check(name, t, dt, shape, dev)
        if dev.type == "cpu":
            return apply_knobs_plain(cols, tlimit, jitter, knobs, base,
                                     guards, n_init, jitter_gate)
        if not cuda:
            raise ValueError(f"apply_knobs: unsupported device {dev}")
        out = {n: cols[n] for n in TABLE_COLS}
        out.update(loss=torch.empty_like(knobs["loss"]),
                   **{n: torch.empty_like(tlimit) for n in SCALARS[1:]})
        p = _Params()
        for n in TABLE_COLS:
            setattr(p, n, cols[n].data_ptr())
        p.tlimit, p.jitter_in = tlimit.data_ptr(), jitter.data_ptr()
        for n in KNOB_KEYS:
            setattr(p, "k_" + n, knobs[n].data_ptr())
        for n in BASE_KEYS:
            setattr(p, "base_" + n, base[n].data_ptr())
        for n in GUARD_KEYS:
            setattr(p, n, guards[n].data_ptr())
        for n in SCALARS:
            setattr(p, "o_" + n, out[n].data_ptr())
        p.B, p.C, p.P, p.R, p.D, p.N = B, C, P, R, D, N
        p.n_init, p.jitter_gate = n_init, int(bool(jitter_gate))
        fn = self._kernel()
        stream = torch.cuda.current_stream(dev).cuda_stream
        with torch.cuda.device(dev):
            err = fn(ctypes.byref(p), stream)
        if err != 0:
            raise RuntimeError(f"apply_knobs: kernel launch failed "
                               f"(cudaError {err})")
        if torch.cuda.is_current_stream_capturing():
            self.captured += 1
        else:
            self.launches += 1
        return out


apply_knobs = _ApplyKnobs()
