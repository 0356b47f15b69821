"""The event select of one step: `sched_pick`, a hand-written CUDA kernel
(csrc/sched_pick.cu), and `sched_pick_plain`, the same function in plain
PyTorch.

It replaces the XLA-lowered select of the JAX package's step
(`madsim_tpu/core/step.py` `live_step` section 1, lines 141-232): pick
each lane's next event — the earliest eligible deadline, ties broken by a
threefry draw or, where `prio_nudge != 0`, by a priority hash — and fold
the picked event into the lane's two-word `sched_hash`. With
`occupancy=True` (the sim profiler) it also counts each lane's occupied
rows before the pop (`madsim_tpu/core/step.py:187-188` `occ_disp`), which
the kernel does from the rows it already stages. Every value is an
integer, so kernel and plain version agree exactly.

`sched_pick` takes the plain version only for tensors on the CPU; for
CUDA tensors it launches the kernel or raises. `sched_pick.launches`
counts kernel launches (a launch recorded into a CUDA graph under capture
counts in `sched_pick.captured` instead: a replay launches it again
without calling the wrapper). Keys and hashes are int32 bit patterns, the
representation of uint32 words throughout the engine.
"""

from __future__ import annotations

import ctypes

import torch

from ..core import types as T
from ..core.prng import shr, to_u64, u32
from . import select as sel

MAX_C = 256   # a thread of the kernel reduces C / 16 rows of a lane
MAX_N = 32    # the parked nodes of a lane are one 32-bit mask


def _mix(a, b, c, d, ma, mb, mc, md):
    return a * u32(ma) ^ b * u32(mb) ^ c * u32(mc) ^ d * u32(md)


def eligible_min(t_kind, t_node, t_deadline, alive, paused):
    """The earliest eligible deadline of each lane: an event is eligible
    when its slot is occupied and it is not parked on an alive, paused node
    (supervisor events are never parked). Returns (dmin int32 [B], at_min
    bool [B, C], any_ev bool [B])."""
    N = alive.shape[1]
    tnode = torch.clamp(t_node, 0, N - 1)
    parked = (sel.take1(alive & paused, tnode)
              & (t_kind != T.EV_SUPER))
    eligible = (t_kind != T.EV_FREE) & ~parked
    return sel.min_deadline(t_deadline, eligible, T.T_INF)


def sched_pick_plain(t_kind, t_node, t_deadline, t_tag, t_src, alive,
                     paused, prio_nudge, halted, k_sched, sched_hash,
                     occupancy: bool = False):
    """Plain PyTorch form of the select. Shapes: tables [B, C]; alive,
    paused [B, N]; prio_nudge, halted [B]; k_sched, sched_hash [B, 2]
    (uint32 bit patterns in int32). Returns (idx, dmin, valid, any_ev,
    sched_hash, ev_kind, ev_node, ev_src, ev_tag): idx/dmin int32 [B],
    valid/any_ev bool [B], the new sched_hash int32 [B, 2], and the picked
    row's kind (EV_FREE unless valid), node (unclipped), src and tag, int32
    [B]; with `occupancy`, then the count of occupied rows, int32 [B]."""
    N = alive.shape[1]
    C = t_kind.shape[1]
    dmin, at_min, any_ev = eligible_min(t_kind, t_node, t_deadline, alive,
                                        paused)
    idx, picked = sel.masked_choice(k_sched, at_min)

    # the PCT nudge: a deterministic priority argmax over the ties
    rows = torch.arange(C, dtype=torch.int32, device=t_kind.device)
    prio = _mix(t_tag, t_node.to(torch.int32), rows, prio_nudge[:, None],
                0x9E3779B1, 0x85EBCA77, 0xC2B2AE3D, 0x27D4EB2F)
    prio = (prio ^ shr(prio, 15)) * u32(0x2C1B3C6D)
    cand = torch.where(at_min, to_u64(prio | 1), 0)
    nudged = torch.argmax(cand, -1).to(torch.int32)
    idx = torch.where(prio_nudge != 0, nudged, idx)
    valid = picked & any_ev & ~halted

    ev_kind = torch.where(valid, sel.take1(t_kind, idx).to(torch.int32),
                          torch.zeros_like(idx))
    ev_node = sel.take1(t_node, idx).to(torch.int32)
    ev_src = sel.take1(t_src, idx).to(torch.int32)
    ev_tag = sel.take1(t_tag, idx)
    node = torch.clamp(ev_node, 0, N - 1)
    folded = torch.stack([
        (sched_hash[:, 0] ^ _mix(ev_kind, node, ev_src, ev_tag,
                                 0x9E3779B1, 0x85EBCA77, 0xC2B2AE3D,
                                 0x27D4EB2F)) * 16777619,
        (sched_hash[:, 1] ^ _mix(ev_kind, node, ev_src, ev_tag,
                                 0x27D4EB2F, 0xC2B2AE3D, 0x9E3779B1,
                                 0x85EBCA77)) * u32(0x85EBCA6B)], dim=-1)
    new_hash = torch.where(valid[:, None], folded, sched_hash)
    out = (idx, dmin, valid, any_ev, new_hash, ev_kind, ev_node, ev_src,
           ev_tag)
    if occupancy:
        out += ((t_kind != T.EV_FREE).sum(-1, dtype=torch.int32),)
    return out


def _check(name, t, dtype, shape, device):
    if t.device != device:
        raise ValueError(f"sched_pick: {name} is on {t.device}, "
                         f"expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"sched_pick: {name} has dtype {t.dtype}, "
                        f"expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"sched_pick: {name} has shape "
                         f"{tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"sched_pick: {name} must be contiguous")


class _SchedPick:
    """Callable wrapper: CPU tensors -> `sched_pick_plain`; CUDA tensors ->
    the kernel. `launches` counts kernel launches (and nothing else);
    `captured` counts launches recorded into a CUDA graph."""

    def __init__(self):
        self.launches = 0
        self.captured = 0
        self._fn = None

    def _kernel(self):
        if self._fn is None:
            from .kernels import load
            fn = load("sched_pick").sched_pick_launch
            fn.argtypes = [ctypes.c_void_p] * 18 + [ctypes.c_int] * 3 \
                + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn

    def occupancy(self, C: int) -> dict:
        """The kernel's launch shape for tables of C rows on the current
        CUDA device: registers a thread, dynamic shared memory and
        threads a block, and resident blocks an SM."""
        if not 1 <= C <= MAX_C:
            raise ValueError(f"sched_pick: C={C} outside 1..{MAX_C}")
        from .kernels import load
        fn = load("sched_pick").sched_pick_occupancy
        fn.argtypes = [ctypes.c_int] + [ctypes.POINTER(ctypes.c_int)] * 4
        fn.restype = ctypes.c_int
        vals = [ctypes.c_int(0) for _ in range(4)]
        err = fn(C, *(ctypes.byref(v) for v in vals))
        if err != 0:
            raise RuntimeError(f"sched_pick: occupancy query failed "
                               f"(cudaError {err})")
        return dict(zip(("registers", "smem_bytes", "threads",
                         "blocks_per_sm"), (v.value for v in vals)))

    def __call__(self, t_kind, t_node, t_deadline, t_tag, t_src, alive,
                 paused, prio_nudge, halted, k_sched, sched_hash,
                 occupancy: bool = False):
        if t_kind.device.type == "cpu":
            return sched_pick_plain(t_kind, t_node, t_deadline, t_tag,
                                    t_src, alive, paused, prio_nudge,
                                    halted, k_sched, sched_hash, occupancy)
        if t_kind.device.type != "cuda":
            raise ValueError(f"sched_pick: unsupported device "
                             f"{t_kind.device}")
        dev = t_kind.device
        B, C = t_kind.shape
        N = alive.shape[-1]
        if t_kind.dtype != torch.int32:
            raise NotImplementedError(
                "sched_pick: the CUDA kernel takes int32 event tables only "
                f"(table_dtype='int32'); got {t_kind.dtype}")
        if not 1 <= C <= MAX_C or not 1 <= N <= MAX_N:
            raise NotImplementedError(
                f"sched_pick: the CUDA kernel supports 1 <= C <= {MAX_C} "
                f"and 1 <= N <= {MAX_N}; got C={C}, N={N}")
        i32, b8 = torch.int32, torch.bool
        for name, t, dt, shape in (
                ("t_kind", t_kind, i32, (B, C)),
                ("t_node", t_node, i32, (B, C)),
                ("t_deadline", t_deadline, i32, (B, C)),
                ("t_tag", t_tag, i32, (B, C)),
                ("t_src", t_src, i32, (B, C)),
                ("alive", alive, b8, (B, N)),
                ("paused", paused, b8, (B, N)),
                ("prio_nudge", prio_nudge, i32, (B,)),
                ("halted", halted, b8, (B,)),
                ("k_sched", k_sched, i32, (B, 2)),
                ("sched_hash", sched_hash, i32, (B, 2))):
            _check(name, t, dt, shape, dev)
        idx = torch.empty((B,), dtype=i32, device=dev)
        dmin = torch.empty((B,), dtype=i32, device=dev)
        valid = torch.empty((B,), dtype=b8, device=dev)
        any_ev = torch.empty((B,), dtype=b8, device=dev)
        new_hash = torch.empty((B, 2), dtype=i32, device=dev)
        ev = torch.empty((B, 4), dtype=i32, device=dev)
        occ = torch.empty((B,), dtype=i32, device=dev) if occupancy else None
        fn = self._kernel()
        stream = torch.cuda.current_stream(dev).cuda_stream
        with torch.cuda.device(dev):
            err = fn(t_kind.data_ptr(), t_node.data_ptr(),
                     t_deadline.data_ptr(), t_tag.data_ptr(),
                     t_src.data_ptr(), alive.data_ptr(), paused.data_ptr(),
                     prio_nudge.data_ptr(), halted.data_ptr(),
                     k_sched.data_ptr(), sched_hash.data_ptr(),
                     idx.data_ptr(), dmin.data_ptr(), valid.data_ptr(),
                     any_ev.data_ptr(), new_hash.data_ptr(), ev.data_ptr(),
                     None if occ is None else occ.data_ptr(), B, C, N,
                     stream)
        if err != 0:
            raise RuntimeError(f"sched_pick: kernel launch failed "
                               f"(cudaError {err})")
        if torch.cuda.is_current_stream_capturing():
            self.captured += 1
        else:
            self.launches += 1
        out = (idx, dmin, valid, any_ev, new_hash) + ev.unbind(1)
        return out if occ is None else out + (occ,)


sched_pick = _SchedPick()
