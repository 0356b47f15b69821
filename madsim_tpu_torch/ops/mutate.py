"""The havoc mutation of a knob batch: `mutate_batch`, a hand-written CUDA
kernel (csrc/mutate.cu), and `mutate_batch_plain`, the same function in
plain PyTorch.

It replaces the JAX package's `_mutate_batch` and `_mutate_batch_masked`
(`madsim_tpu/search/mutate.py:471,482`, body `_mutate_one` at `:344`):
lane b takes key b of `split(key, B)`; each of its `havoc` stacked steps
takes one key of `split(lane_key, havoc)`, splits it 16 ways, draws an
operator in [0, 8) from the first and applies that operator under the
plan's guards (see search/mutate.py for the eight operators). Returns
(knobs, hist int32 [8]: operators applied over the batch, last_op int32
[B]: each lane's last applied operator, -1 when none landed). With a
`mask`, lanes where it is False keep their input, count nothing and get
last_op -1.

Every draw is jax's non-partitionable threefry stream (core/prng.py).
Everything is integer arithmetic except operator 5's loss drift,
`clip(loss + (u - 0.5) * 0.2, 0, max(0.9, loss))` in float32, which the
JAX package's XLA build contracts into one fused multiply-add: a single
rounding of `(u - 0.5) * 0.2f + loss`. The kernel computes that fma; the
plain version computes the product and the sum in float64 and rounds once
to float32. The float64 sum is exact — and one rounding equals the fma's —
while the loss lies on the 2^-51 grid: (u - 0.5) is a multiple of 2^-23
and 0.2f of 2^-26, so the product is a multiple of 2^-49 below 0.1, and
the sum of it and a loss below 1 on the 2^-51 grid fits float64's 53
bits. Base losses of 0 or at least 2^-28 lie on that grid (a float32 of
at least 2^-28 is a multiple of its ulp, at least 2^-51), and so does
every loss the mutator derives from them: a sum on the grid rounds to a
float32 that is again on it.

Knobs are a dict of [B, ...] tensors (search/mutate.py KNOB_KEYS): row_*
[B, R] (row_on bool), dup_* [B, D] (dup_on bool), loss float32 [B],
lat_lo, lat_hi, jitter, prio_nudge int32 [B]. Guards (GUARD_KEYS) are
shared by the lanes: time_ok, node_ok, drop_ok, val_ok, dir_ok, torn_ok
bool [R], val_lo, val_hi int32 [R], pool_ok bool [R, N + 1]. The key is
one int32 [2] tensor of uint32 bit patterns.

`mutate_batch` takes the plain version only for tensors on the CPU; for
CUDA tensors it launches the kernel or raises. The kernel takes a tile of
T lanes a block (`mutate_tile`: T and its shared-memory bytes from R, D
and N) and copies the tile's rows 16 bytes an access where every knob
array is 16-byte aligned. `launches` counts kernel launches; a launch
recorded into a CUDA graph under capture counts in `captured` instead.
"""

from __future__ import annotations

import ctypes

import torch

from ..core import prng
from ..core import types as T
from . import select as sel
from .kernels import SMEM_MAX, CKernel, on_cpu, up16

N_MUT_OPS = 8
LAT_CAP = 30_000_000      # latency knob bound (30 simulated seconds)
JIT_CAP = 1_000_000       # jitter knob bound
KNOB_KEYS = ("row_time", "row_node", "row_on", "row_val", "row_flag",
             "dup_src", "dup_time", "dup_on", "loss", "lat_lo", "lat_hi",
             "jitter", "prio_nudge")
GUARD_KEYS = ("time_ok", "node_ok", "drop_ok", "pool_ok", "val_ok",
              "val_lo", "val_hi", "dir_ok", "torn_ok")
_BOOL_KNOBS = ("row_on", "dup_on")
# the knob arrays the kernel stages a tile at a time ([B, R] and [B, D])
_TILED = tuple(n for n in KNOB_KEYS if n.startswith(("row_", "dup_")))
_TIME_MAX = int(T.T_INF) - 1
# 0.2 as the float32 the JAX expression multiplies by, exactly, in float64
_F32_0_2 = float(torch.tensor(0.2, dtype=torch.float32))


def _add32(a, b):
    """int32 a + b with 32-bit wrap (jax's int32 add)."""
    return prng.from_u64(a.to(torch.int64) + b.to(torch.int64))


def _havoc_step(kn: dict, ks: torch.Tensor, g: dict):
    """One stacked mutation of every lane; ks [B, 16, 2]. Returns (knobs,
    op int32 [B], applied bool [B])."""
    B, R = kn["row_time"].shape
    D = kn["dup_src"].shape[1]
    N = g["pool_ok"].shape[1] - 1
    dev = ks.device

    def k(i):
        return ks[:, i]

    def choose(i, mask):
        return sel.masked_choice(k(i), mask.expand(B, R))

    op = prng.randint(k(0), 0, N_MUT_OPS - 1)

    # 0: time nudge of one mutable row, by +-(1 .. 2^mag)
    r_t, ok_t = choose(1, g["time_ok"])
    mag = prng.randint(k(2), 6, 20)
    raw = prng.randint_raw(k(3), 0, torch.bitwise_left_shift(
        torch.ones_like(mag), mag))
    delta = torch.where(prng.bernoulli(k(4), 0.5), raw + 1, -(raw + 1))
    oh_t = sel.row_onehot(R, r_t) & ((op == 0) & ok_t)[:, None]
    row_time = torch.clamp(_add32(kn["row_time"], torch.where(
        oh_t, delta[:, None], 0)), 0, _TIME_MAX)

    # 1: target reshuffle inside the row's pool (else NODE_RANDOM)
    r_n, ok_n = choose(5, g["node_ok"])
    cand = prng.randint(k(6), -1, N - 1)
    allowed = g["pool_ok"][r_n.long(), (cand + 1).long()]
    new_node = torch.where(allowed, cand, T.NODE_RANDOM)
    oh_n = sel.row_onehot(R, r_n) & ((op == 1) & ok_n)[:, None]
    row_node = torch.where(oh_n, new_node[:, None], kn["row_node"])

    # 2: drop or revive one droppable row
    r_d, ok_d = choose(7, g["drop_ok"])
    row_on = kn["row_on"] ^ (sel.row_onehot(R, r_d)
                             & ((op == 2) & ok_d)[:, None])

    # 3: toggle a dup slot; turning it on clones a droppable row nearby
    dup_src, dup_time, dup_on = kn["dup_src"], kn["dup_time"], kn["dup_on"]
    dup_eff = torch.zeros(B, dtype=torch.bool, device=dev)
    if D > 0:
        d_i = prng.randint(k(8), 0, D - 1)
        s_r, ok_s = choose(9, g["drop_ok"])
        dup_eff = ok_s
        oh_d = sel.row_onehot(D, d_i) & ((op == 3) & ok_s)[:, None]
        turn_on = oh_d & ~dup_on
        near = prng.randint(k(10), -200_000, 200_000)
        dup_on = dup_on ^ oh_d
        dup_src = torch.where(turn_on, s_r[:, None], dup_src)
        t_new = torch.clamp(_add32(sel.take1(row_time, s_r), near), 0,
                            _TIME_MAX)
        dup_time = torch.where(turn_on, t_new[:, None], dup_time)

    # 4: latency pair (and jitter bound) perturbation
    is4 = op == 4
    dlo = prng.randint(k(2), -5_000, 5_000)
    dhi = prng.randint(k(3), -20_000, 20_000)

    def shift(name, d, cap):
        return torch.where(is4, torch.clamp(_add32(kn[name], d), 0, cap),
                           kn[name])

    lat_lo = shift("lat_lo", dlo, LAT_CAP)
    lat_hi = shift("lat_hi", dhi, LAT_CAP)
    jitter = shift("jitter", dlo, JIT_CAP)

    # 5: loss drift (one rounding, see the module doc), or a reset to 0
    loss = kn["loss"]
    u = prng.uniform(k(4)).to(torch.float64)
    drifted = ((u - 0.5) * _F32_0_2 + loss.to(torch.float64)).to(
        torch.float32)
    drifted = torch.minimum(torch.clamp(drifted, min=0.0),
                            torch.clamp(loss, min=0.9))
    reset = prng.bernoulli(k(7), 0.2)
    loss = torch.where(op == 5, torch.where(reset, torch.zeros_like(loss),
                                            drifted), loss)

    # 6: a fresh PCT tie-break policy over the full int32 range
    bits = prng.randint_raw(k(11), -(2 ** 31) + 1, 2 ** 31 - 1)
    prio = torch.where(op == 6, bits, kn["prio_nudge"])

    # 7: nudge a fault row's bounded value, or toggle its flag
    fault_ok = g["val_ok"] | g["dir_ok"] | g["torn_ok"]
    r_f, ok_f = choose(12, fault_ok)
    has_flag = (g["dir_ok"] | g["torn_ok"])[r_f.long()]
    has_val = g["val_ok"][r_f.long()]
    want_flag = prng.bernoulli(k(13), 0.35)
    do_flag = has_flag & (want_flag | ~has_val)
    oh_f = sel.row_onehot(R, r_f) & ((op == 7) & ok_f)[:, None]
    span = g["val_hi"] - g["val_lo"]
    vdelta = prng.randint(k(14), -8, 8)[:, None] * torch.clamp(
        torch.div(span, 64, rounding_mode="floor"), min=1)[None, :]
    row_val = torch.clamp(_add32(kn["row_val"], torch.where(
        oh_f & ~do_flag[:, None], vdelta, 0)), g["val_lo"], g["val_hi"])
    row_flag = torch.where(oh_f & do_flag[:, None], kn["row_flag"] ^ 1,
                           kn["row_flag"])

    applied = (((op == 0) & ok_t) | ((op == 1) & ok_n) | ((op == 2) & ok_d)
               | ((op == 3) & dup_eff) | ((op >= 4) & (op <= 6))
               | ((op == 7) & ok_f))
    out = dict(row_time=row_time, row_node=row_node, row_on=row_on,
               row_val=row_val, row_flag=row_flag, dup_src=dup_src,
               dup_time=dup_time, dup_on=dup_on, loss=loss, lat_lo=lat_lo,
               lat_hi=lat_hi, jitter=jitter, prio_nudge=prio)
    return out, op, applied


def mutate_batch_plain(knobs: dict, key: torch.Tensor, guards: dict,
                       havoc: int, mask: torch.Tensor | None = None):
    """Plain PyTorch form; see the module doc. havoc >= 0 (0 returns the
    input knobs, no operator)."""
    B = knobs["row_time"].shape[0]
    dev = knobs["row_time"].device
    return mutate_lanes(knobs, prng.split(key.to(dev), B), guards, havoc,
                        mask)


def mutate_lanes(knobs: dict, lane_keys: torch.Tensor, guards: dict,
                 havoc: int, mask: torch.Tensor | None = None):
    """`mutate_batch_plain` of lanes whose keys of `split(key, B)` are given
    ([B', 2]): the work of the lanes of one tile of the kernel."""
    B = knobs["row_time"].shape[0]
    dev = knobs["row_time"].device
    kn = dict(knobs)
    hist = torch.zeros((B, N_MUT_OPS), dtype=torch.int32, device=dev)
    last_op = torch.full((B,), -1, dtype=torch.int32, device=dev)
    ops = torch.arange(N_MUT_OPS, dtype=torch.int32, device=dev)
    steps = prng.split(lane_keys, havoc)                    # [B, havoc, 2]
    for h in range(havoc):
        kn, op, applied = _havoc_step(kn, prng.split(steps[:, h], 16),
                                      guards)
        hist = hist + ((ops == op[:, None]) & applied[:, None]).to(
            torch.int32)
        last_op = torch.where(applied, op, last_op)
    if mask is not None:
        kn = {n: torch.where(mask.reshape((-1,) + (1,) * (v.ndim - 1)), v,
                             knobs[n]) for n, v in kn.items()}
        hist = hist * mask[:, None].to(torch.int32)
        last_op = torch.where(mask, last_op, -1)
    return kn, hist.sum(0, dtype=torch.int32), last_op


# The kernel's tile (csrc/mutate.cu): T lanes a block, GROUP threads a lane
# while drawing, the tile's knob rows and the guards in shared memory.
GROUP = 4
TILES = (128, 64, 32)           # the tiles the kernel takes, largest first
SMEM_TARGET = 56 * 1024         # the largest tile within this is taken
                                # (four blocks an SM fit the card's 227 KB)

def mutate_smem(T: int, R: int, D: int, N: int) -> int:
    """Dynamic shared-memory bytes of a T-lane tile (csrc/mutate.cu
    `tile_layout`): the four guard lists, val_lo, val_hi, the guard flags,
    the pool, the draws (48 bytes a lane and thread, the first 16 of which
    then hold the step's edit values), the lists of randint and of word
    draws (3 and 2 uint16 a lane and thread), the lane keys (8 bytes a
    lane), then the tile's row_time, row_node, row_val, row_flag, row_on,
    dup_src, dup_time and dup_on, each region 16-byte aligned."""
    return (up16(16 * R) + 2 * up16(4 * R) + up16(R) + up16(R * (N + 1))
            + 48 * T * GROUP + up16(6 * T * GROUP) + up16(4 * T * GROUP)
            + 8 * T + 4 * up16(4 * T * R) + up16(T * R)
            + 2 * up16(4 * T * D) + up16(T * D))


def mutate_tile(R: int, D: int, N: int) -> tuple:
    """(T, shared-memory bytes) of the kernel's tile for a plan: the
    largest of TILES within SMEM_TARGET, else 32 lanes where they fit the
    card; a plan no 32-lane tile fits is refused."""
    for T in TILES:
        smem = mutate_smem(T, R, D, N)
        if smem <= SMEM_TARGET:
            return T, smem
    smem = mutate_smem(TILES[-1], R, D, N)
    if smem > SMEM_MAX:
        raise NotImplementedError(
            f"mutate: a {TILES[-1]}-lane tile of R={R}, D={D}, N={N} takes "
            f"{smem} bytes of shared memory; the card gives a block "
            f"{SMEM_MAX}")
    return TILES[-1], smem


class _Params(ctypes.Structure):
    """csrc/mutate.cu `MutateParams`, field for field."""
    _fields_ = (
        [("in_" + n, ctypes.c_void_p) for n in KNOB_KEYS]
        + [("out_" + n, ctypes.c_void_p) for n in KNOB_KEYS]
        + [(n, ctypes.c_void_p) for n in GUARD_KEYS]
        + [(n, ctypes.c_void_p) for n in ("key", "mask", "hist", "last_op")]
        + [(n, ctypes.c_int) for n in ("B", "R", "D", "N", "havoc", "tile",
                                       "smem", "vec")])


def _check(name, t, dtype, shape, device):
    if t.device != device:
        raise ValueError(f"mutate: {name} is on {t.device}, expected "
                         f"{device}")
    if t.dtype != dtype:
        raise TypeError(f"mutate: {name} has dtype {t.dtype}, expected "
                        f"{dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"mutate: {name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"mutate: {name} must be contiguous")


def knob_shapes(B: int, R: int, D: int) -> dict:
    """{knob: (dtype, shape)} of a knob batch."""
    i32, b8 = torch.int32, torch.bool
    out = {n: (b8 if n in _BOOL_KNOBS else i32,
               (B, R) if n.startswith("row_") else
               (B, D) if n.startswith("dup_") else (B,))
           for n in KNOB_KEYS}
    out["loss"] = (torch.float32, (B,))
    return out


def guard_shapes(R: int, N: int) -> dict:
    """{guard: (dtype, shape)} of a plan's guards."""
    out = {n: (torch.bool, (R,)) for n in GUARD_KEYS}
    out["val_lo"] = out["val_hi"] = (torch.int32, (R,))
    out["pool_ok"] = (torch.bool, (R, N + 1))
    return out


class _MutateBatch(CKernel):
    """Callable wrapper: CPU tensors -> `mutate_batch_plain`; CUDA tensors
    -> the kernel. `launches` counts kernel launches (and nothing else);
    `captured` counts launches recorded into a CUDA graph."""

    def __init__(self):
        super().__init__("mutate", "mutate", _Params)

    def __call__(self, knobs: dict, key: torch.Tensor, guards: dict,
                 havoc: int, mask: torch.Tensor | None = None):
        if on_cpu(knobs["row_time"], "mutate"):
            self._check(knobs, key, guards, havoc, mask)
            return mutate_batch_plain(knobs, key, guards, havoc, mask)
        return self.run(knobs, key, guards, havoc, mask)

    @staticmethod
    def _check(knobs, key, guards, havoc, mask):
        dev = knobs["row_time"].device
        B, R = knobs["row_time"].shape
        D = knobs["dup_src"].shape[1]
        N = guards["pool_ok"].shape[1] - 1
        if havoc < 0:
            raise ValueError(f"mutate: havoc must be >= 0, got {havoc}")
        checks = [(n, knobs[n], dt, sh)
                  for n, (dt, sh) in knob_shapes(B, R, D).items()]
        checks += [(n, guards[n], dt, sh)
                   for n, (dt, sh) in guard_shapes(R, N).items()]
        checks.append(("key", key, torch.int32, (2,)))
        if mask is not None:
            checks.append(("mask", mask, torch.bool, (B,)))
        for name, t, dt, shape in checks:
            _check(name, t, dt, shape, dev)
        return dev

    def run(self, knobs: dict, key: torch.Tensor, guards: dict, havoc: int,
            mask: torch.Tensor | None = None):
        """The kernel's path, on any device (the CPU tests hand it a
        stand-in launcher)."""
        dev = self._check(knobs, key, guards, havoc, mask)
        B, R = knobs["row_time"].shape
        D = knobs["dup_src"].shape[1]
        N = guards["pool_ok"].shape[1] - 1
        tile, smem = mutate_tile(R, D, N)
        out = {n: torch.empty_like(knobs[n]) for n in KNOB_KEYS}
        hist = torch.zeros((N_MUT_OPS,), dtype=torch.int32, device=dev)
        last_op = torch.empty((B,), dtype=torch.int32, device=dev)
        p = _Params(B=B, R=R, D=D, N=N, havoc=havoc, tile=tile, smem=smem)
        for n in KNOB_KEYS:
            setattr(p, "in_" + n, knobs[n].data_ptr())
            setattr(p, "out_" + n, out[n].data_ptr())
        for n in GUARD_KEYS:
            setattr(p, n, guards[n].data_ptr())
        p.key = key.data_ptr()
        p.mask = mask.data_ptr() if mask is not None else None
        p.hist, p.last_op = hist.data_ptr(), last_op.data_ptr()
        p.vec = int(all(t.data_ptr() % 16 == 0 for n in _TILED
                        for t in (knobs[n], out[n])))
        if B:
            self._launch(p, dev)
        return out, hist, last_op


mutate_batch = _MutateBatch()
