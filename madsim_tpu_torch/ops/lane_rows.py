"""The whole-state lane gather and scatter (K14): `lane_take` and
`lane_put`, one hand-written CUDA kernel (csrc/lane_rows.cu) over every
leaf of a state, and their plain PyTorch versions.

The JAX package does this in host numpy: `Runtime.run_compacting`
repacks the live lanes (`a[keep]`), stashes the halted ones (`a[drop]`)
and merges the parts back into the original lane order
(madsim_tpu/runtime/runtime.py:703-712, :729-737); the determinism
sanitizer un-permutes a run with `vb[align]`
(madsim_tpu/harness/simtest.py:151-152). Here the state stays on the
card:

    lane_take(tree, idx)        a new tree whose leaf l is
                                tree[l][idx] (lane i of the result is
                                lane idx[i] of `tree`; repeats allowed)
    lane_put(out, idx, part)    out[l][idx] = part[l] for every leaf, IN
                                PLACE (idx distinct); returns `out`

A tree is a `SimState`, a dict of tensors (nested dicts allowed) or a
list of tensors, every leaf [B, ...]; the result has the same
structure. `idx` is a host index (numpy, a list or a CPU tensor): the
wrapper checks it on the host (in range; distinct for `lane_put`, which
raises otherwise) and copies it to the state's device.

The wrappers take the plain versions (`index_select`, `index_copy_`)
only for tensors on the CPU; for CUDA tensors they launch the kernel or
raise. A launch takes up to MAX_LEAVES non-empty leaves (zero-size leaves
need no copy), each cut into pieces of `piece_chunk` bytes; `launches`
counts kernel launches and `captured` launches recorded into a CUDA
graph.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..core.state import SimState, map_state, tree_map
from .kernels import CKernel, on_cpu

MAX_LEAVES = 112        # leaves a launch (csrc kMaxRows)
PIECES_A_BLOCK = 1024   # pieces a block (csrc kThreads * kPer)


def flat_leaves(tree) -> list:
    """The leaves of a SimState, a (nested) dict or a list, in the order
    `rebuild` takes them back."""
    out = []
    if isinstance(tree, SimState):
        map_state(out.append, tree)
    elif isinstance(tree, (list, tuple)):
        out = list(tree)
    else:
        tree_map(out.append, tree)
    return out


def rebuild(tree, values):
    """`tree`'s structure with `values` (in `flat_leaves` order)."""
    if isinstance(tree, (list, tuple)):
        return type(tree)(values)
    it = iter(values)
    if isinstance(tree, SimState):
        return map_state(lambda _: next(it), tree)
    return tree_map(lambda _: next(it), tree)


def host_index(idx, n: int, what: str, distinct: bool = False) -> np.ndarray:
    """`idx` as an int64 numpy vector, every entry in [0, n) (and no
    repeat when `distinct`); raises otherwise."""
    if isinstance(idx, torch.Tensor):
        if idx.device.type != "cpu":
            raise ValueError(f"{what}: the index must be on the host, not "
                             f"{idx.device}")
        idx = idx.numpy()
    a = np.asarray(idx)
    if a.ndim != 1 or (a.size and a.dtype.kind not in "iu"):
        raise ValueError(f"{what}: the index must be a 1-D integer array")
    a = a.astype(np.int64)
    if a.size and (a.min() < 0 or a.max() >= n):
        raise IndexError(f"{what}: an index out of range [0, {n})")
    if distinct and np.unique(a).size != a.size:
        raise ValueError(f"{what}: repeated indices (the writes are "
                         f"unordered, so a lane written twice is undefined)")
    return a


def lane_take_plain(tree, idx: torch.Tensor):
    """Every leaf's lanes `idx` (an int64 tensor on the leaves' device)."""
    return rebuild(tree, [t.index_select(0, idx) for t in flat_leaves(tree)])


def lane_put_plain(out, idx: torch.Tensor, part):
    """out[l][idx] = part[l] for every leaf, in place; returns `out`."""
    for o, p in zip(flat_leaves(out), flat_leaves(part)):
        if o.numel():
            o.index_copy_(0, idx, p)
    return out


def piece_chunk(*values: int) -> int:
    """Bytes an access: 16 where every value (both bases, the row's
    bytes) is a multiple of 16, else the widest power of two that divides
    them all."""
    c = 16
    while any(v % c for v in values):
        c //= 2
    return c


class _RowsLeaf(ctypes.Structure):
    """csrc/lane_rows.cu `RowsLeaf`, field for field."""
    _fields_ = [("src", ctypes.c_void_p), ("dst", ctypes.c_void_p),
                ("row", ctypes.c_int32), ("first", ctypes.c_int32),
                ("chunk", ctypes.c_int32), ("chunks", ctypes.c_int32)]


class _RowsParams(ctypes.Structure):
    """csrc/lane_rows.cu `RowsParams`, field for field."""
    _fields_ = [("leaves", _RowsLeaf * MAX_LEAVES), ("idx", ctypes.c_void_p),
                ("T", ctypes.c_int64), ("B", ctypes.c_int64),
                ("n_leaves", ctypes.c_int32), ("put", ctypes.c_int32),
                ("blocks", ctypes.c_int32), ("pad", ctypes.c_int32)]


def rows_params(pairs, idx: torch.Tensor, T: int, B: int,
                put: bool) -> _RowsParams:
    """The parameter block of one launch over `pairs` ([(src, dst)], at
    most MAX_LEAVES, none empty, each contiguous): each leaf's row bytes,
    its access width and its first block."""
    p = _RowsParams(idx=idx.data_ptr(), T=T, B=B, n_leaves=len(pairs),
                    put=int(put))
    first = 0
    for i, (src, dst) in enumerate(pairs):
        row = (src.numel() // src.shape[0]) * src.element_size()
        c = piece_chunk(src.data_ptr(), dst.data_ptr(), row)
        if T * (row // c) >= 1 << 31:
            raise NotImplementedError(
                f"lane_rows: {T} lanes of {row // c} pieces; a leaf takes "
                f"fewer than 2^31 pieces a launch")
        p.leaves[i] = _RowsLeaf(src.data_ptr(), dst.data_ptr(), row, first,
                                c, row // c)
        first += -(-(T * (row // c)) // PIECES_A_BLOCK)
    p.blocks = first
    return p


def _check_leaf(t, dev, lanes, what):
    if t.device != dev or t.ndim < 1 or t.shape[0] != lanes:
        raise ValueError(f"{what}: a leaf of shape {tuple(t.shape)} on "
                         f"{t.device}; every leaf must be [{lanes}, ...] on "
                         f"{dev}")


class _LaneRows(CKernel):
    """The kernel's launcher, shared by `lane_take` and `lane_put`."""

    def __init__(self):
        super().__init__("lane_rows", "lane_rows", _RowsParams)

    def _copy(self, pairs, idx: np.ndarray, B: int, put: bool, dev) -> None:
        """Launch over every (src, dst) pair, MAX_LEAVES a launch; the
        index and any contiguous copy live until the launches are
        issued."""
        todo = []
        keep = []                 # operands made here, held to the launch
        for src, dst in pairs:
            if not src.numel():
                continue
            if not src.is_contiguous():
                src = src.contiguous()
                keep.append(src)
            if not dst.is_contiguous():
                raise ValueError("lane_rows: a written leaf must be "
                                 "contiguous")
            todo.append((src, dst))
        if not todo or not idx.size:
            return
        ix = torch.as_tensor(idx, dtype=torch.int64, device=dev)
        for at in range(0, len(todo), MAX_LEAVES):
            self._launch(rows_params(todo[at:at + MAX_LEAVES], ix,
                                     int(idx.size), B, put), dev)


class _LaneTake(_LaneRows):
    """Callable wrapper: CPU tensors -> `lane_take_plain`; CUDA tensors ->
    the kernel."""

    def __call__(self, tree, idx):
        leaves = flat_leaves(tree)
        if on_cpu(leaves[0], "lane_take"):
            ix = host_index(idx, leaves[0].shape[0], "lane_take")
            return lane_take_plain(tree, torch.as_tensor(ix))
        return self.run(tree, idx)

    def run(self, tree, idx):
        """The kernel's path, on any device (the CPU tests hand it a
        stand-in launcher)."""
        leaves = flat_leaves(tree)
        dev, B = leaves[0].device, leaves[0].shape[0]
        ix = host_index(idx, B, "lane_take")
        outs = []
        for t in leaves:
            _check_leaf(t, dev, B, "lane_take")
            outs.append(torch.empty((ix.size,) + tuple(t.shape[1:]),
                                    dtype=t.dtype, device=dev))
        self._copy(list(zip(leaves, outs)), ix, B, False, dev)
        return rebuild(tree, outs)


class _LanePut(_LaneRows):
    """Callable wrapper: CPU tensors -> `lane_put_plain`; CUDA tensors ->
    the kernel (in place either way)."""

    def __call__(self, out, idx, part):
        leaves = flat_leaves(out)
        if on_cpu(leaves[0], "lane_put"):
            ix = host_index(idx, leaves[0].shape[0], "lane_put",
                            distinct=True)
            return lane_put_plain(out, torch.as_tensor(ix), part)
        return self.run(out, idx, part)

    def run(self, out, idx, part):
        """The kernel's path, on any device (the CPU tests hand it a
        stand-in launcher)."""
        dst = flat_leaves(out)
        src = flat_leaves(part)
        dev, B = dst[0].device, dst[0].shape[0]
        ix = host_index(idx, B, "lane_put", distinct=True)
        if len(src) != len(dst):
            raise ValueError(f"lane_put: {len(src)} leaves into {len(dst)}")
        for s, d in zip(src, dst):
            _check_leaf(d, dev, B, "lane_put")
            _check_leaf(s, dev, ix.size, "lane_put")
            if s.dtype != d.dtype or s.shape[1:] != d.shape[1:]:
                raise ValueError(f"lane_put: a {s.dtype} "
                                 f"{tuple(s.shape)} part into a {d.dtype} "
                                 f"{tuple(d.shape)} leaf")
        self._copy(list(zip(src, dst)), ix, B, True, dev)
        return out


lane_take = _LaneTake()
lane_put = _LanePut()
