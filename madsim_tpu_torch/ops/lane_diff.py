"""Which lanes of which leaves differ between two states (K15):
`lane_diff`, a hand-written CUDA kernel (csrc/lane_diff.cu) over every
leaf pair in one launch, and its plain PyTorch version.

The JAX package diffs in host numpy (madsim_tpu/harness/simtest.py
:138-165 `diff_states`, the determinism sanitizer's comparator). Here
both states stay on the card:

    lane_diff(a, b)     uint8 [n_leaves, B]: flags[l, i] = 1 where any
                        element of leaf l of lane i differs between the
                        two lists of [B, ...] leaves, else 0

compared by value as numpy's `!=` is, with NaN equal to NaN: float32
leaves compare as floats (-0.0 == 0.0), every other leaf (integers and
bools) by its bytes, which for those types is the same thing. A
zero-size leaf's row is all 0.

The wrapper takes the plain version only for tensors on the CPU; for
CUDA tensors it launches the kernel or raises. A launch takes up to
MAX_LEAVES leaf pairs; each lane's row is compared in pieces of
`lane_rows.piece_chunk` bytes by a group of `diff_group` threads.
`launches` counts kernel launches and `captured` launches recorded into
a CUDA graph.
"""

from __future__ import annotations

import ctypes

import torch

from .kernels import CKernel, on_cpu
from .lane_rows import piece_chunk

MAX_LEAVES = 112        # leaf pairs a launch (csrc kMaxDiff)
THREADS = 256           # a block's threads (csrc kThreads)
_KINDS = {torch.float32: 1, torch.bool: 0, torch.uint8: 0, torch.int8: 0,
          torch.int16: 0, torch.int32: 0, torch.int64: 0}


def lane_diff_plain(a: list, b: list) -> torch.Tensor:
    """The flags of `lane_diff`, leaf by leaf in plain PyTorch."""
    B = a[0].shape[0]
    rows = []
    for x, y in zip(a, b):
        if not x.numel():
            rows.append(torch.zeros(B, dtype=torch.uint8, device=x.device))
            continue
        neq = x != y
        if x.dtype.is_floating_point:
            neq &= ~(torch.isnan(x) & torch.isnan(y))
        rows.append(neq.reshape(B, -1).any(1).to(torch.uint8))
    return torch.stack(rows)


def diff_group(chunks: int) -> int:
    """log2 of a lane's threads: the least power of two at or above its
    row's pieces, at most a warp."""
    shift = 0
    while shift < 5 and 1 << shift < chunks:
        shift += 1
    return shift


class _DiffLeaf(ctypes.Structure):
    """csrc/lane_diff.cu `DiffLeaf`, field for field."""
    _fields_ = [("a", ctypes.c_void_p), ("b", ctypes.c_void_p),
                ("row", ctypes.c_int32), ("first", ctypes.c_int32),
                ("chunks", ctypes.c_int32), ("chunk", ctypes.c_uint8),
                ("shift", ctypes.c_uint8), ("kind", ctypes.c_uint8),
                ("pad", ctypes.c_uint8)]


class _DiffParams(ctypes.Structure):
    """csrc/lane_diff.cu `DiffParams`, field for field."""
    _fields_ = [("leaves", _DiffLeaf * MAX_LEAVES),
                ("flags", ctypes.c_void_p), ("B", ctypes.c_int64),
                ("n_leaves", ctypes.c_int32), ("blocks", ctypes.c_int32)]


def diff_params(pairs, flags: torch.Tensor, B: int) -> _DiffParams:
    """The parameter block of one launch over `pairs` ([(a, b)], at most
    MAX_LEAVES, contiguous), writing rows [0, len(pairs)) of `flags`."""
    p = _DiffParams(flags=flags.data_ptr(), B=B, n_leaves=len(pairs))
    first = 0
    for i, (x, y) in enumerate(pairs):
        row = (x.numel() // B) * x.element_size()
        c = piece_chunk(x.data_ptr(), y.data_ptr(), row) if row else 16
        shift = diff_group(row // c)
        p.leaves[i] = _DiffLeaf(x.data_ptr(), y.data_ptr(), row, first,
                                row // c, c, shift, _KINDS[x.dtype], 0)
        first += -(-B // (THREADS >> shift))
    p.blocks = first
    return p


class _LaneDiff(CKernel):
    """Callable wrapper: CPU tensors -> `lane_diff_plain`; CUDA tensors ->
    the kernel."""

    def __init__(self):
        super().__init__("lane_diff", "lane_diff", _DiffParams)

    def __call__(self, a: list, b: list) -> torch.Tensor:
        if on_cpu(a[0], "lane_diff"):
            return lane_diff_plain(a, b)
        return self.run(a, b)

    def run(self, a: list, b: list) -> torch.Tensor:
        """The kernel's path, on any device (the CPU tests hand it a
        stand-in launcher)."""
        if len(a) != len(b) or not a:
            raise ValueError(f"lane_diff: {len(a)} leaves against {len(b)}")
        dev, B = a[0].device, a[0].shape[0]
        pairs, keep = [], []      # contiguous copies, held to the launch
        for x, y in zip(a, b):
            if x.shape != y.shape or x.dtype != y.dtype or x.device != dev \
                    or y.device != dev or x.ndim < 1 or x.shape[0] != B:
                raise ValueError(
                    f"lane_diff: leaves {x.dtype} {tuple(x.shape)} on "
                    f"{x.device} and {y.dtype} {tuple(y.shape)} on "
                    f"{y.device}; both must be [{B}, ...] of one dtype on "
                    f"{dev}")
            if x.dtype not in _KINDS:
                raise TypeError(f"lane_diff: leaf dtype {x.dtype} is not "
                                f"one the kernel compares")
            if not x.is_contiguous():
                x = x.contiguous()
                keep.append(x)
            if not y.is_contiguous():
                y = y.contiguous()
                keep.append(y)
            pairs.append((x, y))
        flags = torch.empty((len(pairs), B), dtype=torch.uint8, device=dev)
        if not B:
            return flags
        for at in range(0, len(pairs), MAX_LEAVES):
            self._launch(diff_params(pairs[at:at + MAX_LEAVES], flags[at],
                                     B), dev)
        return flags


lane_diff = _LaneDiff()
