"""The step's per-lane row gather and in-place row write (K4):
`node_gather` and `put_rows_`, hand-written CUDA kernels
(csrc/node_rows.cu), and their plain PyTorch versions.

They replace the JAX package's one-hot row slice and scatter
(madsim_tpu/ops/select.py:66 `take_row`, :76 `put_row`;
madsim_tpu/core/step.py:69 `_slice_node`, :73 `_scatter_node`) where the
step applies them to state it owns:

    node_gather(tree, idx)   every leaf [B, R, ...] of `tree` at row
                             idx [B] (clamped into range) -> [B, ...],
                             in one launch (the acting node's slice)
    put_rows_(writes)        for each (mat, idx, val, mask) of `writes`,
                             mat[b, idx[b]] = val's row b (or the scalar
                             val) where mask[b] holds, IN PLACE, up to 16
                             tensors a launch (the node scatter, the dup
                             pop's two table columns, the Lamport write);
                             an out-of-range idx writes nothing, as
                             `select.put_row` does. Returns the tensors
                             it wrote, in order.

`node_gather_plain` is the tree of `select.take_row`; `put_rows_plain`
is `mat[b, idx] = where(mask, val, mat[b, idx])`, held equal to the
functional `select.put_row`. Handlers keep `select.put_row`: they edit
slices that every handler context of a step shares, where an in-place
write would leak one handler's edits into another's.

The wrappers take the plain versions only for tensors on the CPU; for
CUDA tensors they launch the kernels or raise. Their tables (pointers,
row sizes, element sizes, a scalar's bits) ride in the parameter block,
so a CUDA-graph capture holds the step's own buffers. Both kernels are
lane-major and cut a launch into units that run side by side: each row
of more than one element a unit of its own, copied by the warp at the
access width `_long_chunk` gives (16 bytes where aligned), and the
one-element rows, copied a lane a thread, in units of UNIT_ROWS.
`gather_params` lays out a node_gather launch (one index for every
leaf), `put_params` a put_rows launch (its entries grouped by their
(idx, mask) pair first). `launches` counts kernel launches; a launch
recorded into a CUDA graph counts in `captured` instead.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..core.state import tree_map
from . import select as sel
from .kernels import CKernel, on_cpu

_I32 = torch.int32
MAX_GATHER = 48    # leaves a node_gather launch (csrc kMaxGather)
MAX_PUT = 16       # entries (and units) a put_rows launch (csrc kMaxPut)
UNIT_ROWS = 8      # one-element rows a unit (csrc kBatch)


def _leaves(tree) -> list:
    out = []
    tree_map(out.append, tree)
    return out


def _rebuild(tree, values):
    it = iter(values)
    return tree_map(lambda _: next(it), tree)


def node_gather_plain(tree, idx: torch.Tensor):
    """Every leaf [B, R, ...] at its row idx [B] (clamped) -> [B, ...]."""
    return tree_map(lambda a: sel.take_row(a, idx), tree)


def _put_row_plain(mat, idx, val, mask):
    B, R = mat.shape[:2]
    i = idx.to(torch.int64)
    ok = (i >= 0) & (i < R)
    if mask is not True:
        ok = ok & mask
    lanes = torch.arange(B, device=mat.device)
    safe = i.clamp(0, R - 1)
    old = mat[lanes, safe]
    if isinstance(val, torch.Tensor):
        val = val.to(mat.dtype)
    ok = ok.reshape((B,) + (1,) * (old.ndim - 1))
    mat[lanes, safe] = torch.where(ok, val, old)
    return mat


def put_rows_plain(writes) -> list:
    """The writes of `put_rows_`, in place, in plain PyTorch."""
    return [mat if mask is False else _put_row_plain(mat, idx, val, mask)
            for mat, idx, val, mask in writes]


class _GatherLeaf(ctypes.Structure):
    """csrc/node_rows.cu `GatherLeaf`, field for field."""
    _fields_ = [("src", ctypes.c_void_p), ("dst", ctypes.c_void_p),
                ("row", ctypes.c_int64), ("esize", ctypes.c_int32),
                ("chunk", ctypes.c_int32), ("chunks", ctypes.c_int32),
                ("shift", ctypes.c_int32)]


class _GatherUnit(ctypes.Structure):
    """csrc/node_rows.cu `GatherUnit`, field for field."""
    _fields_ = [("leaf", ctypes.c_int32), ("first_item", ctypes.c_int32),
                ("n_items", ctypes.c_int32), ("pad", ctypes.c_int32)]


class _GatherParams(ctypes.Structure):
    """csrc/node_rows.cu `GatherParams`, field for field."""
    _fields_ = [("idx", ctypes.c_void_p),
                ("leaves", _GatherLeaf * MAX_GATHER),
                ("units", _GatherUnit * MAX_GATHER),
                ("items", ctypes.c_uint8 * MAX_GATHER),
                ("B", ctypes.c_int64), ("R", ctypes.c_int32),
                ("n_leaves", ctypes.c_int32), ("n_units", ctypes.c_int32),
                ("n_items", ctypes.c_int32)]


class _PutRow(ctypes.Structure):
    """csrc/node_rows.cu `PutRow`, field for field."""
    _fields_ = [("dst", ctypes.c_void_p), ("src", ctypes.c_void_p),
                ("row", ctypes.c_int64), ("src_sb", ctypes.c_int64),
                ("value", ctypes.c_uint64), ("R", ctypes.c_int32),
                ("esize", ctypes.c_int32), ("chunk", ctypes.c_int32),
                ("chunks", ctypes.c_int32), ("shift", ctypes.c_int32),
                ("pad", ctypes.c_int32)]


class _PutGroup(ctypes.Structure):
    """csrc/node_rows.cu `PutGroup`, field for field."""
    _fields_ = [("idx", ctypes.c_void_p), ("mask", ctypes.c_void_p)]


class _PutUnit(ctypes.Structure):
    """csrc/node_rows.cu `PutUnit`, field for field."""
    _fields_ = [("group", ctypes.c_int32), ("entry", ctypes.c_int32),
                ("first_item", ctypes.c_int32), ("n_items", ctypes.c_int32)]


class _PutParams(ctypes.Structure):
    """csrc/node_rows.cu `PutParams`, field for field."""
    _fields_ = [("rows", _PutRow * MAX_PUT), ("groups", _PutGroup * MAX_PUT),
                ("units", _PutUnit * MAX_PUT),
                ("items", ctypes.c_uint8 * MAX_PUT),
                ("B", ctypes.c_int64), ("n", ctypes.c_int32),
                ("n_groups", ctypes.c_int32), ("n_units", ctypes.c_int32),
                ("n_items", ctypes.c_int32)]


_NP_DTYPES = {torch.bool: np.bool_, torch.uint8: np.uint8,
              torch.int8: np.int8, torch.int16: np.int16,
              torch.int32: np.int32, torch.int64: np.int64,
              torch.float16: np.float16, torch.float32: np.float32,
              torch.float64: np.float64}


def _scalar_bits(value, dtype: torch.dtype) -> int:
    """The bits of a Python scalar stored as `dtype`, as an unsigned int
    (what `torch.where(mask, value, mat)` would store)."""
    if dtype not in _NP_DTYPES:
        raise NotImplementedError(f"put_rows_: no scalar write into "
                                  f"{dtype}")
    a = np.array(value).astype(_NP_DTYPES[dtype])
    return int(a.view(f"u{a.itemsize}"))


def _index(idx, B, dev, what):
    if not isinstance(idx, torch.Tensor) or idx.device != dev \
            or tuple(idx.shape) != (B,):
        raise ValueError(f"{what}: the row index must be a [B] tensor on "
                         f"{dev}")
    return idx.to(_I32).contiguous()


def _check_table(name, t, dev, what):
    if t.device != dev:
        raise ValueError(f"{what}: {name} is on {t.device}, expected {dev}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: {name} must be contiguous")
    if t.element_size() not in (1, 2, 4, 8):
        raise NotImplementedError(f"{what}: {name} has {t.dtype}")


class _NodeGather(CKernel):
    """Callable wrapper: CPU tensors -> `node_gather_plain`; CUDA tensors
    -> the kernel."""

    def __init__(self):
        super().__init__("node_rows", "node_gather", _GatherParams)

    def __call__(self, tree, idx: torch.Tensor):
        if on_cpu(idx, "node_gather"):
            return node_gather_plain(tree, idx)
        return self.run(tree, idx)

    def run(self, tree, idx: torch.Tensor):
        """The kernel's path, on any device (the CPU tests hand it a
        stand-in launcher)."""
        dev = idx.device
        leaves = _leaves(tree)
        if not leaves:
            return tree
        B, R = leaves[0].shape[:2]
        idx = _index(idx, B, dev, "node_gather")
        outs, todo = [], []
        for i, t in enumerate(leaves):
            _check_table(f"leaf {i}", t, dev, "node_gather")
            if tuple(t.shape[:2]) != (B, R):
                raise ValueError(f"node_gather: leaf {i} is "
                                 f"{tuple(t.shape)}, not [{B}, {R}, ...]")
            out = torch.empty((B,) + tuple(t.shape[2:]), dtype=t.dtype,
                              device=dev)
            outs.append(out)
            if out.numel():
                todo.append((t, out))
        for at in range(0, len(todo), MAX_GATHER):
            self._launch(gather_params(todo[at:at + MAX_GATHER], idx, B, R),
                         dev)
        return _rebuild(tree, outs)


def _long_chunk(dst: int, src, src_sb_bytes: int, row_bytes: int,
                esize: int) -> int:
    """Bytes an access of a row's warp copy: 16 where the
    destination and source bases, the source's lane stride and the row's
    bytes are all 16-byte aligned, else the widest power of two that
    divides them all; a scalar source (`src` None) is stored an element
    at a time."""
    if src is None:
        return esize
    c = 16
    while (dst | src | src_sb_bytes | row_bytes) % c:
        c //= 2
    return c


def _chunking(w, src, src_sb_bytes: int, row_bytes: int, esize: int):
    """Set a warp-copied row's access width (`_long_chunk`), its chunks a
    row and the shift of their power-of-two padding on table entry `w`."""
    w.chunk = _long_chunk(w.dst, src, src_sb_bytes, row_bytes, esize)
    w.chunks = row_bytes // w.chunk
    w.shift = (w.chunks - 1).bit_length()


def gather_params(leaves, idx: torch.Tensor, B: int,
                  R: int) -> _GatherParams:
    """The parameter block of one node_gather launch: `leaves` ([(leaf
    [B, R, ...], out [B, ...])], at most MAX_GATHER, none empty) read at
    `idx`'s rows; a unit (a row of the kernel's blocks, grid.y) for each
    leaf whose row has more than one element, copied by the warp, and for
    each UNIT_ROWS of the one-element leaves (`items`), a lane a thread."""
    p = _GatherParams(idx=idx.data_ptr(), B=B, R=R, n_leaves=len(leaves))
    units = []
    for i, (t, out) in enumerate(leaves):
        es = t.element_size()
        row = out.numel() // B
        lf = _GatherLeaf(src=t.data_ptr(), dst=out.data_ptr(), row=row,
                         esize=es)
        if row > 1:
            _chunking(lf, lf.src, R * row * es, row * es, es)
            units.append(_GatherUnit(i, 0, 0))
        else:
            p.items[p.n_items] = i
            p.n_items += 1
        p.leaves[i] = lf
    units += [_GatherUnit(-1, at, min(UNIT_ROWS, p.n_items - at))
              for at in range(0, p.n_items, UNIT_ROWS)]
    p.n_units = len(units)
    for i, u in enumerate(units):
        p.units[i] = u
    return p


def _group_key(idx: torch.Tensor, mask) -> tuple:
    return idx.data_ptr(), 0 if mask is None else mask.data_ptr()


def put_params(entries, B: int) -> _PutParams:
    """The parameter block of one put_rows launch: `entries` ([(PutRow,
    idx, mask)], at most MAX_PUT; mask None: every lane) grouped by their
    (idx, mask) pair in order of first appearance; a unit (a row of the
    kernel's blocks, grid.y) for each row of more than one element, and
    for each UNIT_ROWS of a group's one-element rows (`items`)."""
    groups: dict = {}
    for w, idx, mask in entries:
        groups.setdefault(_group_key(idx, mask), []).append(w)
    p = _PutParams(B=B, n=len(entries), n_groups=len(groups))
    units = []
    e = 0
    for gi, ((ip, mp), ws) in enumerate(groups.items()):
        p.groups[gi].idx, p.groups[gi].mask = ip, mp or None
        first = p.n_items
        for w in ws:
            p.rows[e] = w
            if w.chunk:
                units.append(_PutUnit(gi, e, 0, 0))
            else:
                p.items[p.n_items] = e
                p.n_items += 1
            e += 1
        units += [_PutUnit(gi, -1, at, min(UNIT_ROWS, p.n_items - at))
                  for at in range(first, p.n_items, UNIT_ROWS)]
    p.n_units = len(units)
    for i, u in enumerate(units):
        p.units[i] = u
    return p


class _PutRows(CKernel):
    """Callable wrapper: CPU tensors -> `put_rows_plain`; CUDA tensors ->
    the kernel (in place either way)."""

    def __init__(self):
        super().__init__("node_rows", "put_rows", _PutParams)

    def __call__(self, writes) -> list:
        writes = list(writes)
        if not writes or on_cpu(writes[0][0], "put_rows_"):
            return put_rows_plain(writes)
        return self.run(writes)

    def _entry(self, mat, idx, val, mask, made: dict):
        """(PutRow, idx, mask or None, operands made here) of one write;
        `made` holds an index or mask converted once for every entry that
        shares it, so entries of one pair form one group."""
        dev = mat.device
        B, R = mat.shape[:2]
        _check_table("a written tensor", mat, dev, "put_rows_")
        row = mat[0, 0].numel() if B and R else 0
        es = mat.element_size()
        if id(idx) not in made:
            made[id(idx)] = _index(idx, B, dev, "put_rows_")
        ix, m = made[id(idx)], None
        if mask is not True:
            if mask.dtype != torch.bool or tuple(mask.shape) != (B,) \
                    or mask.device != dev:
                raise ValueError("put_rows_: a mask is a [B] bool tensor "
                                 f"on {dev}")
            if id(mask) not in made:
                made[id(mask)] = mask.contiguous()
            m = made[id(mask)]
        w = _PutRow(dst=mat.data_ptr(), row=row, R=R, esize=es)
        keep = []        # operands made here live until the launch
        if isinstance(val, torch.Tensor):
            if val.device != dev:
                raise ValueError(f"put_rows_: a row source is on "
                                 f"{val.device}, expected {dev}")
            v = val if val.dtype == mat.dtype else val.to(mat.dtype)
            v = v.expand((B,) + tuple(mat.shape[2:])).reshape(B, row)
            if row > 1 and v.stride(1) != 1:
                v = v.contiguous()
            keep.append(v)
            w.src, w.src_sb = v.data_ptr(), v.stride(0)
        else:
            w.value = _scalar_bits(val, mat.dtype)
        if row > 1:      # copied by the warp; one element: by its lane
            _chunking(w, w.src, w.src_sb * es, row * es, es)
        return w, ix, m, keep

    def run(self, writes) -> list:
        """The kernel's path, on any device (the CPU tests hand it a
        stand-in launcher)."""
        dev = writes[0][0].device
        B = writes[0][0].shape[0]
        made, todo, spans = {}, [], []
        for mat, idx, val, mask in writes:
            if mask is False or mat.numel() == 0:
                continue
            if mat.device != dev or mat.shape[0] != B:
                raise ValueError("put_rows_: every written tensor is "
                                 f"[{B}, R, ...] on {dev}")
            todo.append(self._entry(mat, idx, val, mask, made))
            spans.append((mat.data_ptr(),
                          mat.data_ptr() + mat.numel() * mat.element_size()))
        spans.sort()
        if any(a[1] > b[0] for a, b in zip(spans, spans[1:])):
            raise ValueError("put_rows_: one tensor written twice in one "
                             "call, or two that overlap (the kernel's "
                             "writes are unordered)")
        for at in range(0, len(todo), MAX_PUT):
            self._launch(put_params([e[:3] for e in todo[at:at + MAX_PUT]],
                                    B), dev)
        return [mat for mat, _, _, _ in writes]


node_gather = _NodeGather()
put_rows_ = _PutRows()
