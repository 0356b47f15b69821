"""K4 on the CPU, and the rewired step: the node-row gather and the
in-place row write of madsim_tpu_torch/ops/node_rows.py against the JAX
package (tolerance: zero).

`put_rows_plain` writes in place where the JAX package's `put_row`
returns a new array: the values must be `put_row`'s and every row it must
not touch must stay bit-identical. `node_gather_plain` must be the JAX
step's `_slice_node`. The CUDA kernels (csrc/node_rows.cu) run only on
the card, where chip_smoke.py holds them exactly equal to these plain
versions; their tables, chunking and scalar bits run here, through the
kernel's path with a stand-in launcher that reads and writes host memory
through the parameter block's pointers, as the kernel does.

Last, the whole flagship step with every threefry draw, row write and
the supervisor op on its kernel path (stand-in launchers for all eight
kernels) runs 192 steps on the CPU and ends leaf for leaf where the JAX
package ends.
"""

import ctypes

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_same, jax_leaves, reference_stream
from madsim_tpu.core import step as jstep
from madsim_tpu.ops import select as jsel
from madsim_tpu_torch import interop, workloads
from madsim_tpu_torch.ops import node_rows as nr
from madsim_tpu_torch.ops import threefry as tf
from test_torch_step_kernels import _super_standin
from test_torch_threefry import (_draw_standin, _dup_standin, _keys_standin,
                                 _split_randint_standin, _step_keys_standin)

B = 64


def _mat(rng, shape, dtype):
    if dtype == np.bool_:
        return rng.random(shape) < 0.5
    info = np.iinfo(dtype)
    return rng.integers(info.min, info.max, shape, dtype=np.int64).astype(
        dtype)


# (rows R, row shape, dtype, value kind)
PUT_CASES = {
    "int32_rows": (5, (32,), np.int32, "rows"),
    "bool_rows": (5, (5,), np.bool_, "rows"),
    "int32_entries": (96, (), np.int32, "rows"),
    "int16_scalar": (96, (), np.int16, "scalar"),
    "bool_scalar": (5, (3, 2), np.bool_, "scalar"),
    "int32_matrix_rows": (7, (4, 3), np.int32, "rows"),
    "broadcast_row": (5, (8,), np.int32, "broadcast"),
}


def _put_case(name, seed):
    R, row, dtype, kind = PUT_CASES[name]
    rng = np.random.default_rng(seed)
    mat = _mat(rng, (B, R) + row, dtype)
    idx = rng.integers(-2, R + 2, B).astype(np.int32)      # out of range too
    mask = rng.random(B) < 0.7
    if kind == "rows":
        val = _mat(rng, (B,) + row, dtype)
    elif kind == "broadcast":
        val = _mat(rng, (1,) + row, dtype)
    else:
        val = dtype(1) if dtype != np.bool_ else True
    return mat, idx, val, mask


@pytest.mark.parametrize("name", sorted(PUT_CASES))
@pytest.mark.parametrize("masked", [True, False])
def test_put_rows_plain_is_put_row_in_place(name, masked):
    mat, idx, val, mask = _put_case(name, len(name) + masked)
    jmask = mask if masked else np.ones(B, bool)
    jval = val if isinstance(val, np.ndarray) and val.shape[0] == B \
        else np.broadcast_to(np.asarray(val, mat.dtype),
                             (B,) + mat.shape[2:])
    want = np.asarray(jax.vmap(jsel.put_row)(mat, idx, jval, jmask))
    t = torch.as_tensor(mat.copy())
    tval = (torch.as_tensor(val) if isinstance(val, np.ndarray)
            else val.item() if isinstance(val, np.generic) else val)
    out = nr.put_rows_plain([(t, torch.as_tensor(idx), tval,
                              torch.as_tensor(mask) if masked else True)])
    assert out[0] is t
    np.testing.assert_array_equal(t.numpy(), want)
    # no row but (b, idx[b]) of a written lane moved
    moved = (t.numpy() != mat).reshape(B, mat.shape[1], -1).any(-1)
    moved[np.arange(B), np.clip(idx, 0, mat.shape[1] - 1)] &= (
        (idx < 0) | (idx >= mat.shape[1]) | ~jmask)
    assert not moved.any()


def test_put_rows_plain_skips_a_false_mask_and_writes_several_tensors():
    mats = [torch.arange(B * 4, dtype=torch.int32).reshape(B, 4),
            torch.zeros((B, 3, 2), dtype=torch.bool)]
    before = [m.clone() for m in mats]
    idx = torch.full((B,), 2, dtype=torch.int32)
    out = nr.put_rows_plain([(mats[0], idx, 7, False),
                             (mats[1], idx, True, True)])
    assert out[0] is mats[0] and torch.equal(mats[0], before[0])
    assert out[1] is mats[1] and bool(mats[1][:, 2].all())
    assert not bool(mats[1][:, :2].any())


def _flagship_node_state(steps=24):
    rt = workloads.flagship_runtime(device="cpu")
    s, _ = rt.run(rt.init_batch(np.arange(B, dtype=np.uint32)), steps,
                  chunk=steps)
    return s.node_state


def test_node_gather_plain_is_the_jax_steps_slice():
    """The JAX step's `_slice_node` (one-hot), lane by lane, on a
    flagship node state after 24 steps, at every node index."""
    ns = _flagship_node_state()
    idx = np.arange(B, dtype=np.int32) % 5
    jns = {k: v.numpy() for k, v in ns.items()}
    want = jax.vmap(jstep._slice_node)(jns, jnp.asarray(idx))
    got = nr.node_gather_plain(ns, torch.as_tensor(idx))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)


# --------------------------------------------------------------------------
# The kernels' launch logic, with a stand-in launcher on host memory
# --------------------------------------------------------------------------
_NP = {1: np.uint8, 2: np.uint16, 4: np.uint32, 8: np.uint64}


def _host(ptr, count, esize):
    return np.frombuffer((ctypes.c_char * (count * esize)).from_address(
        ptr), dtype=_NP[esize], count=count)


def _chunks_ok(rb, c, chunks, shift):
    """csrc/node_rows.cu `chunks_ok`: a warp copy's chunking."""
    return (c in (1, 2, 4, 8, 16) and rb % c == 0 and rb // c == chunks
            and 0 <= shift <= 24 and 1 << shift >= chunks
            and (shift == 0 or 1 << (shift - 1) < chunks))


def _gather_leaf_ok(lf):
    """csrc/node_rows.cu `leaf_ok`: the leaf the kernel can copy."""
    if lf.esize not in _NP or lf.row < 1 or not lf.src or not lf.dst:
        return False
    if lf.chunk == 0:
        return lf.row == 1
    rb, c = lf.row * lf.esize, lf.chunk
    return (_chunks_ok(rb, c, lf.chunks, lf.shift) and lf.src % c == 0
            and lf.dst % c == 0)


def _gather_standin(ref, stream):
    """csrc/node_rows.cu `node_gather`, lane by lane on host memory, read
    from the parameter block as the kernel reads it: a unit (a row of
    more than one element, or up to UNIT_ROWS one-element rows) at a
    time, each lane's index once a unit and clamped, a longer row chunk
    by chunk at its access width. Refuses (cudaErrorInvalidValue) what
    the launcher refuses, and units that do not take every leaf exactly
    once."""
    p = ref._obj
    leaves = p.leaves[:p.n_leaves]
    if not 1 <= p.n_leaves <= nr.MAX_GATHER or p.R < 1 or not p.idx \
            or not 1 <= p.n_units <= nr.MAX_GATHER \
            or not 0 <= p.n_items <= p.n_leaves \
            or not all(_gather_leaf_ok(lf) for lf in leaves):
        return 1
    taken = []
    for u in p.units[:p.n_units]:
        r = _host(p.idx, p.B, 4).view(np.int32).clip(0, p.R - 1)
        if u.leaf >= 0:
            lf = leaves[u.leaf] if u.leaf < p.n_leaves else None
            if lf is None or not lf.chunk:
                return 1
            taken.append(u.leaf)
            rb, cb = lf.row * lf.esize, lf.chunk
            for b in range(p.B):
                at = (b * p.R + int(r[b])) * rb
                for c in range(lf.chunks):
                    ctypes.memmove(lf.dst + b * rb + c * cb,
                                   lf.src + at + c * cb, cb)
            continue
        if u.leaf != -1 or not 1 <= u.n_items <= nr.UNIT_ROWS \
                or u.first_item < 0 \
                or u.first_item + u.n_items > p.n_items:
            return 1
        for i in p.items[u.first_item:u.first_item + u.n_items]:
            if i >= p.n_leaves or leaves[i].chunk:
                return 1
            taken.append(i)
            lf = leaves[i]
            src = _host(lf.src, p.B * p.R, lf.esize).reshape(p.B, p.R)
            _host(lf.dst, p.B, lf.esize)[:] = src[np.arange(p.B), r]
    return 0 if sorted(taken) == list(range(p.n_leaves)) else 1


def _put_row_ok(w):
    """csrc/node_rows.cu `row_ok`: the table entry the kernel can copy."""
    if w.esize not in _NP or w.R < 1 or w.row < 1 or not w.dst:
        return False
    if w.chunk == 0:
        return w.row == 1
    rb, c = w.row * w.esize, w.chunk
    if not _chunks_ok(rb, c, w.chunks, w.shift) or w.dst % c:
        return False
    if not w.src:
        return c == w.esize
    return w.src % c == 0 and w.src_sb * w.esize % c == 0


def _put_standin(ref, stream):
    """csrc/node_rows.cu `put_rows`, lane by lane on host memory, read
    from the parameter block as the kernel reads it: a unit (a row of
    more than one element, or up to UNIT_ROWS one-element rows of one
    group) at a time, its group's index and mask once a lane, a longer
    row chunk by chunk at its access width. Refuses
    (cudaErrorInvalidValue) what the launcher refuses, and units that do
    not take every entry exactly once."""
    p = ref._obj
    rows = p.rows[:p.n]
    if not 1 <= p.n_groups <= p.n <= nr.MAX_PUT \
            or not 1 <= p.n_units <= nr.MAX_PUT \
            or not all(_put_row_ok(w) for w in rows):
        return 1
    covered = []
    for u in p.units[:p.n_units]:
        if not 0 <= u.group < p.n_groups:
            return 1
        g = p.groups[u.group]
        r = _host(g.idx, p.B, 4).view(np.int32).astype(np.int64)
        r = np.where(r >= 0, r, -1)
        if g.mask:
            r = np.where(_host(g.mask, p.B, 1) != 0, r, -1)
        if u.entry >= 0:
            w = rows[u.entry]
            if not w.chunk:
                return 1
            covered.append(u.entry)
            rb, cb = w.row * w.esize, w.chunk
            value = np.array([w.value], np.uint64).view(np.uint8)[:cb]
            for b in np.nonzero((r >= 0) & (r < w.R))[0]:
                at = (int(b) * w.R + int(r[b])) * rb
                for c in range(w.chunks):
                    ctypes.memmove(
                        w.dst + at + c * cb,
                        w.src + int(b) * w.src_sb * w.esize + c * cb
                        if w.src else value.ctypes.data, cb)
            continue
        if not 1 <= u.n_items <= nr.UNIT_ROWS \
                or u.first_item + u.n_items > p.n_items:
            return 1
        for e in p.items[u.first_item:u.first_item + u.n_items]:
            w = rows[e]
            if w.chunk:
                return 1
            covered.append(e)
            dst = _host(w.dst, p.B * w.R, w.esize)
            for b in np.nonzero((r >= 0) & (r < w.R))[0]:
                dst[b * w.R + r[b]] = (
                    _host(w.src + int(b) * w.src_sb * w.esize, 1,
                          w.esize)[0] if w.src else _NP[w.esize](w.value))
    return 0 if sorted(covered) == list(range(p.n)) else 1


@pytest.fixture
def standin(monkeypatch):
    monkeypatch.setattr(nr.node_gather, "_fn", _gather_standin)
    monkeypatch.setattr(nr.put_rows_, "_fn", _put_standin)


def _mixed_tree(rng, n_leaves, R=5):
    dtypes = [torch.int32, torch.bool, torch.int16, torch.int64,
              torch.float32]
    tree = {}
    for i in range(n_leaves):
        dt = dtypes[i % len(dtypes)]
        shape = (B, R) + ((i % 3 + 1,) if i % 4 else ())
        if i == 3:
            shape = (B, R, 0)                          # a zero-size leaf
        x = torch.as_tensor(rng.integers(-99, 99, shape))
        tree[f"l{i}"] = (x > 0) if dt == torch.bool else x.to(dt)
    return tree


@pytest.mark.parametrize("n_leaves", [1, 16, 50])
def test_node_gather_through_the_kernel_path(standin, n_leaves):
    """Mixed element sizes, a zero-size leaf, and more leaves than one
    launch takes (48: two launches)."""
    rng = np.random.default_rng(n_leaves)
    tree = _mixed_tree(rng, n_leaves)
    idx = torch.as_tensor(rng.integers(-1, 7, B).astype(np.int64))
    before = nr.node_gather.launches
    got = nr.node_gather.run(tree, idx)
    filled = sum(t.numel() > 0 for t in tree.values())
    assert nr.node_gather.launches - before == -(-filled // nr.MAX_GATHER)
    want = nr.node_gather_plain(tree, idx)
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k],
                                                             want[k]), k


def _gather_blocks(tree, idx):
    """The parameter blocks node_gather launches for `tree` at `idx`
    (recorded by a stand-in that also runs them), and the result."""
    blocks = []

    def record(ref, stream):
        blocks.append(_copy_params(ref._obj))
        return _gather_standin(ref, stream)

    real = nr.node_gather._fn
    nr.node_gather._fn = record
    try:
        out = nr.node_gather.run(tree, idx)
    finally:
        nr.node_gather._fn = real
    return blocks, out


def _offset_leaf(rng, lanes, R, shape, dtype, offset):
    """A [lanes, R, *shape] leaf of `dtype` with random values that starts
    `offset` elements into its allocation."""
    n = lanes * R * int(np.prod(shape))
    vals = rng.integers(-99, 99, n + offset)
    flat = (torch.as_tensor(vals) > 0 if dtype == torch.bool
            else torch.as_tensor(vals).to(dtype))
    return flat[offset:].view((lanes, R) + shape)


GATHER_CASES = {
    # case: (row shape, dtype, offset in elements, chunk bytes; 0: one
    # element a lane, copied by its thread)
    "int8_scalar": ((), torch.int8, 0, 0),
    "bool_scalar": ((), torch.bool, 1, 0),
    "int16_scalar": ((), torch.int16, 0, 0),
    "int32_scalar": ((), torch.int32, 1, 0),
    "int64_scalar": ((), torch.int64, 0, 0),
    "float64_scalar": ((1,), torch.float64, 0, 0),
    "int32_32_aligned": ((32,), torch.int32, 0, 16),
    "int32_32_one_element_in": ((32,), torch.int32, 1, 4),
    "int32_32_two_elements_in": ((32,), torch.int32, 2, 8),
    "int32_5": ((5,), torch.int32, 0, 4),
    "bool_24": ((24,), torch.bool, 0, 8),
    "bool_3": ((3,), torch.bool, 0, 1),
    "int16_96": ((96,), torch.int16, 0, 16),
    "int16_8_one_element_in": ((8,), torch.int16, 1, 2),
    "int64_3x5": ((3, 5), torch.int64, 0, 8),
    "float32_4x4": ((4, 4), torch.float32, 0, 16),
}


@pytest.mark.parametrize("lanes", [1, 37, 129])
@pytest.mark.parametrize("case", sorted(GATHER_CASES))
def test_node_gather_rows_take_the_widest_aligned_access(standin, case,
                                                         lanes):
    """A one-element row of every element size goes a lane a thread; a
    longer row is copied by the warp 16 bytes an access where both bases
    and the row are 16-byte aligned, else the widest power of two that
    divides them (a leaf one element into its allocation takes narrower
    chunks); indices below 0 and at or above R clamp; lane counts no
    multiple of a warp or a block. Equal to the plain version."""
    shape, dtype, off, chunk = GATHER_CASES[case]
    rng = np.random.default_rng(len(case) + lanes)
    R = 5
    tree = {"x": _offset_leaf(rng, lanes, R, shape, dtype, off)}
    idx = torch.as_tensor(rng.integers(-3, R + 3, lanes).astype(np.int32))
    idx[0] = -(2 ** 31) if lanes > 1 else R
    want = nr.node_gather_plain(tree, idx)
    blocks, got = _gather_blocks(tree, idx)
    lf = blocks[0].leaves[0]
    assert lf.chunk == chunk
    if chunk:
        nbytes = int(np.prod(shape)) * tree["x"].element_size()
        assert lf.chunks == nbytes // chunk
        assert 1 << lf.shift >= lf.chunks > (1 << lf.shift) // 2
        assert [(u.leaf, u.n_items) for u in blocks[0].units[:1]] == [(0, 0)]
    else:
        assert [(u.leaf, u.first_item, u.n_items)
                for u in blocks[0].units[:1]] == [(-1, 0, 1)]
    assert got["x"].dtype == dtype and torch.equal(got["x"], want["x"])


def test_node_gather_units_of_the_flagship_shape(standin):
    """The flagship's slice: 12 one-element leaves and 4 longer ones
    (two of 32 int32, two of 5) in one launch of six units: a unit for
    each longer row, the one-element rows in units of UNIT_ROWS."""
    rng = np.random.default_rng(7)
    shapes = [()] * 6 + [(32,), (5,)] + [()] * 6 + [(32,), (5,)]
    tree = {f"l{i:02d}": _offset_leaf(rng, 100, 5, sh, torch.int32, 0)
            for i, sh in enumerate(shapes)}
    idx = torch.as_tensor(rng.integers(-1, 7, 100).astype(np.int32))
    blocks, got = _gather_blocks(tree, idx)
    assert len(blocks) == 1
    p = blocks[0]
    assert (p.n_leaves, p.n_items, p.n_units) == (16, 12, 6)
    units = [(u.leaf, u.first_item, u.n_items) for u in p.units[:6]]
    assert units == [(6, 0, 0), (7, 0, 0), (14, 0, 0), (15, 0, 0),
                     (-1, 0, 8), (-1, 8, 4)]
    assert [p.leaves[i].chunk for i in (6, 7, 14, 15)] == [16, 4, 16, 4]
    want = nr.node_gather_plain(tree, idx)
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_node_gather_splits_more_than_48_leaves_across_launches(standin):
    """Sixty leaves, one and more elements a row: a launch of 48 leaves,
    then one of 12, each taking every one of its leaves in one unit."""
    rng = np.random.default_rng(8)
    tree = {f"l{i:02d}": _offset_leaf(rng, 37, 4, ((), (3,), (8,))[i % 3],
                                      torch.int32, 0) for i in range(60)}
    idx = torch.as_tensor(rng.integers(-2, 6, 37).astype(np.int32))
    blocks, got = _gather_blocks(tree, idx)
    assert [p.n_leaves for p in blocks] == [48, 12]
    assert [p.n_items for p in blocks] == [16, 4]
    assert [p.n_units for p in blocks] == [32 + 2, 8 + 1]
    want = nr.node_gather_plain(tree, idx)
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_node_gather_refuses_a_table_that_takes_a_leaf_twice(standin):
    """The stand-in refuses, as the launcher does, units that take a
    leaf twice or not at all; the wrapper raises on the refusal."""
    rng = np.random.default_rng(9)
    tree = {"a": _offset_leaf(rng, 8, 3, (), torch.int32, 0),
            "b": _offset_leaf(rng, 8, 3, (), torch.int32, 0)}
    idx = torch.zeros(8, dtype=torch.int32)
    out = [torch.empty(8, dtype=torch.int32) for _ in range(2)]
    p = nr.gather_params(list(zip(tree.values(), out)), idx, 8, 3)
    assert _gather_standin(ctypes.byref(p), None) == 0
    p.items[1] = 0                         # leaf 0 twice, leaf 1 never
    assert _gather_standin(ctypes.byref(p), None) == 1
    real = nr.gather_params
    try:
        nr.gather_params = lambda *a: p
        with pytest.raises(RuntimeError, match="launch failed"):
            nr.node_gather.run(tree, idx)
    finally:
        nr.gather_params = real


@pytest.mark.parametrize("n_writes", [2, 16, 20])
def test_put_rows_through_the_kernel_path(standin, n_writes):
    """Row sources, broadcast rows ([1, ...]: lane stride 0), scalars of
    every element size, masks and no mask, a False mask, indices out of
    range, int64 indices; more entries than one launch takes (16)."""
    rng = np.random.default_rng(n_writes)
    writes, plain = [], []
    for i in range(n_writes):
        R = 5 + i % 4
        mat = _mixed_tree(rng, 5, R)[f"l{i % 5 if i % 5 != 3 else 2}"]
        idx = torch.as_tensor(rng.integers(-2, R + 2, B))
        if i % 3 == 0:
            val = mat[:, 0].clone() + 1 if mat.dtype != torch.bool \
                else ~mat[:, 0]
        elif i % 3 == 1:
            val = mat[:1, 1].clone()
        else:
            val = True if mat.dtype == torch.bool else -3
        mask = (torch.as_tensor(rng.random(B) < 0.6) if i % 4
                else (True if i % 8 else False))
        writes.append((mat, idx, val, mask))
        plain.append((mat.clone(), idx, val, mask))
    got = nr.put_rows_.run(writes)
    want = nr.put_rows_plain(plain)
    for (mat, *_), g, w in zip(writes, got, want):
        assert g is mat and torch.equal(g, w)


def test_put_rows_refuses_one_tensor_twice():
    mat = torch.zeros((B, 4), dtype=torch.int32)
    idx = torch.zeros(B, dtype=torch.int32)
    with pytest.raises(ValueError, match="written twice"):
        nr.put_rows_.run([(mat, idx, 1, True), (mat, idx, 2, True)])


def _params_of(writes):
    """The parameter blocks put_rows_ launches for `writes` (recorded by
    a stand-in that also runs them), and the writes' results."""
    blocks = []

    def record(ref, stream):
        p = _copy_params(ref._obj)
        blocks.append(p)
        return _put_standin(ref, stream)

    real = nr.put_rows_._fn
    nr.put_rows_._fn = record
    try:
        out = nr.put_rows_.run(writes)
    finally:
        nr.put_rows_._fn = real
    return blocks, out


def _copy_params(p):
    q = type(p)()
    ctypes.memmove(ctypes.addressof(q), ctypes.addressof(p),
                   ctypes.sizeof(q))
    return q


def test_put_params_groups_entries_by_their_index_and_mask(standin):
    """Entries that share an (idx, mask) pair form one group (an int64
    index shared by two entries is converted once, so they still do);
    the dup pop's shape, one index under two masks, is two groups; a row
    of more than one element is a unit of its own, a group's one-element
    rows share units of up to UNIT_ROWS."""
    rng = np.random.default_rng(5)
    R = 5
    idx = torch.as_tensor(rng.integers(-1, R + 1, B))          # int64
    m1 = torch.as_tensor(rng.random(B) < 0.5)
    mats = [torch.zeros((B, R), dtype=torch.int32),
            torch.zeros((B, R, 32), dtype=torch.int32),
            torch.zeros((B, R, 5), dtype=torch.int32),
            torch.zeros((B, R), dtype=torch.int16),
            torch.zeros((B, R), dtype=torch.int32)]
    writes = [(mats[0], idx, 1, m1), (mats[1], idx, 2, m1),
              (mats[2], idx, torch.ones((B, 5), dtype=torch.int32), m1),
              (mats[3], idx, 3, ~m1), (mats[4], idx, 4, True)]
    want = nr.put_rows_plain([(m.clone(), i, v, k) for m, i, v, k in writes])
    blocks, out = _params_of(writes)
    assert len(blocks) == 1
    p = blocks[0]
    assert (p.n, p.n_groups, p.n_items) == (5, 3, 3)
    g = p.groups[:3]
    assert g[0].idx == g[1].idx == g[2].idx
    assert g[0].mask and g[1].mask and g[0].mask != g[1].mask \
        and g[2].mask is None
    units = [(u.group, u.entry, u.first_item, u.n_items)
             for u in p.units[:p.n_units]]
    assert units == [(0, 1, 0, 0), (0, 2, 0, 0), (0, -1, 0, 1),
                     (1, -1, 1, 1), (2, -1, 2, 1)]
    assert list(p.items[:3]) == [0, 3, 4]
    long_row, row5 = p.rows[1], p.rows[2]
    assert long_row.dst == mats[1].data_ptr()
    assert (long_row.chunk, long_row.chunks) == (4, 32)  # a scalar source
    assert (row5.chunk, row5.chunks, row5.shift) == (4, 5, 3)
    for got, w in zip(out, want):
        assert torch.equal(got, w)


def _long_write(shape, dtype, offset=0, src=None):
    """A [B, 5, *shape] tensor of `dtype` that starts `offset` elements
    into its allocation."""
    n = B * 5 * int(np.prod(shape))
    flat = torch.zeros(n + offset, dtype=dtype)
    return flat[offset:].view((B, 5) + shape)


LONG_CASES = {
    # case: (row shape, dtype, dst offset, source kind, chunk bytes)
    "int32_aligned": ((32,), torch.int32, 0, "rows", 16),
    "int32_dst_one_element_in": ((32,), torch.int32, 1, "rows", 4),
    "int32_src_one_element_in": ((32,), torch.int32, 0, "offset_rows", 4),
    "int32_src_lane_stride_33": ((32,), torch.int32, 0, "wide_rows", 4),
    "int32_broadcast_row": ((32,), torch.int32, 0, "broadcast", 16),
    "int32_scalar": ((32,), torch.int32, 0, "scalar", 4),
    "int32_two_elements_in": ((32,), torch.int32, 2, "rows", 8),
    "bool_24": ((24,), torch.bool, 0, "rows", 8),
    "int64_3x5": ((3, 5), torch.int64, 0, "rows", 8),
    "int16_96": ((96,), torch.int16, 0, "rows", 16),
}


@pytest.mark.parametrize("case", sorted(LONG_CASES))
def test_long_rows_take_the_widest_aligned_access(standin, case):
    """A row of more than one element is copied by the warp
    16 bytes an access where both bases, the source's lane stride and the
    row are 16-byte aligned, else the widest power of two that divides
    them all (4 bytes for an int32 row one element off), a scalar an
    element at a time; a row of 2^k chunks takes shift k, padded up
    otherwise. Every case equals the plain version."""
    shape, dtype, off, kind, chunk = LONG_CASES[case]
    rng = np.random.default_rng(len(case))
    mat = _long_write(shape, dtype, off)
    mat.copy_(torch.as_tensor(rng.integers(0, 2, mat.shape)).to(dtype))
    row = int(np.prod(shape))
    full = torch.as_tensor(rng.integers(-99, 99, (B + 1, row + 1))).to(dtype)
    val = {"rows": full[:B, :row].contiguous().view((B,) + shape),
           "offset_rows": full.flatten()[1:1 + B * row].view((B,) + shape),
           "wide_rows": full[:B, :row],
           "broadcast": full[:1, :row].contiguous().view((1,) + shape),
           "scalar": 1}[kind]
    idx = torch.as_tensor(rng.integers(-1, 6, B).astype(np.int32))
    mask = torch.as_tensor(rng.random(B) < 0.7)
    want = nr.put_rows_plain([(mat.clone(), idx, val, mask)])[0]
    blocks, out = _params_of([(mat, idx, val, mask)])
    w = blocks[0].rows[0]
    nbytes = row * mat.element_size()
    assert (w.chunk, w.chunks) == (chunk, nbytes // chunk)
    assert 1 << w.shift >= w.chunks > (1 << w.shift) // 2
    assert torch.equal(out[0], want)


@pytest.mark.parametrize("lanes", [1, 37, 129])
def test_put_rows_on_ragged_lanes_split_across_launches(standin, lanes):
    """A scatter-shaped call (one index and mask, short and long rows) of
    18 tensors at B=1 and at lane counts no multiple of the kernel's
    32-lane warps or 128-lane blocks: two launches, the second holding
    the group's last two entries; equal to the plain version."""
    rng = np.random.default_rng(lanes)
    R = 5
    idx = torch.as_tensor(rng.integers(-1, R + 1, lanes).astype(np.int32))
    mask = torch.as_tensor(rng.random(lanes) < 0.8)
    writes = []
    for i in range(18):
        shape = ((), (R,), (32,))[i % 3]
        mat = torch.as_tensor(rng.integers(-9, 9, (lanes, R) + shape)).to(
            torch.int32)
        writes.append((mat, idx, (mat[:, 0] * 3).contiguous(), mask))
    want = nr.put_rows_plain([(m.clone(), i, v, k) for m, i, v, k in writes])
    before = nr.put_rows_.launches
    blocks, out = _params_of(writes)
    assert nr.put_rows_.launches - before == 2
    assert [(p.n, p.n_groups) for p in blocks] == [(16, 1), (2, 1)]
    # 5 32-element and 5 five-element rows, and 6 one-element rows in
    # one unit; then a five-element and a 32-element row
    assert [p.n_units for p in blocks] == [11, 2]
    assert [p.rows[u.entry].chunk for p in blocks
            for u in p.units[:p.n_units] if u.entry >= 0] == [4, 16] * 6
    for got, w in zip(out, want):
        assert torch.equal(got, w)


def test_put_rows_refuses_two_tensors_that_overlap():
    """Two views of one storage whose bytes overlap are refused as one
    tensor written twice is: the kernel's writes are unordered."""
    flat = torch.zeros(B * 5 + 5, dtype=torch.int32)
    a, b = flat[:B * 5].view(B, 5), flat[5:].view(B, 5)
    idx = torch.zeros(B, dtype=torch.int32)
    with pytest.raises(ValueError, match="overlap"):
        nr.put_rows_.run([(a, idx, 1, True), (b, idx, 2, True)])


def test_wrappers_take_the_plain_version_on_the_cpu_and_refuse_meta():
    ns = _mixed_tree(np.random.default_rng(0), 4)
    idx = torch.zeros(B, dtype=torch.int32)
    before = (nr.node_gather.launches, nr.put_rows_.launches)
    nr.node_gather(ns, idx)
    nr.put_rows_([(ns["l0"], idx, 1, True)])
    assert (nr.node_gather.launches, nr.put_rows_.launches) == before
    meta = {k: v.to("meta") for k, v in ns.items()}
    with pytest.raises(ValueError, match="unsupported device"):
        nr.node_gather(meta, idx.to("meta"))
    with pytest.raises(ValueError, match="unsupported device"):
        nr.put_rows_([(meta["l0"], idx.to("meta"), 1, True)])


# --------------------------------------------------------------------------
# The rewired step, every draw and row write on its kernel path
# --------------------------------------------------------------------------
FLAG_B, FLAG_STEPS = 8, 192
KERNELS = ("threefry_keys", "threefry_draw", "node_gather", "put_rows_",
           "step_keys", "dup_draws", "split_randint", "apply_super")


@pytest.fixture
def kernel_paths(monkeypatch):
    """The K1/K4 kernels and the supervisor op on their kernel paths for
    CPU tensors, with the stand-in launchers."""
    from madsim_tpu_torch.ops import apply_super as asup
    monkeypatch.setattr(tf, "on_cpu", lambda t, what: False)
    monkeypatch.setattr(nr, "on_cpu", lambda t, what: False)
    monkeypatch.setattr(asup, "on_cpu", lambda t, what: False)
    for w, fn in ((tf.threefry_keys, _keys_standin),
                  (tf.threefry_draw, _draw_standin),
                  (nr.node_gather, _gather_standin),
                  (nr.put_rows_, _put_standin),
                  (tf.step_keys_kernel, _step_keys_standin),
                  (tf.dup_draws_kernel, _dup_standin),
                  (tf.split_randint_kernel, _split_randint_standin),
                  (asup.apply_super, _super_standin)):
        monkeypatch.setattr(w, "_fn", fn)


def _counts():
    from madsim_tpu_torch.ops.apply_super import apply_super
    return (tf.threefry_keys.launches, tf.threefry_draw.launches,
            nr.node_gather.launches, nr.put_rows_.launches,
            tf.step_keys_kernel.launches, tf.dup_draws_kernel.launches,
            tf.split_randint_kernel.launches, apply_super.launches)


def test_flagship_on_the_kernel_paths_matches_reference(kernel_paths):
    """The traced flagship (its Lamport write a third put_rows_), 192
    steps at B=8: every leaf equal to the JAX package's; each step
    launches the same kernels: the node gather once, the step's keys in
    one step_keys launch, the dup section in one dup_draws launch, Raft's
    two timer draws (`Ctx.randint` with int bounds) in two split_randint
    launches, the supervisor op once, and no threefry_keys or
    threefry_draw."""
    import bench
    seeds = np.arange(FLAG_B, dtype=np.uint32)
    with reference_stream():
        jrt = bench._make_runtime().derived(trace_cap=64)
        js, _ = jrt.run(jrt.init_batch(seeds), FLAG_STEPS, chunk=FLAG_STEPS)
        want = jax_leaves(js)
    rt = workloads.flagship_runtime(device="cpu", trace_cap=64)
    s = rt.init_batch(seeds)
    c0 = _counts()
    s, _ = rt._step(s)
    per_step = tuple(b - a for a, b in zip(c0, _counts()))
    s, _ = rt.run(s, FLAG_STEPS - 1, chunk=FLAG_STEPS - 1)
    launched = tuple(b - a for a, b in zip(c0, _counts()))
    assert launched == tuple(FLAG_STEPS * n for n in per_step)
    assert dict(zip(KERNELS, per_step)) == dict(
        threefry_keys=0, threefry_draw=0, node_gather=1, put_rows_=3,
        step_keys=1, dup_draws=1, split_randint=2, apply_super=1)
    assert_same(want, interop.state_to_numpy(s),
                what="flagship on the K1/K3/K4 kernel paths")
    assert (interop.state_to_numpy(s)[".steps"] == FLAG_STEPS).all()


def test_the_step_writes_node_rows_and_the_popped_row_in_place():
    """The scatter and the dup pop write the state's own tensors: the
    result's node-state leaves are the input's (the supervisor op on the
    CPU replaces only the ones it resets), each changed in at most the
    acting node's row a lane."""
    rt = workloads.flagship_runtime(device="cpu")
    s, _ = rt.run(rt.init_batch(np.arange(B, dtype=np.uint32)), 40,
                  chunk=40)
    before = {k: v.clone() for k, v in s.node_state.items()}
    out, _ = rt._step(s)
    same = [k for k in before if out.node_state[k] is s.node_state[k]]
    assert same
    for k, old in before.items():
        rows = (s.node_state[k] != old).reshape(B, 5, -1).any(-1)
        assert (rows.sum(1) <= 1).all(), k
    assert any(not torch.equal(out.node_state[k], before[k]) for k in same)
