"""K14 and K15 on the CPU: the whole-state lane gather and scatter
(`lane_take`, `lane_put`, madsim_tpu_torch/ops/lane_rows.py) and the lane
diff (`lane_diff`, ops/lane_diff.py) against their plain versions, and
their plain versions against the numpy the JAX package runs
(`a[idx]`, the run_compacting merge, `diff_states`' `!=`); tolerance
zero.

The CUDA kernels (csrc/lane_rows.cu, csrc/lane_diff.cu) run only on the
card, where chip_smoke.py holds them exactly equal to these plain
versions. Their launch logic runs here, through each wrapper's kernel
path with a stand-in launcher that reads and writes host memory through
the parameter block's pointers as the kernel does: the pointer table,
the access widths chosen from the pointers (leaves one element and one
byte off a 16-byte boundary), the blocks of each leaf, a temporary
operand held across the launch (ROADMAP F17), and `lane_put`'s refusal
of repeated indices.
"""

import bisect
import ctypes

import numpy as np
import pytest
import torch

from madsim_tpu_torch import interop, workloads
from madsim_tpu_torch.ops import lane_diff as ld
from madsim_tpu_torch.ops import lane_rows as lr

_NP = {1: np.uint8, 2: np.uint16, 4: np.uint32, 8: np.uint64}


def _bytes(ptr, n):
    return np.frombuffer((ctypes.c_char * n).from_address(ptr),
                         dtype=np.uint8, count=n)


def _scribble(ptrs_sizes):
    """Allocate and fill with 0x5A blocks of the sizes the launch reads:
    memory a wrapper freed before its launch is likely handed out again
    here, so a freed operand reads as garbage (F17)."""
    return [torch.full((n,), 0x5A, dtype=torch.uint8) for _, n in ptrs_sizes
            for _ in range(4)]


def _rows_standin(ref, stream):
    """csrc/lane_rows.cu on host memory, read from the parameter block
    as the kernel reads it: each block finds its leaf by the leaves'
    first blocks and moves its pieces (T * chunks a leaf, PIECES_A_BLOCK
    a block) `chunk` bytes at a time. Refuses (cudaErrorInvalidValue)
    what the launcher refuses, and blocks that do not cover every piece
    exactly once."""
    p = ref._obj
    if not 1 <= p.n_leaves <= lr.MAX_LEAVES or p.T < 1 or p.B < 1 \
            or not p.idx or p.put not in (0, 1) or p.blocks < 1:
        return 1
    leaves = p.leaves[:p.n_leaves]
    nxt = 0
    for lf in leaves:
        c = lf.chunk
        if c not in (1, 2, 4, 8, 16) or lf.row < 1 or lf.row % c \
                or lf.row // c != lf.chunks or not lf.src or not lf.dst \
                or lf.src % c or lf.dst % c or lf.first != nxt:
            return 1
        nxt += -(-(p.T * lf.chunks) // lr.PIECES_A_BLOCK)
    if nxt != p.blocks:
        return 1
    _scribble([(lf.src, lf.row * (p.B if not p.put else p.T))
               for lf in leaves])
    idx = np.frombuffer((ctypes.c_int64 * p.T).from_address(p.idx),
                        dtype=np.int64).copy()
    firsts = [lf.first for lf in leaves]
    covered = [np.zeros(p.T * lf.chunks, np.int64) for lf in leaves]
    for bx in range(p.blocks):
        li = bisect.bisect_right(firsts, bx) - 1
        lf = leaves[li]
        q = (bx - lf.first) * lr.PIECES_A_BLOCK + np.arange(
            lr.PIECES_A_BLOCK)
        q = q[q < p.T * lf.chunks]
        covered[li][q] += 1
        i, c = q // lf.chunks, q % lf.chunks
        s, d = (i, idx[i]) if p.put else (idx[i], i)
        n_src = p.T if p.put else p.B
        n_dst = p.B if p.put else p.T
        src = _bytes(lf.src, n_src * lf.row).reshape(n_src, lf.chunks,
                                                     lf.chunk)
        dst = _bytes(lf.dst, n_dst * lf.row).reshape(n_dst, lf.chunks,
                                                     lf.chunk)
        dst[d, c] = src[s, c]
    return 0 if all((cv == 1).all() for cv in covered) else 1


def _diff_standin(ref, stream):
    """csrc/lane_diff.cu on host memory, read from the parameter block
    as the kernel reads it: each block finds its leaf, a group of
    1 << shift threads a lane compares the lane's pieces (`chunk` bytes,
    float32 words by value with NaN equal to NaN for kind 1) and writes
    the lane's flag. Refuses what the launcher refuses, and blocks that
    do not write every flag exactly once."""
    p = ref._obj
    if not 1 <= p.n_leaves <= ld.MAX_LEAVES or p.B < 1 or not p.flags \
            or p.blocks < 1:
        return 1
    leaves = p.leaves[:p.n_leaves]
    nxt = 0
    for lf in leaves:
        c = lf.chunk
        if c not in (1, 2, 4, 8, 16) or lf.row < 0 or lf.row % c \
                or lf.row // c != lf.chunks or lf.shift > 5 or lf.kind > 1 \
                or (lf.kind == 1 and c < 4) or lf.first != nxt \
                or lf.shift != ld.diff_group(lf.chunks):
            return 1
        if lf.row and (not lf.a or not lf.b or lf.a % c or lf.b % c):
            return 1
        nxt += -(-p.B // (ld.THREADS >> lf.shift))
    if nxt != p.blocks:
        return 1
    _scribble([(lf.a, lf.row * p.B) for lf in leaves if lf.row]
              + [(lf.b, lf.row * p.B) for lf in leaves if lf.row])
    flags = _bytes(p.flags, p.n_leaves * p.B).reshape(p.n_leaves, p.B)
    written = np.zeros((p.n_leaves, p.B), np.int64)
    firsts = [lf.first for lf in leaves]
    for bx in range(p.blocks):
        li = bisect.bisect_right(firsts, bx) - 1
        lf = leaves[li]
        per = ld.THREADS >> lf.shift
        lanes = (bx - lf.first) * per + np.arange(per)
        lanes = lanes[lanes < p.B]
        written[li, lanes] += 1
        if not lf.row:
            flags[li, lanes] = 0
            continue
        a = _bytes(lf.a, p.B * lf.row).reshape(p.B, lf.chunks, lf.chunk)
        b = _bytes(lf.b, p.B * lf.row).reshape(p.B, lf.chunks, lf.chunk)
        a, b = a[lanes].copy(), b[lanes].copy()
        if lf.kind == 1:
            fa, fb = a.view(np.float32), b.view(np.float32)
            neq = (fa != fb) & ~(np.isnan(fa) & np.isnan(fb))
        else:
            neq = a != b
        flags[li, lanes] = neq.reshape(len(lanes), -1).any(1)
    return 0 if (written == 1).all() else 1


@pytest.fixture
def standin(monkeypatch):
    monkeypatch.setattr(lr.lane_take, "_fn", _rows_standin)
    monkeypatch.setattr(lr.lane_put, "_fn", _rows_standin)
    monkeypatch.setattr(ld.lane_diff, "_fn", _diff_standin)


def _offset(vals: torch.Tensor, offset: int) -> torch.Tensor:
    """`vals` copied into an allocation it starts `offset` elements into."""
    flat = torch.zeros(vals.numel() + offset, dtype=vals.dtype)
    out = flat[offset:].view(vals.shape)
    out.copy_(vals)
    return out


def _mixed_tree(rng, B, offset=0):
    """Leaves of every dtype a state holds and more: bool, int8, int16,
    int32 (uint32 bits too), int64, float32 (with -0.0, NaN and inf),
    rows of one to 96 elements, zero-size leaves; each `offset` elements
    into its allocation."""
    def ints(shape, dtype, lo=-2 ** 31, hi=2 ** 31 - 1):
        return torch.as_tensor(rng.integers(lo, hi, shape)).to(dtype)

    f = torch.as_tensor(rng.standard_normal((B, 3)).astype(np.float32))
    f[::5, 0] = float("nan")
    f[1::5, 1] = -0.0
    f[2::7, 2] = float("inf")
    tree = {
        "bool": torch.as_tensor(rng.random(B) < 0.5),
        "bool_rows": torch.as_tensor(rng.random((B, 5)) < 0.5),
        "int8": ints((B, 3), torch.int8, -128, 127),
        "int16_rows": ints((B, 96), torch.int16, -2 ** 15, 2 ** 15 - 1),
        "int32": ints((B,), torch.int32),
        "uint32_bits": ints((B, 2), torch.int32),
        "int32_payload": ints((B, 24, 8), torch.int32),
        "int64": ints((B, 2), torch.int64),
        "float32": f,
        "empty_rows": torch.zeros((B, 0), dtype=torch.int32),
        "nested": {"x": ints((B, 5), torch.int32),
                   "empty": torch.zeros((B, 4, 0), dtype=torch.bool)},
    }
    if offset:
        tree = {k: ({kk: _offset(vv, offset) for kk, vv in v.items()}
                    if isinstance(v, dict) else _offset(v, offset))
                for k, v in tree.items()}
    return tree


def _leaves(tree):
    return lr.flat_leaves(tree)


def _same_bits(a, b):
    """Every leaf equal in dtype, shape and bits (NaN's too)."""
    for x, y in zip(_leaves(a), _leaves(b)):
        assert x.dtype == y.dtype and x.shape == y.shape
        if x.dtype == torch.float32:
            x, y = x.view(torch.int32), y.view(torch.int32)
        assert torch.equal(x, y)


# --------------------------------------------------------------------------
# The plain versions against the JAX package's numpy
# --------------------------------------------------------------------------
def test_plain_take_and_put_are_the_numpy_gather_and_merge():
    """lane_take_plain is numpy's `a[keep]`; parts put back with
    lane_put_plain are run_compacting's merge (`concatenate(parts)
    [argsort(order)]`)."""
    rng = np.random.default_rng(0)
    B = 53
    tree = _mixed_tree(rng, B)
    keep = rng.permutation(B)[:20]
    drop = np.setdiff1d(np.arange(B), keep)
    got = lr.lane_take_plain(tree, torch.as_tensor(keep))
    for x, y in zip(_leaves(tree), _leaves(got)):
        np.testing.assert_array_equal(x.numpy()[keep], y.numpy())
    parts = [(drop, lr.lane_take_plain(tree, torch.as_tensor(drop))),
             (keep, got)]
    out = lr.rebuild(tree, [torch.empty_like(t) for t in _leaves(tree)])
    for idx, part in parts:
        lr.lane_put_plain(out, torch.as_tensor(idx), part)
    order = np.concatenate([p[0] for p in parts])
    inv = np.argsort(order)
    for x, y, z in zip(_leaves(out), _leaves(parts[0][1]),
                       _leaves(parts[1][1])):
        want = np.concatenate([y.numpy(), z.numpy()])[inv]
        np.testing.assert_array_equal(x.numpy(), want)


def test_plain_diff_is_numpy_not_equal_with_nan_equal():
    """lane_diff_plain is `diff_states`' numpy compare: `!=` by value
    (-0.0 == 0.0), NaN equal to NaN, a zero-size leaf never differs."""
    rng = np.random.default_rng(1)
    B = 40
    a = _leaves(_mixed_tree(rng, B))
    b = [t.clone() for t in a]
    b[0][3] = ~b[0][3]
    b[8][5, 0] = float("nan") if not torch.isnan(a[8][5, 0]) else 1.0
    b[8][6] = torch.where(a[8][6] == 0, -a[8][6], a[8][6])  # -0.0 vs 0.0
    b[6][7, 23, 7] += 1
    got = ld.lane_diff_plain(a, b).numpy()
    for row, x, y in zip(got, a, b):
        xa, ya = x.numpy(), y.numpy()
        if not xa.size:
            assert not row.any()
            continue
        neq = xa != ya
        if xa.dtype.kind == "f":
            neq &= ~(np.isnan(xa) & np.isnan(ya))
        np.testing.assert_array_equal(row,
                                      neq.reshape(B, -1).any(1))
    assert np.nonzero(got.any(1))[0].tolist() == [0, 6, 8]


# --------------------------------------------------------------------------
# The kernels' launch logic, with a stand-in launcher on host memory
# --------------------------------------------------------------------------
TAKE_CASES = {
    # case: (lanes, index length, repeated indices, offset in elements)
    "B1": (1, 1, False, 0),
    "B1_taken_thrice": (1, 3, True, 0),
    "non_power_of_two_T": (77, 45, False, 0),
    "repeats": (64, 100, True, 0),
    "every_lane_reversed": (129, 129, False, 0),
    "one_element_in": (64, 33, False, 1),
}


@pytest.mark.parametrize("case", sorted(TAKE_CASES))
def test_lane_take_through_the_kernel_path(standin, case):
    B, T, repeats, off = TAKE_CASES[case]
    rng = np.random.default_rng(len(case))
    tree = _mixed_tree(rng, B, off)
    idx = (rng.integers(0, B, T) if repeats
           else rng.permutation(max(B, T))[:T] % B)
    if case == "every_lane_reversed":
        idx = np.arange(B)[::-1].copy()
    before = lr.lane_take.launches
    got = lr.lane_take.run(tree, idx)
    assert lr.lane_take.launches - before == 1
    _same_bits(got, lr.lane_take_plain(tree, torch.as_tensor(idx)))


@pytest.mark.parametrize("case", ["aligned", "one_element_in", "B1"])
def test_lane_put_through_the_kernel_path(standin, case):
    """The merge: a batch allocated once, every part put back into its
    lanes; rows not written keep what they held."""
    B = 1 if case == "B1" else 97
    off = 1 if case == "one_element_in" else 0
    rng = np.random.default_rng(B + off)
    src = _mixed_tree(rng, B, off)
    order = rng.permutation(B)
    cut = B // 3
    parts = [order[:cut], order[cut:]]
    out = lr.rebuild(src, [_offset(torch.zeros_like(t), off)
                           for t in _leaves(src)])
    want = lr.rebuild(src, [torch.zeros_like(t) for t in _leaves(src)])
    before = lr.lane_put.launches
    for idx in parts:
        if not idx.size:
            continue
        part = lr.lane_take_plain(src, torch.as_tensor(idx))
        assert lr.lane_put.run(out, idx, part) is out
        lr.lane_put_plain(want, torch.as_tensor(idx), part)
    assert lr.lane_put.launches - before == sum(p.size > 0 for p in parts)
    _same_bits(out, want)
    _same_bits(out, src)


def test_lane_take_rows_take_the_widest_aligned_access():
    """A row is moved 16 bytes an access where both bases and the row's
    bytes are 16-byte aligned, else the widest power of two dividing
    them: a leaf one element into its allocation takes narrower pieces,
    a bool leaf one byte in goes a byte at a time."""
    rng = np.random.default_rng(3)
    B = 8
    cases = [((32,), torch.int32, 0, 16), ((32,), torch.int32, 1, 4),
             ((32,), torch.int32, 2, 8), ((5,), torch.int32, 0, 4),
             ((), torch.bool, 1, 1), ((8,), torch.bool, 0, 8),
             ((8,), torch.bool, 1, 1), ((3,), torch.float32, 0, 4),
             ((2,), torch.int64, 0, 16), ((), torch.int16, 0, 2)]
    for shape, dtype, off, chunk in cases:
        vals = torch.as_tensor(rng.integers(0, 2, (B,) + shape)).to(dtype)
        t = _offset(vals, off)
        out = torch.empty((4,) + shape, dtype=dtype)
        ix = torch.zeros(4, dtype=torch.int64)
        p = lr.rows_params([(t, out)], ix, 4, B, False)
        row = int(np.prod(shape)) * t.element_size()
        assert (p.leaves[0].chunk, p.leaves[0].chunks) == (chunk,
                                                           row // chunk), \
            (shape, dtype, off)
        assert p.blocks == -(-(4 * (row // chunk)) // lr.PIECES_A_BLOCK)


def test_lane_rows_split_more_leaves_than_a_launch_takes(standin):
    """MAX_LEAVES non-empty leaves a launch: 160 leaves, 120 of them
    non-empty, take two; the zero-size leaves take none."""
    rng = np.random.default_rng(4)
    tree = {f"l{i:03d}": torch.as_tensor(rng.integers(-9, 9, (10, i % 4)))
            .to(torch.int32) for i in range(160)}
    n = sum(t.numel() > 0 for t in tree.values())
    before = lr.lane_take.launches
    got = lr.lane_take.run(tree, np.arange(10)[::-1].copy())
    assert lr.lane_take.launches - before == -(-n // lr.MAX_LEAVES) == 2
    _same_bits(got, lr.lane_take_plain(tree, torch.arange(9, -1, -1)))


def test_lane_rows_hold_a_copied_operand_across_the_launch(standin):
    """A non-contiguous leaf (a strided view) is copied by the wrapper;
    the copy must live until the launch reads it (F17): the stand-in
    first hands out and scribbles over memory of the sizes it reads."""
    rng = np.random.default_rng(5)
    base = torch.as_tensor(rng.integers(-99, 99, (64, 12))).to(torch.int32)
    tree = {"strided": base[:, ::3], "t": base.t().contiguous().t()}
    assert not tree["strided"].is_contiguous()
    assert not tree["t"].is_contiguous()
    idx = rng.integers(0, 64, 40)
    got = lr.lane_take.run(tree, idx)
    _same_bits(got, lr.lane_take_plain(tree, torch.as_tensor(idx)))
    a = [base[:, ::3], base[:, 1::3]]
    b = [base[:, ::3], base[:, 1::3].clone()]
    b[1][7, 2] += 1
    flags = ld.lane_diff.run(a, b)
    assert flags.sum().item() == 1 and flags[1, 7].item() == 1


@pytest.mark.parametrize("bad", ["repeat", "negative", "past_the_end",
                                 "two_dims", "on_the_device_side"])
def test_lane_put_refuses_a_bad_index(standin, bad):
    """The writes are unordered, so a lane written twice is refused on the
    host, before any launch; so is an index out of range."""
    out = {"x": torch.zeros((8, 3), dtype=torch.int32)}
    part = {"x": torch.ones((3, 3), dtype=torch.int32)}
    idx = {"repeat": np.array([1, 4, 1]), "negative": np.array([1, -1, 2]),
           "past_the_end": np.array([1, 8, 2]),
           "two_dims": np.array([[1, 2, 3]]),
           "on_the_device_side": torch.tensor([1, 2, 3],
                                              device="meta")}[bad]
    before = lr.lane_put.launches
    err = {"repeat": ValueError, "negative": IndexError,
           "past_the_end": IndexError, "two_dims": ValueError,
           "on_the_device_side": ValueError}[bad]
    with pytest.raises(err):
        lr.lane_put.run(out, idx, part)
    with pytest.raises(err):
        lr.lane_put(out, idx, part)
    assert lr.lane_put.launches == before
    assert not out["x"].any()


def test_a_refused_table_raises():
    """The stand-in refuses a table whose blocks do not follow each
    other, as the launcher does; the wrapper raises on the refusal."""
    t = torch.arange(16, dtype=torch.int32).reshape(8, 2)
    out = torch.empty((4, 2), dtype=torch.int32)
    ix = torch.arange(4, dtype=torch.int64)
    p = lr.rows_params([(t, out), (t, out)], ix, 4, 8, False)
    assert _rows_standin(ctypes.byref(p), None) == 0
    p.leaves[1].first += 1
    assert _rows_standin(ctypes.byref(p), None) == 1
    real = lr.rows_params
    try:
        lr.rows_params = lambda *a: p
        lr.lane_take._fn = _rows_standin
        with pytest.raises(RuntimeError, match="launch failed"):
            lr.lane_take.run([t, t], np.arange(4))
    finally:
        lr.rows_params = real
        lr.lane_take._fn = None


DIFF_CASES = {
    # case: (lanes, offset in elements)
    "B1": (1, 0),
    "aligned": (300, 0),
    "one_element_in": (129, 1),
}


@pytest.mark.parametrize("case", sorted(DIFF_CASES))
def test_lane_diff_through_the_kernel_path(standin, case):
    """Planted differences in every dtype, -0.0 against 0.0 and NaN
    against NaN (no difference), NaN against a number (a difference);
    zero-size leaves; every row group size from 1 to 32 threads."""
    B, off = DIFF_CASES[case]
    rng = np.random.default_rng(B + off)
    a = _leaves(_mixed_tree(rng, B, off))
    b = [_offset(t.clone(), off) for t in a]
    lanes = rng.integers(0, B, 6)
    b[0][lanes[0]] = ~b[0][lanes[0]]                  # bool
    b[3][lanes[1], 95] += 1                           # int16, last element
    b[6][lanes[2], 0, 0] ^= 1 << 30                   # the payload
    b[7][lanes[3], 1] += 2 ** 40                      # int64's high word
    f = b[8]
    f[lanes[4], 0] = 7.0 if torch.isnan(a[8][lanes[4], 0]) else \
        float("nan")                                  # NaN vs a number
    zero = a[8] == 0
    f[zero] = -a[8][zero]                             # -0.0 vs 0.0
    before = ld.lane_diff.launches
    got = ld.lane_diff.run(a, b)
    assert ld.lane_diff.launches - before == 1
    want = ld.lane_diff_plain(a, b)
    assert got.dtype == torch.uint8 and torch.equal(got, want)
    assert got.shape == (len(a), B)
    p = ld.diff_params(list(zip(a, b)), got, B)
    assert {p.leaves[i].shift for i in range(len(a))} >= {0, 5}
    assert not got[9].any() and not got[11].any()     # zero-size leaves


def test_lane_diff_of_a_state_with_itself_is_clean(standin):
    """A flagship state (49 non-empty leaves, the payload 96 x 8 int32 a
    lane) against itself and against a copy: no flag; one lane's clock
    moved: exactly that lane of `.now`."""
    rt = workloads.flagship_runtime(device="cpu")
    s, _ = rt.run(rt.init_batch(np.arange(37, dtype=np.uint32)), 24,
                  chunk=24)
    la = list(interop.state_leaves(s).values())
    lb = [t.clone() for t in la]
    assert not ld.lane_diff.run(la, la).any()
    assert not ld.lane_diff.run(la, lb).any()
    paths = list(interop.state_leaves(s))
    lb[paths.index(".now")][11] += 1
    got = ld.lane_diff.run(la, lb)
    assert got.sum().item() == 1
    assert got[paths.index(".now"), 11].item() == 1
