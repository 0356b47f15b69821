"""The in-place writes and the ownership rules around them, on the CPU
(tolerance: zero).

`emit_write` writes the rows emissions take, and the one ring row a
recording lane writes, into the tensors it is handed (ops/emit_write.py).
The step therefore writes its input state, the runners step a private
copy of the caller's state, and `FusedGraph` copies a block's final state
back into its static buffers, skipping the buffers the step wrote in
place. The plain version is checked here on the edge-case operands that
chip_smoke.py holds the CUDA kernel to on the card; its values against
the JAX package are checked through whole steps in tests/test_torch_emit.py
and through the golden runs in tests/test_torch_fs.py.

`apply_knobs` writes rows [n_init, n_init + R + D) of the six table
columns into the tensors it is handed (ops/apply_knobs.py), so
`KnobPlan.apply` writes the state it is given and `apply_repro_knobs`
writes a copy. Checked here on chip_smoke.py's foreign knobs (out of
every bound) for the all-knobs plan and the flagship's; the values
against the JAX package's `_apply_batch` are checked leaf for leaf in
tests/test_torch_search.py.
"""

import numpy as np
import pytest
import torch

from chip_smoke import clone_tree as _clone
from chip_smoke import edge_knobs, emit_edge_operands
from madsim_tpu_torch import interop, workloads
from madsim_tpu_torch.ops import apply_knobs as ak
from madsim_tpu_torch.ops.emit_write import (RING_COLS, TABLE_COLS,
                                             emit_write_plain)
from madsim_tpu_torch.search.mutate import KnobPlan, apply_repro_knobs

# (C, E, n_sends, jitter, ring): the edge cases of chip_smoke.py's kernel
# phase, at B=256 lanes
EDGE = {f"C{c}_E{e}_sends{s}{'_jitter' if j else ''}{'_ring' if r else ''}":
        (c, e, s, j, r)
        for c, e, s, j, r in ((96, 12, 7, True, True), (96, 0, 0, False, True),
                              (256, 3, 1, False, True),
                              (256, 5, 0, True, False),
                              (256, 6, 6, False, False),
                              (257, 4, 2, True, True),
                              (384, 9, 6, False, True),
                              (384, 5, 1, True, False))}


def _edge(case):
    C, E, ns, jit, ring = EDGE[case]
    return emit_edge_operands("cpu", 256, C, 5, 8, E, ns, jit, ring, ring,
                              seed=C + E)


@pytest.mark.parametrize("case", sorted(EDGE))
def test_plain_write_returns_the_tensors_it_was_given(case):
    tables, em, lane, ring, ns, jit = _edge(case)
    out, stats, new_ring = emit_write_plain(tables, em, lane, ring, ns, jit)
    assert all(out[k] is tables[k] for k in TABLE_COLS)
    if ring is None:
        assert new_ring is None
    else:
        assert all(new_ring["cols"][k] is ring["cols"][k] for k in RING_COLS)
        assert new_ring["trace_pos"] is not ring["trace_pos"]
    assert stats["high_water"].shape == (256,)


@pytest.mark.parametrize("case", sorted(EDGE))
def test_plain_write_leaves_every_unwritten_row_as_it_was(case):
    """Rows change only where an emission took them — free rows among
    each lane's first E, now occupied, `high_water - occupied` of them —
    and the ring changes in one row of each recording lane only."""
    args = _edge(case)
    before = _clone(args)
    tables, em, lane, ring, ns, jit = args
    _, stats, new_ring = emit_write_plain(tables, em, lane, ring, ns, jit)
    kind0 = before[0]["t_kind"]
    free = kind0 == 0
    E = em["m"].shape[1]
    taken = free & (tables["t_kind"] != 0)
    n_taken = (stats["high_water"] - (~free).sum(1, dtype=torch.int32)
               if E else torch.zeros_like(stats["high_water"]))
    assert torch.equal(taken.sum(1, dtype=torch.int32), n_taken)
    rank = torch.cumsum(free.int(), 1) - 1
    assert not (taken & (rank >= E)).any()
    for k in TABLE_COLS:
        old, new = before[0][k], tables[k]
        if not old.numel():
            continue
        changed = (old != new).reshape(*kind0.shape, -1).any(-1)
        assert not (changed & ~taken).any(), k
    assert (n_taken > 0).any() == (E > 0)
    if ring is not None:
        rec = ring["fired"] & ring["trace_on"]
        slot = torch.remainder(ring["trace_pos"], ring["trace_cap"])
        hit = torch.arange(ring["cols"]["tr_now"].shape[1]) == slot[:, None]
        hit &= rec[:, None]
        for k in RING_COLS:
            changed = before[3]["cols"][k] != ring["cols"][k]
            assert not (changed & ~hit).any(), k
        assert torch.equal(ring["cols"]["tr_now"][hit],
                           lane["now"][hit.any(1)])
        assert torch.equal(new_ring["trace_pos"],
                           ring["trace_pos"] + rec.int())


def test_plain_write_equals_itself_on_copies():
    """Two writes on copies of the same operands agree leaf for leaf, and
    a second write on the written tables takes further free rows (the
    write is not idempotent: a caller must hand it fresh operands)."""
    args = _edge("C96_E12_sends7_jitter_ring")
    a, b = _clone(args), _clone(args)
    out_a = emit_write_plain(*a)
    out_b = emit_write_plain(*b)
    for k in TABLE_COLS:
        assert torch.equal(out_a[0][k], out_b[0][k]), k
    for k in RING_COLS:
        assert torch.equal(out_a[2]["cols"][k], out_b[2]["cols"][k]), k
    occupied = (a[0]["t_kind"] != 0).sum()
    emit_write_plain(*a)
    assert (a[0]["t_kind"] != 0).sum() > occupied


def test_copy_back_skips_buffers_written_in_place_and_refuses_aliases():
    """FusedGraph._copy_back: a final leaf that IS its static buffer (the
    step wrote it in place) is left alone, a fresh leaf is copied in, and
    a leaf sharing storage with another static buffer raises."""
    from madsim_tpu_torch.runtime.runtime import FusedGraph
    rt = workloads.flagship_runtime(device="cpu", trace_cap=16)
    g = FusedGraph.__new__(FusedGraph)
    g.static = rt.init_batch(np.arange(2, dtype=np.uint32))
    fresh = g.static.now + 7
    final = g.static.replace(now=fresh)
    node_buf = g.static.t_node
    g._copy_back(final)
    assert torch.equal(g.static.now, fresh) and g.static.now is not fresh
    assert g.static.t_node is node_buf
    with pytest.raises(RuntimeError, match="aliases an input buffer"):
        g._copy_back(g.static.replace(t_src=g.static.t_node))
    with pytest.raises(RuntimeError, match="aliases an input buffer"):
        g._copy_back(g.static.replace(tr_tag=g.static.tr_now[:, :]))


def test_runners_leave_the_callers_state_unchanged_on_the_flagship():
    """The traced flagship: `run`, `run` again and `run_fused` from one
    state leave it bit-identical and agree with each other."""
    rt = workloads.flagship_runtime(device="cpu", trace_cap=16)
    init = rt.init_batch(np.arange(4, dtype=np.uint32))
    before = interop.leaf_digests(init)
    a, _ = rt.run(init, 40, chunk=20)
    b, _ = rt.run(init, 40, chunk=20)
    f = rt.run_fused(init, 40, chunk=20)
    assert interop.leaf_digests(init) == before
    da = interop.leaf_digests(a)
    assert da == interop.leaf_digests(b) == interop.leaf_digests(f)
    assert da[".t_payload"] != before[".t_payload"]
    assert da[".tr_now"] != before[".tr_now"]


# --------------------------------------------------------------------------
# The knob write
# --------------------------------------------------------------------------
KNOB_B = 64
_KNOB_RTS: dict = {}


def _knob_rt(name):
    """(runtime, plan) of the all-knobs pingpong or the flagship, built
    once."""
    if name not in _KNOB_RTS:
        rt = dict(all_knobs=workloads.all_knobs_runtime,
                  flagship=workloads.flagship_runtime)[name](device="cpu")
        _KNOB_RTS[name] = (rt, KnobPlan.from_runtime(rt))
    return _KNOB_RTS[name]


def _knob_operands(name, seed=3, state=None):
    """apply_knobs operands: a fresh init batch (or `state`) and
    chip_smoke.py's edge knobs (base, havoc-6 and foreign lanes)."""
    rt, plan = _knob_rt(name)
    st = rt.init_batch(np.arange(KNOB_B, dtype=np.uint32)) \
        if state is None else state
    guards, base = plan._device_tables("cpu")
    kb = edge_knobs(plan, KNOB_B, seed, "cpu")
    cols = {n: getattr(st, n) for n in ak.TABLE_COLS}
    return (cols, st.tlimit, st.jitter, kb, base, guards, plan.n_init,
            plan.jitter_gate)


@pytest.mark.parametrize("name", ["all_knobs", "flagship"])
@pytest.mark.parametrize("fn", ["apply_knobs_plain", "apply_knobs"])
def test_knob_write_returns_the_tensors_it_was_given(name, fn):
    """The plain version, and the wrapper that takes it on the CPU, write
    the table columns in place and return them; the lane scalars are new
    tensors."""
    args = _knob_operands(name)
    cols, _, jitter, kb = args[:4]
    out = getattr(ak, fn)(*args)
    assert all(out[n] is cols[n] for n in ak.TABLE_COLS)
    assert set(out) == set(ak.TABLE_COLS) | set(ak.SCALARS)
    for n in ak.SCALARS:
        assert out[n] is not kb[n] and out[n] is not jitter, n


@pytest.mark.parametrize("name", ["all_knobs", "flagship"])
def test_knob_write_leaves_every_other_row_as_it_was(name):
    """Only rows [n_init, n_init + R + D) change, in every column, with
    every row garbage beforehand (so a row left alone is seen to be)."""
    args = _knob_operands(name)
    cols = args[0]
    gen = torch.Generator().manual_seed(5)
    for n, c in cols.items():
        c.copy_(torch.randint(-2 ** 31, 2 ** 31 - 1, c.shape, generator=gen,
                              dtype=c.dtype))
    before = _clone(cols)
    ak.apply_knobs_plain(*args)
    _, plan = _knob_rt(name)
    lo, hi = plan.n_init, plan.n_init + plan.R + plan.D
    written = torch.zeros(cols["t_kind"].shape, dtype=torch.bool)
    written[:, lo:hi] = True
    for n, c in cols.items():
        changed = (before[n] != c).reshape(*written.shape, -1).any(-1)
        assert not (changed & ~written).any(), n
    assert (before["t_kind"] != cols["t_kind"])[:, lo:hi].any()


@pytest.mark.parametrize("name", ["all_knobs", "flagship"])
def test_knob_write_is_idempotent(name):
    """Writing into a state that already holds other knobs (or garbage in
    the written rows) gives the same state as writing into a fresh
    init_batch: the written rows depend on the knobs alone, which is what
    lets the card time the kernel by replaying it."""
    rt, plan = _knob_rt(name)
    seeds = np.arange(KNOB_B, dtype=np.uint32)
    kb = edge_knobs(plan, KNOB_B, 9, "cpu")
    fresh = plan.apply(rt.init_batch(seeds), kb)
    used = plan.apply(rt.init_batch(seeds), edge_knobs(plan, KNOB_B, 4,
                                                       "cpu"))
    again = plan.apply(used, kb)
    junk = rt.init_batch(seeds)
    lo, hi = plan.n_init, plan.n_init + plan.R + plan.D
    for n in ak.TABLE_COLS:
        getattr(junk, n)[:, lo:hi] = -7
    over_junk = plan.apply(junk, kb)
    want = interop.leaf_digests(fresh)
    assert interop.leaf_digests(again) == want
    assert interop.leaf_digests(over_junk) == want
    # `again` wrote `used`'s table columns, not its scalars
    assert all(getattr(again, n) is getattr(used, n) for n in ak.TABLE_COLS)


@pytest.mark.parametrize("name", ["all_knobs", "flagship"])
def test_apply_repro_knobs_leaves_the_callers_state_unchanged(name):
    """The replay idiom keeps the reference's functional contract: it
    writes a copy of the table columns, never the caller's state."""
    rt, plan = _knob_rt(name)
    state = rt.init_batch(np.arange(6, dtype=np.uint32))
    before = interop.leaf_digests(state)
    kn = KnobPlan.lane(edge_knobs(plan, KNOB_B, 3, "cpu"), KNOB_B - 1)
    got, _ = apply_repro_knobs(rt, state, kn, plan)
    assert interop.leaf_digests(state) == before
    assert all(getattr(got, n) is not getattr(state, n)
               for n in ak.TABLE_COLS)
    assert interop.leaf_digests(got) != before


@pytest.mark.parametrize("name", ["all_knobs", "flagship"])
def test_init_batch_table_columns_share_no_storage(name):
    """Every lane of every table column has storage of its own (no
    expanded template), so an in-place write to one lane of one column
    reaches nothing else."""
    rt, _ = _knob_rt(name)
    s = rt.init_batch(np.arange(4, dtype=np.uint32))
    other = rt.init_batch(np.arange(4, dtype=np.uint32))
    ptrs = set()
    for n in ak.TABLE_COLS:
        c = getattr(s, n)
        assert c.is_contiguous() and c.stride(0) == c[0].numel(), n
        ptrs.add(c.untyped_storage().data_ptr())
        assert c.untyped_storage().data_ptr() != \
            getattr(other, n).untyped_storage().data_ptr(), n
    assert len(ptrs) == len(ak.TABLE_COLS)
    before = interop.leaf_digests(other)
    for n in ak.TABLE_COLS:
        c = getattr(s, n)
        lane1 = c[1].clone()
        c[0] += 1
        assert torch.equal(c[1], lane1), n
    assert interop.leaf_digests(other) == before
