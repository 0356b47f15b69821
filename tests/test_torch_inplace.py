"""The in-place emission write and the ownership rules around it, on the
CPU (tolerance: zero).

`emit_write` writes the rows emissions take, and the one ring row a
recording lane writes, into the tensors it is handed (ops/emit_write.py).
The step therefore writes its input state, the runners step a private
copy of the caller's state, and `FusedGraph` copies a block's final state
back into its static buffers, skipping the buffers the step wrote in
place. The plain version is checked here on the edge-case operands that
chip_smoke.py holds the CUDA kernel to on the card; its values against
the JAX package are checked through whole steps in tests/test_torch_emit.py
and through the golden runs in tests/test_torch_fs.py.
"""

import numpy as np
import pytest
import torch

from chip_smoke import clone_tree as _clone
from chip_smoke import emit_edge_operands
from madsim_tpu_torch import interop, workloads
from madsim_tpu_torch.ops.emit_write import (RING_COLS, TABLE_COLS,
                                             emit_write_plain)

# (C, E, n_sends, jitter, ring): the edge cases of chip_smoke.py's kernel
# phase, at B=256 lanes
EDGE = {f"C{c}_E{e}_sends{s}{'_jitter' if j else ''}{'_ring' if r else ''}":
        (c, e, s, j, r)
        for c, e, s, j, r in ((96, 12, 7, True, True), (96, 0, 0, False, True),
                              (256, 3, 1, False, True),
                              (256, 5, 0, True, False),
                              (256, 6, 6, False, False))}


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
