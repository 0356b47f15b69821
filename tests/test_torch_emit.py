"""The emission write (`ops/emit_write.py`) against the JAX package
(tolerance: zero), on the CPU, where `emit_write` runs its plain version.

The corners of the emission write go through whole-step comparisons with
the JAX step (`madsim_tpu/core/step.py` section 4 and the ring write):
per-emission micro-jitter, a full event table (OOPS_EVENT_OVERFLOW),
clock skew and disk delay, clogged nodes and links, loss 0 and 1, with
the flight recorder and lineage on. The wrapper's own contract — it
checks what it is handed, counts only kernel launches, and is the
identity with nothing to write — is tested directly, and so is the
in-place write: the tensors it is handed come back, written only in the
rows emissions take and the one ring row a recording lane writes. The
CUDA kernel is held against the plain version on the card by
chip_smoke.py. The JAX side runs on the non-partitionable threefry
stream (see _torch_parity).
"""

import numpy as np
import pytest
import torch

from _torch_parity import assert_same, jax_leaves, reference_stream
from chip_smoke import clone_tree as _clone
from madsim_tpu_torch import interop


def _flood_programs():
    """One protocol written for both packages that emits as much as the
    engine allows: every timer broadcasts to every other node and re-arms,
    every third message arms another timer."""
    from madsim_tpu import Program as JProgram
    from madsim_tpu_torch import Program as TProgram

    def make(base):
        class Flood(base):
            def __init__(self, n):
                self.n = n

            def init(self, ctx):
                for j in range(3):
                    ctx.set_timer(ctx.randint(0, 2000), 1 + j)

            def on_timer(self, ctx, tag, payload):
                st = dict(ctx.state)
                st["fired"] = st["fired"] + 1
                for d in range(self.n):
                    ctx.send(d, 7, [tag, st["fired"]], when=ctx.node != d)
                ctx.set_timer(ctx.randint(500, 3000), tag,
                              when=st["fired"] < 40)
                ctx.state = st

            def on_message(self, ctx, src, tag, payload):
                st = dict(ctx.state)
                st["got"] = st["got"] + 1
                ctx.set_timer(ctx.randint(0, 300), 4,
                              when=(st["got"] % 3) == 0)
                ctx.state = st
        return Flood

    return make(JProgram), make(TProgram)


def _scenario(mod, ms):
    sc = mod.Scenario()
    sc.at(ms(1)).set_skew(1, 300)
    sc.at(ms(1)).set_skew(2, -200)
    sc.at(ms(2)).set_disk(2, ms(1))
    sc.at(ms(3)).clog_link(0, 1)
    sc.at(ms(3)).clog_node(3)
    sc.at(ms(4)).set_loss(1.0)
    sc.at(ms(5)).set_loss(0.0)
    sc.at(ms(7)).heal()
    sc.at(ms(8)).set_loss(0.3)
    return sc


# (event_capacity, op_jitter_max, steps): the roomy table takes every
# fault corner with jitter on; the small one overflows; the wide ones are
# tables past 256 rows (the kernels' wide instantiations: 257, and chain
# replication's 384)
CASES = {"corners_jitter": (256, 200, 160), "overflow": (20, 0, 96),
         "wide_C257_jitter": (257, 200, 96), "wide_C384": (384, 0, 96)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_emission_corners_match_reference_leaf_for_leaf(case):
    import madsim_tpu as J
    import madsim_tpu.runtime.scenario as jsc
    import madsim_tpu_torch as P
    import madsim_tpu_torch.runtime.scenario as tsc
    C, jitter, steps = CASES[case]
    JFlood, TFlood = _flood_programs()
    net = dict(packet_loss_rate=0.2, send_latency_min=J.ms(1),
               send_latency_max=J.ms(2), op_jitter_max=jitter)
    kw = dict(n_nodes=4, time_limit=J.sec(5), event_capacity=C,
              trace_cap=16)
    seeds = np.arange(16, dtype=np.uint32)
    lanes = np.arange(0, 16, 3)
    with reference_stream():
        import jax.numpy as jnp
        spec = dict(fired=jnp.int32(0), got=jnp.int32(0))
        jrt = J.Runtime(J.SimConfig(**kw, net=J.NetConfig(**net)),
                        [JFlood(4)], spec, scenario=_scenario(jsc, J.ms))
        s, _ = jrt.run(jrt.init_batch(seeds, trace_lanes=lanes), steps,
                       chunk=steps // 2)
        ref = jax_leaves(s)
    spec = dict(fired=torch.tensor(0, dtype=torch.int32),
                got=torch.tensor(0, dtype=torch.int32))
    trt = P.Runtime(P.SimConfig(**kw, net=P.NetConfig(**net)), [TFlood(4)],
                    spec, scenario=_scenario(tsc, P.ms), device="cpu")
    t, _ = trt.run(trt.init_batch(seeds, trace_lanes=lanes), steps,
                   chunk=steps // 2)
    got = interop.state_to_numpy(t)
    assert_same(ref, got, what=f"emission corners ({case})")
    # the corners were really reached
    assert got[".msg_dropped"].sum() > 0
    assert (got[".skew"] != 0).any() and (got[".disk_lat"] != 0).any()
    assert (got[".trace_pos"][lanes] > 0).all()
    overflowed = (got[".oops"] & P.core.types.OOPS_EVENT_OVERFLOW) != 0
    assert overflowed.any() == (case == "overflow")


# --------------------------------------------------------------------------
# The wrapper's contract on the CPU
# --------------------------------------------------------------------------
def _operands(rt, state):
    """The emit_write operands of the next step of `state`, copied before
    the write (which is in place), from a step of a copy of `state`."""
    import madsim_tpu_torch.core.step as step_mod
    from madsim_tpu_torch.core.state import map_state
    seen = []
    real = step_mod.emit_write

    def spy(*args):
        seen.append(_clone(args))
        return real(*args)

    step_mod.emit_write = spy
    try:
        rt._step(map_state(torch.clone, state))
    finally:
        step_mod.emit_write = real
    return seen[0]


@pytest.fixture(scope="module")
def flagship_operands():
    from madsim_tpu_torch import workloads
    rt = workloads.flagship_runtime(device="cpu", trace_cap=64)
    s, _ = rt.run(rt.init_batch(np.arange(4, dtype=np.uint32)), 40,
                  chunk=40)
    return _operands(rt, s)


def test_wrapper_takes_the_plain_version_on_the_cpu(flagship_operands):
    from madsim_tpu_torch.ops.emit_write import emit_write, emit_write_plain
    before = (emit_write.launches, emit_write.captured)
    ops_a, ops_b = _clone(flagship_operands), _clone(flagship_operands)
    out = emit_write(*ops_a)
    want = emit_write_plain(*ops_b)
    assert (emit_write.launches, emit_write.captured) == before
    for a, b in zip(out[:2], want[:2]):
        for k in b:
            assert torch.equal(a[k], b[k]), k
    assert all(out[0][k] is ops_a[0][k] for k in ops_a[0])
    assert torch.equal(out[2]["trace_pos"], want[2]["trace_pos"])
    for k in want[2]["cols"]:
        assert torch.equal(out[2]["cols"][k], want[2]["cols"][k]), k
    tables, em, lane, ring, n_sends, _ = flagship_operands
    assert em["m"].shape[1] == 8 and n_sends == 5
    assert ring is not None and tables["ev_prov"].shape[1] == 96


def test_wrapper_refuses_what_the_kernel_would_not_take(flagship_operands):
    from madsim_tpu_torch.ops.emit_write import emit_write
    tables, em, lane, ring, n_sends, jit = flagship_operands
    bad = dict(tables, t_tag=tables["t_tag"].t().contiguous().t())
    with pytest.raises(ValueError, match="contiguous"):
        emit_write(bad, em, lane, ring, n_sends, jit)
    bad = dict(lane, now=lane["now"][:2])
    with pytest.raises(ValueError, match="shape"):
        emit_write(tables, em, bad, ring, n_sends, jit)


def test_nothing_to_write_is_the_identity(flagship_operands):
    from madsim_tpu_torch.ops.emit_write import emit_write
    tables, em, lane, _, _, jit = flagship_operands
    empty = {k: v[:, :0] for k, v in em.items()}
    out, stats, ring = emit_write(tables, empty, lane, None, 0, jit)
    assert ring is None
    assert all(out[k] is tables[k] for k in tables)
    assert all(not v.any() for v in stats.values())


def test_ring_only_writes_the_dispatched_record(flagship_operands):
    """E = 0 with the recorder on: the tables pass through, one ring row
    per sampled, dispatching lane is written at trace_pos mod trace_cap."""
    from madsim_tpu_torch.ops.emit_write import RING_COLS, emit_write
    tables, em, lane, ring, _, jit = _clone(flagship_operands)
    old = _clone(ring["cols"])
    empty = {k: v[:, :0] for k, v in em.items()}
    out, _, new = emit_write(tables, empty, lane, ring, 0, jit)
    assert all(out[k] is tables[k] for k in tables)
    assert all(new["cols"][k] is ring["cols"][k] for k in RING_COLS)
    rec = ring["fired"] & ring["trace_on"]
    assert torch.equal(new["trace_pos"], ring["trace_pos"] + rec.int())
    slot = torch.remainder(ring["trace_pos"], ring["trace_cap"])
    for k in RING_COLS:
        changed = (new["cols"][k] != old[k]).sum(1)
        assert (changed <= rec.int()).all()
    b = int(torch.nonzero(rec)[0, 0])
    assert int(new["cols"]["tr_now"][b, slot[b]]) == int(lane["now"][b])
    assert int(new["cols"]["tr_step"][b, slot[b]]) == int(lane["disp_idx"][b])
