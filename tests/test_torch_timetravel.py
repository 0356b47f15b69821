"""The port's time travel (lane checkpoints in `core/state.py`,
`obs/timetravel.py`, `run(ckpt_every=)` / `run_fused(ckpt_every=)`,
`explain_crash(replay=True)`) against the JAX package (tolerance: zero),
on the CPU.

Mirrors classes 1-4 of the JAX package's tests/test_timetravel.py on its
own workloads: the crash-rich wal_kv with a 4-slot ring that wraps at
once (bench.py `_make_crashrich_runtime("wal_kv", trace_cap=4)`; the
port's `workloads.crashrich_wal_kv_runtime`) and the saturating pingpong
(bench.py `_make_saturating_runtime`). Covers the harvest (it never
perturbs; its snapshots, steps and lane steps equal the reference's,
through `run` and `run_fused`), the child that continues bitwise, a
fork's leaves owning their memory, LaneCheckpoint files across the two
packages and the rejections, the observability upgrade, window replay
behind `explain_crash(replay=True)` (the same chain, fingerprint and
trace bytes). The divergence microscope is in
tests/test_torch_timetravel_microscope.py. Eight seeds (the JAX test
runs 12 and 24) and chunks of 16 for the replays: the port's eager CPU
step costs 20-40 ms (ROADMAP F24). The campaign-store cases
(`replay_bucket`, bucket records) wait for ROADMAP P14. The JAX side runs on the non-partitionable threefry stream (see
_torch_parity); each JAX reference is computed once.
"""

import numpy as np
import pytest
import torch

import madsim_tpu as J
from _torch_parity import (assert_same, equal_results, jax_leaves,  # noqa
                           one_cpu_thread, reference_stream)
from madsim_tpu_torch import (CheckpointLog, CheckpointMismatch,
                              LaneCheckpoint, checkpoint_lane, interop,
                              seed_batch_from, workloads)
from madsim_tpu_torch.obs import causal, explain_crash
from madsim_tpu_torch.obs.rings import ring_records
from madsim_tpu_torch.obs.timetravel import (ReplayDivergence,
                                             advance_exact,
                                             full_chain_replay,
                                             replay_window)
from madsim_tpu_torch.runtime import checkpoint as batch_ckpt

pytestmark = pytest.mark.usefixtures("one_cpu_thread")

SEEDS = np.arange(8, dtype=np.uint32)
MAX_STEPS, CHUNK, EVERY = 30_000, 16, 32
REPLAY_CHUNK = 16            # explain_crash(replay=True)'s runs


def _crashrich(trace_cap=4):
    return workloads.crashrich_wal_kv_runtime(device="cpu",
                                              trace_cap=trace_cap)


def _saturating():
    return workloads.saturating_runtime(device="cpu")


def _np(state):
    return interop.state_to_numpy(state)


def _lane(leaves: dict, lane: int) -> dict:
    return {k: v[lane] for k, v in leaves.items()}


def _truncated_lane(state, explain):
    """The JAX test's specimen: the first crashed lane whose live chain
    the ring wrapped past, with more than 40 dispatches."""
    steps = np.asarray(state.steps)
    for lane in np.nonzero(np.asarray(state.crashed))[0]:
        exp = explain(state, int(lane))
        if exp["truncated"] and steps[lane] > 40:
            return int(lane), exp
    raise AssertionError("workload produced no wrap-truncated crash")


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The JAX package's answers, once a module."""
    from bench import _make_crashrich_runtime, _make_saturating_runtime
    from madsim_tpu.obs.causal import causal_fingerprint
    d = tmp_path_factory.mktemp("tt_ref")
    out = {}
    with reference_stream():
        rt = _make_crashrich_runtime("wal_kv", trace_cap=4)
        log = J.CheckpointLog()
        s, _ = rt.run(rt.init_batch(SEEDS), MAX_STEPS, CHUNK,
                      ckpt_every=EVERY, ckpt_log=log)
        out["final"] = jax_leaves(s)
        out["fp"] = np.asarray(rt.fingerprints(s))
        out["snaps"] = [(sn["steps_done"], sn["signature"],
                         jax_leaves(sn["state"])) for sn in log.snaps]
        out["lane_steps"] = [log.lane_steps(b) for b in range(len(SEEDS))]
        lane, live = _truncated_lane(s, J.explain_crash)
        out["lane"], out["live"] = lane, live
        path = str(d / "window.json")
        full = J.explain_crash(s, lane, replay=True, rt=rt, ckpts=log,
                               chunk=REPLAY_CHUNK, export_trace=path)
        with open(path, "rb") as f:
            out["window_trace"] = f.read()
        out["full"] = full
        out["full_cfp"] = causal_fingerprint(full)
        ck = log.nearest(lane)
        out["ck_leaves"] = jax_leaves(ck.state)
        out["ck_steps"] = ck.steps
        out["ck_path"] = str(d / "jax_lane.npz")
        ck.save(out["ck_path"])
        out["rt"] = rt
        sat = _make_saturating_runtime()
        p = sat.run_fused(sat.init_batch(np.arange(4)), 64, 4)
        out["sat_fp"] = np.asarray(sat.fingerprints(p))
        out["sat_crashed"] = np.asarray(p.crashed)
    return out


@pytest.fixture(scope="module")
def port():
    rt = _crashrich()
    parent, _ = rt.run(rt.init_batch(SEEDS), MAX_STEPS, CHUNK)
    log = CheckpointLog()
    s, _ = rt.run(rt.init_batch(SEEDS), MAX_STEPS, CHUNK, ckpt_every=EVERY,
                  ckpt_log=log)
    return dict(rt=rt, parent=parent, state=s, log=log)


# --------------------------------------------------------------------------
# (1) the harvest and the child's fidelity
# --------------------------------------------------------------------------
def test_harvest_never_perturbs_and_equals_the_reference(ref, port):
    rt, s, log = port["rt"], port["state"], port["log"]
    np.testing.assert_array_equal(rt.fingerprints(s),
                                  rt.fingerprints(port["parent"]))
    assert_same(ref["final"], _np(s), what="harvested run")
    np.testing.assert_array_equal(rt.fingerprints(s), ref["fp"])
    assert len(log) == len(ref["snaps"]) > 2
    for i, (sn, (steps_done, sig, leaves)) in enumerate(
            zip(log.snaps, ref["snaps"])):
        assert sn["steps_done"] == steps_done, i
        assert sn["signature"] == sig == rt.cfg.structural_signature()
        assert_same(leaves, _np(sn["state"]), what=f"snapshot {i}")
    assert [log.lane_steps(b) for b in range(len(SEEDS))] == \
        ref["lane_steps"]
    assert rt.last_ckpt_log is log


def test_run_fused_harvests_the_same_snapshots(port):
    rt = port["rt"]
    log = CheckpointLog()
    f = rt.run_fused(rt.init_batch(SEEDS), MAX_STEPS, CHUNK,
                     ckpt_every=EVERY, ckpt_log=log)
    assert rt.last_ckpt_log is log
    assert_same(_np(port["state"]), _np(f), what="run_fused")
    assert [sn["steps_done"] for sn in log.snaps] == \
        [sn["steps_done"] for sn in port["log"].snaps]
    for a, b in zip(port["log"].snaps, log.snaps):
        assert_same(_np(a["state"]), _np(b["state"]))
    # the sugar form: ckpt_every alone makes the log
    rt.run_fused(rt.init_batch(SEEDS[:2]), 64, CHUNK, ckpt_every=EVERY)
    assert rt.last_ckpt_log is not log and len(rt.last_ckpt_log) >= 2
    with pytest.raises(ValueError, match="positive"):
        rt.run(rt.init_batch(SEEDS[:1]), 16, CHUNK, ckpt_every=0)


def test_child_continues_bitwise_through_both_runners(ref, port):
    rt, parent, log = port["rt"], port["parent"], port["log"]
    steps = parent.steps.numpy()
    lane = int(np.argmax(steps))
    ck = log.nearest(lane)
    assert 0 < ck.steps < int(steps[lane])
    want = _lane(ref["final"], lane)
    child_f = rt.run_fused(seed_batch_from(ck, 3, device="cpu"), MAX_STEPS,
                           CHUNK)
    child_c, _ = rt.run(seed_batch_from(ck, 2, rt=rt), MAX_STEPS, CHUNK)
    for child, n in ((child_f, 3), (child_c, 2)):
        got = _np(child)
        for b in range(n):
            assert_same(want, _lane(got, b), what=f"child lane {b}")


def test_a_fork_owns_its_memory(port):
    """seed_batch_from broadcasts with a lane_take of B repeats, never an
    expand view: the step writes its input in place, so every lane must
    own its rows."""
    ck = port["log"].nearest(0)
    child = seed_batch_from(ck, 4, rt=port["rt"])
    leaves = interop.state_leaves(child)
    for path, t in leaves.items():
        assert t.stride(0) != 0, path
        if not t.numel():
            continue
        before = t[1].clone()
        if t.dtype == torch.bool:
            t[0] = ~t[0]
        else:
            t[0] += 1
        assert torch.equal(t[1], before), path
    ptrs = [t.untyped_storage().data_ptr() for t in leaves.values()
            if t.numel()]
    assert len(ptrs) == len(set(ptrs))


def test_checkpoint_lane_rejects_unbatched():
    rt = _saturating()
    with pytest.raises(ValueError, match="BATCHED"):
        checkpoint_lane(rt._template, 0)


# --------------------------------------------------------------------------
# the durable form
# --------------------------------------------------------------------------
def test_lane_checkpoint_files_cross_load(ref, port, tmp_path):
    rt, log = port["rt"], port["log"]
    lane = ref["lane"]
    mine = log.nearest(lane)
    assert mine.steps == ref["ck_steps"]
    assert_same(ref["ck_leaves"], _np(mine.state), what="checkpoint_lane")
    # the JAX package's file, here
    theirs = LaneCheckpoint.load(ref["ck_path"], rt)
    assert theirs.steps == mine.steps
    assert theirs.signature == rt.cfg.structural_signature()
    assert_same(ref["ck_leaves"], _np(theirs.state), what="JAX file")
    child, _ = rt.run(seed_batch_from(theirs, 1, rt=rt), MAX_STEPS, CHUNK)
    assert int(rt.fingerprints(child)[0]) == int(ref["fp"][lane])
    # this package's file, there
    p = str(tmp_path / "port_lane.npz")
    mine.save(p)
    with reference_stream():
        back = J.LaneCheckpoint.load(p, ref["rt"])
        assert back.steps == mine.steps
        assert back.signature == mine.signature
        assert_same(ref["ck_leaves"], jax_leaves(back.state),
                    what="port file")


def test_batch_snapshots_and_foreign_worlds_are_rejected(ref, port,
                                                         tmp_path):
    rt = port["rt"]
    p = str(tmp_path / "batch.npz")
    batch_ckpt.save(p, rt.init_batch(SEEDS[:2]))
    with pytest.raises(CheckpointMismatch, match="pre-r20"):
        LaneCheckpoint.load(p, rt)
    sat = _saturating().derived(trace_cap=16, sketch_slots=4)
    st = advance_exact(sat, sat.init_batch(np.arange(4)), 8, chunk=4)
    q = str(tmp_path / "sat_lane.npz")
    checkpoint_lane(st, 1, signature=sat.cfg.structural_signature()).save(q)
    with pytest.raises(CheckpointMismatch, match="world signature"):
        LaneCheckpoint.load(q, rt)
    with pytest.raises(J.CheckpointMismatch, match="pre-r20"):
        J.LaneCheckpoint.load(p, ref["rt"])
    # an observability difference loads (the upgrade is seed_batch_from's)
    up = sat.derived(trace_cap=64, profile=True)
    ck = LaneCheckpoint.load(q, up)
    assert ck.steps == 8


# --------------------------------------------------------------------------
# (2) the observability upgrade
# --------------------------------------------------------------------------
@pytest.mark.parametrize("tc,prof,lat", [(16, False, 0), (0, True, 0),
                                         (16, True, 8)])
def test_upgrade_keeps_fingerprint_and_verdict(ref, tc, prof, lat):
    rt = _saturating()           # every plane off: the lean build
    st = advance_exact(rt, rt.init_batch(np.arange(4)), 8, chunk=4)
    ck = checkpoint_lane(st, 2, signature=rt.cfg.structural_signature())
    up = rt.derived(trace_cap=tc, profile=prof, latency_hist=lat)
    child = up.run_fused(seed_batch_from(ck, 1, rt=up), 64, 4)
    assert int(up.fingerprints(child)[0]) == int(ref["sat_fp"][2])
    assert bool(child.crashed[0]) == bool(ref["sat_crashed"][2])


def test_upgraded_ring_records_the_window_and_worlds_are_checked():
    rt = _saturating()
    st = advance_exact(rt, rt.init_batch(np.arange(2)), 8, chunk=4)
    up = rt.derived(trace_cap=64)
    child = up.run_fused(seed_batch_from(checkpoint_lane(st, 0), 1, rt=up),
                         64, 4)
    recs = ring_records(child, 0)
    assert int(recs["step"][0]) == 8 and recs["dropped"] == 0
    other = _crashrich()
    with pytest.raises(CheckpointMismatch):
        seed_batch_from(checkpoint_lane(
            st, 0, signature=rt.cfg.structural_signature()), 1, rt=other)
    with pytest.raises(CheckpointMismatch):
        seed_batch_from(checkpoint_lane(st, 0), 1, rt=other)
    with pytest.raises(ValueError, match="reset_planes"):
        seed_batch_from(checkpoint_lane(st, 0), 1, reset_planes=("ring",),
                        device="cpu")


# --------------------------------------------------------------------------
# (3) window replay behind explain_crash(replay=True)
# --------------------------------------------------------------------------
def test_explain_crash_replay_matches_reference(ref, port, tmp_path):
    rt, s, log = port["rt"], port["state"], port["log"]
    lane, live = _truncated_lane(s, explain_crash)
    assert lane == ref["lane"]
    equal_results(ref["live"], live, "live")
    path = str(tmp_path / "window.json")
    full = explain_crash(s, lane, replay=True, rt=rt, ckpts=log,
                         chunk=REPLAY_CHUNK, export_trace=path)
    want = dict(ref["full"])
    assert full.pop("trace_path") == path and want.pop("trace_path")
    equal_results(want, full, "explain_crash(replay=True)")
    with open(path, "rb") as f:
        assert f.read() == ref["window_trace"]
    equal_results(ref["full_cfp"], causal.causal_fingerprint(full), "cfp")
    assert full["replayed"] and not full["truncated"]
    assert full["chain"][-len(live["chain"]):] == live["chain"]
    assert causal.fingerprints_match(causal.causal_fingerprint(full),
                                     causal.causal_fingerprint(live))
    again = explain_crash(s, lane, replay=True, rt=rt, ckpts=log,
                          chunk=REPLAY_CHUNK)
    assert again["chain"] == full["chain"]


def test_replay_refusals_and_the_handle(port):
    rt, s = port["rt"], port["state"]
    lane = int(np.nonzero(s.crashed.numpy())[0][0])
    with pytest.raises(ValueError, match="rt="):
        explain_crash(s, lane, replay=True)
    with pytest.raises(ValueError, match="checkpoint"):
        explain_crash(s, lane, replay=True, rt=rt, ckpts=CheckpointLog())
    ck = port["log"].nearest(lane)
    with pytest.raises(ReplayDivergence, match="fingerprint"):
        replay_window(rt, ck, max_steps=MAX_STEPS, chunk=REPLAY_CHUNK,
                      expect=dict(fingerprint=-1))
    rep = full_chain_replay(
        rt, seed=int(SEEDS[lane]), chunk=REPLAY_CHUNK,
        expect=dict(fingerprint=int(rt.fingerprints(s)[lane]),
                    crashed=True, crash_code=int(s.crash_code[lane])),
        trace_cap=int(s.steps[lane]) + 1)
    assert not rep["explain"]["truncated"]
    assert rep["explain"]["replayed_from_step"] == 0
