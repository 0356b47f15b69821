"""The port's flight recorder, causal lineage and fused runner against the
JAX package (tolerance: zero), on the CPU.

Covers the traced flagship leaf for leaf (ring, `ev_prov` and `lamport`
included) with a sampled subset of lanes; the ring readers of
`obs/rings.py`; `init_batch(trace_lanes=...)`; `inject` with the ring on;
`run_fused == run`; and a step that leaves its input state as it was.
The golden workloads, whose digests cover the ring too, are in
tests/test_torch_fs.py. The JAX side runs on the non-partitionable
threefry stream (see _torch_parity).
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from _torch_parity import assert_same, jax_leaves, reference_stream
from madsim_tpu_torch import interop, workloads


# --------------------------------------------------------------------------
# The traced flagship at B=8 over 512 steps, lanes 1, 4 and 6 sampled
# --------------------------------------------------------------------------
FLAG_B = 8
TRACE_LANES = np.array([1, 4, 6])


@pytest.fixture(scope="module")
def traced_flagship():
    import bench
    seeds = np.arange(FLAG_B, dtype=np.uint32)
    with reference_stream():
        jrt = bench._make_runtime().derived(trace_cap=64)
        s = jrt.init_batch(seeds, trace_lanes=TRACE_LANES)
        s, _ = jrt.run(s, 256, chunk=256)
        mid = jax_leaves(s)
        s, _ = jrt.run(s, 256, chunk=256)
        ref = jax_leaves(s)
        from madsim_tpu.obs import rings as jrings
        ref_rings = {lane: jrings.ring_records(s, lane)
                     for lane in TRACE_LANES}
        ref_sampled = jrings.sampled_lanes(s)
    rt = workloads.flagship_runtime(device="cpu", trace_cap=64)
    t = rt.init_batch(seeds, trace_lanes=TRACE_LANES)
    t, _ = rt.run(t, 256, chunk=256)
    port_mid = interop.state_to_numpy(t)
    t, _ = rt.run(t, 256, chunk=256)
    return dict(ref=ref, mid=mid, port=interop.state_to_numpy(t),
                port_mid=port_mid, state=t, rt=rt, ref_rings=ref_rings,
                ref_sampled=ref_sampled)


def test_traced_flagship_matches_reference_leaf_for_leaf(traced_flagship):
    f = traced_flagship
    assert_same(f["mid"], f["port_mid"], what="traced flagship, 256 steps")
    assert_same(f["ref"], f["port"], what="traced flagship, 512 steps")
    port = f["port"]
    # the recorder really ran: sampled lanes wrapped their 64-row rings,
    # lineage advanced, and unsampled lanes recorded nothing
    assert (port[".trace_pos"][TRACE_LANES] > 64).all()
    assert (np.delete(port[".trace_pos"], TRACE_LANES) == 0).all()
    assert (port[".lamport"] > 0).any() and (port[".ev_prov"][..., 0]
                                             >= 0).any()
    assert not port[".crashed"].any() and not port[".oops"].any()


def test_recorder_changes_no_other_leaf(traced_flagship):
    """256 steps of the untraced flagship end with the traced run's
    non-trace leaves and fingerprints."""
    from madsim_tpu_torch.core.state import TRACE_FIELDS
    rt = workloads.flagship_runtime(device="cpu")
    t, _ = rt.run(rt.init_batch(np.arange(FLAG_B, dtype=np.uint32)), 256,
                  chunk=256)
    plain = interop.state_to_numpy(t)
    keys = [k for k in plain if k[1:].split("[")[0] not in TRACE_FIELDS]
    traced = traced_flagship["port_mid"]
    assert_same(plain, traced, keys=keys, what="untraced vs traced flagship")
    traced_state = interop.state_from_numpy(traced, "cpu")
    np.testing.assert_array_equal(rt.fingerprints(t),
                                  rt.fingerprints(traced_state))


def test_ring_readers_match_reference(traced_flagship):
    from madsim_tpu_torch.obs.rings import ring_records, sampled_lanes
    f = traced_flagship
    np.testing.assert_array_equal(sampled_lanes(f["state"]),
                                  f["ref_sampled"])
    for lane, want in f["ref_rings"].items():
        got = ring_records(f["state"], lane)
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], np.asarray(want[k]),
                                          err_msg=f"lane {lane} {k}")
        assert got["dropped"] > 0 and (np.diff(got["step"]) > 0).all()
    with pytest.raises(ValueError, match="not sampled"):
        ring_records(f["state"], 0)


def _whole_batch_ring_records(state, lane):
    """The reader as it was: every lane's columns copied to the host, the
    lane selected there."""
    from madsim_tpu_torch.obs.rings import _COLS
    cols = {k: getattr(state, f"tr_{k}").cpu().numpy()[lane] for k in _COLS
            if getattr(state, f"tr_{k}").shape[-1] > 0}
    total = int(state.trace_pos.cpu().numpy()[lane])
    cap = int(state.trace_cap.cpu().numpy().reshape(-1)[0])
    n = min(total, cap)
    order = ((total % cap if total > cap else 0) + np.arange(n)) % cap
    out = {k: v[order] for k, v in cols.items()}
    out.update(total=total, dropped=total - n)
    return out


def test_ring_records_copy_one_lane(traced_flagship, monkeypatch):
    """A lane's records are those the whole-batch reader gave, and the
    reader copies that lane's bytes alone to the host."""
    from madsim_tpu_torch.obs import rings
    state = traced_flagship["state"]
    copied = []
    host = rings._host

    def counting_host(t):
        copied.append(int(t.numel()) * t.element_size()
                      if isinstance(t, torch.Tensor) else np.asarray(t).nbytes)
        return host(t)

    monkeypatch.setattr(rings, "_host", counting_host)
    lane_bytes = sum(getattr(state, f).element_size()
                     * getattr(state, f)[0].numel()
                     for f in dir(state) if f.startswith("tr_")
                     and getattr(state, f).ndim == 2)
    for lane in TRACE_LANES:
        copied.clear()
        got = rings.ring_records(state, int(lane))
        want = _whole_batch_ring_records(state, int(lane))
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k],
                                          err_msg=f"lane {lane} {k}")
        # the ring columns of one lane plus its three scalars
        assert sum(copied) <= lane_bytes + 64, (sum(copied), lane_bytes)


def test_ring_readers_refuse_a_compiled_out_ring():
    from madsim_tpu_torch.obs.rings import ring_records
    rt = workloads.pingpong_runtime(device="cpu")
    with pytest.raises(ValueError, match="compiled out"):
        ring_records(rt.init_batch([1]), 0)


def test_trace_lanes_are_validated():
    with pytest.raises(ValueError, match="trace_cap == 0"):
        workloads.pingpong_runtime(device="cpu").init_batch(
            [1, 2], trace_lanes=[0])
    rt = workloads.build_pingpong(device="cpu")
    with pytest.raises(ValueError, match="mask shape"):
        rt.init_batch([1, 2], trace_lanes=np.array([True]))
    s = rt.init_batch([1, 2, 3], trace_lanes=np.array([False, True, True]))
    assert s.trace_on.tolist() == [False, True, True]


# --------------------------------------------------------------------------
# inject with the ring on, run_fused on the CPU, the step's purity
# --------------------------------------------------------------------------
def test_inject_with_ring_matches_reference():
    """Host-injected ops between chunks with a ring that wraps (trace_cap
    8): the injected rows carry the external provenance (-1, 0)."""
    import madsim_tpu as J
    from madsim_tpu.models.pingpong import PingPong, state_spec
    import madsim_tpu_torch as P
    from madsim_tpu_torch.models import pingpong as tpp
    seeds = np.arange(16, dtype=np.uint32)
    ops = [("kill", (1,)), ("clog_link", (0, 2)), ("restart", (1,)),
           ("heal", ())]
    with reference_stream():
        jrt = J.Runtime(J.SimConfig(n_nodes=4, time_limit=J.sec(5),
                                    trace_cap=8),
                        [PingPong(4, target=1000)], state_spec())
        s = jrt.init_batch(seeds)
        ref = []
        for name, args in ops:
            s, _ = jrt.run(s, 10, chunk=10)
            s = getattr(jrt, name)(s, *args)
            ref.append(jax_leaves(s))
    trt = P.Runtime(P.SimConfig(n_nodes=4, time_limit=P.sec(5),
                                trace_cap=8),
                    [tpp.PingPong(4, target=1000)], tpp.state_spec(),
                    device="cpu")
    t = trt.init_batch(seeds)
    for (name, args), want in zip(ops, ref):
        t, _ = trt.run(t, 10, chunk=10)
        t = getattr(trt, name)(t, *args)
        assert_same(want, interop.state_to_numpy(t), what=f"after {name}")
    assert (t.ev_prov[..., 0] == -1).any()
    assert (t.trace_pos > 8).all()


def test_run_fused_equals_run_on_the_cpu():
    """On the CPU run_fused is `run` itself: the traced flagship's
    unhalted lanes over 3 chunks of 16 give equal states and steps_run
    through both entry points (the CUDA-graph runner is held to `run` by
    chip_smoke.py's golden and fused phases)."""
    rt = workloads.flagship_runtime(device="cpu", trace_cap=16)
    seeds = np.arange(4, dtype=np.uint32)
    a, _ = rt.run(rt.init_batch(seeds), 40, chunk=16)
    b = rt.run_fused(rt.init_batch(seeds), 40, chunk=16)
    assert rt.steps_run == 48
    assert_same(interop.state_to_numpy(a), interop.state_to_numpy(b),
                what="flagship run vs run_fused")


def test_run_fused_refuses_checkpoints():
    """run_fused harvests checkpoints (tests/test_torch_timetravel.py holds
    them to the reference) and refuses a step count that is no positive
    number, as the reference does."""
    rt = workloads.build_pingpong(device="cpu")
    with pytest.raises(ValueError, match="positive"):
        rt.run_fused(rt.init_batch([1]), 8, chunk=8, ckpt_every=0)
    out = rt.run_fused(rt.init_batch([1]), 16, chunk=8, ckpt_every=4)
    log = rt.last_ckpt_log
    assert [s["steps_done"] for s in log.snaps] == [0, 8]
    assert_same(interop.state_to_numpy(rt.run(rt.init_batch([1]), 16,
                                              chunk=8)[0]),
                interop.state_to_numpy(out), what="with checkpoints")


@pytest.mark.parametrize("name", ["flagship", "wal_kv"])
def test_step_leaves_its_input_state_unchanged(name):
    """The step leaves every leaf of its input unchanged but those it
    writes in place. The event table and ring columns the emission write
    fills are the result's very tensors, changed only in the rows the
    result holds occupied (the rows emissions took) and in at most one
    ring row a lane. The dup pop's t_kind and t_deadline, the scatter's
    node-state leaves and the recorder's lamport change in at most one
    row a lane (the popped row, the acting node's)."""
    from madsim_tpu_torch.ops.emit_write import RING_COLS, TABLE_COLS
    if name == "flagship":
        rt = workloads.flagship_runtime(device="cpu", trace_cap=64)
    else:
        rt = workloads.build_wal_kv(device="cpu")
    s = rt.init_batch(np.arange(4, dtype=np.uint32))
    s, _ = rt.run(s, 24, chunk=24)
    before = {k: v.clone() for k, v in interop.state_leaves(s).items()}
    out, _ = rt._step(s)
    after, result = interop.state_leaves(s), interop.state_leaves(out)
    in_place = {"." + k for k in TABLE_COLS[2:] + RING_COLS}
    row_writes = {".t_kind", ".t_deadline", ".lamport"} | {
        k for k in before if k.startswith(".node_state")}
    for k, v in before.items():
        if k in in_place and v.numel():
            assert after[k] is result[k], k
        elif k in row_writes and v.numel():
            rows = (after[k] != v).reshape(v.shape[0], v.shape[1], -1)
            assert (rows.any(-1).sum(1) <= 1).all(), \
                f"the step wrote more than one row of input leaf {k}"
        else:
            assert torch.equal(after[k], v), f"the step wrote input leaf {k}"
    occupied = out.t_kind != 0
    written = torch.zeros_like(occupied)
    for k in ("." + c for c in TABLE_COLS[2:]):
        if before[k].numel():
            rows = (after[k] != before[k]).reshape(*occupied.shape, -1)
            assert not (rows.any(-1) & ~occupied).any(), k
            written |= rows.any(-1)
    for k in ("." + c for c in RING_COLS):
        assert ((after[k] != before[k]).sum(1) <= 1).all(), k
    moved = [k for k, v in result.items() if not torch.equal(v, before[k])]
    assert ".now" in moved and ".t_kind" in moved and written.any()


def test_new_modules_pull_in_no_jax_and_no_reference_package():
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = ("import sys, madsim_tpu_torch.fs, madsim_tpu_torch.obs.rings, "
            "madsim_tpu_torch.models.wal_kv, madsim_tpu_torch.ops.emit_write, "
            "madsim_tpu_torch.runtime.runtime\n"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith("
            "('jax.', 'jaxlib', 'madsim_tpu.')) or m == 'madsim_tpu']\n"
            "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=repo,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
