"""The port's observation readers against the JAX package (tolerance: zero),
on the CPU: the causal layer (`obs/causal.py`: `walk_lineage`,
`happens_before`, `explain_crash`, the crash fingerprints and their
matching), the Chrome-trace export (`obs/trace.py`), the profiler's
reports and counter tracks (`obs/profiler.py`) and the ring reader's
plane columns (`obs/rings.py` `qlen`, `lat`).

The causal layer runs on the crash-rich wal_kv (bench.py
`_make_crashrich_runtime("wal_kv")`) with a ring of 8, which wraps, so
truncated chains are covered; the trace export of the golden pingpong
must be byte-identical to the frozen tests/data/golden_r22_trace.json
(the JAX package's own run of that test fails on its PRNG default,
ROADMAP F1); the profile trace must be the JAX package's bytes. The JAX
side runs on the non-partitionable threefry stream (see _torch_parity).
"""

import json
import os

import numpy as np
import pytest

import madsim_tpu as J
from _torch_parity import one_cpu_thread, reference_stream  # noqa: F401
from madsim_tpu import obs as jobs
from madsim_tpu.models import pingpong as jpp
from madsim_tpu_torch import obs as tobs
from madsim_tpu_torch import workloads
from madsim_tpu_torch.models import pingpong as tpp

pytestmark = pytest.mark.usefixtures("one_cpu_thread")

CRASH_SEEDS = np.arange(16, dtype=np.uint32)


def _equal(a, b, where=""):
    if isinstance(a, dict):
        assert isinstance(b, dict) and sorted(a) == sorted(b), where
        for k in a:
            _equal(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _equal(x, y, f"{where}[{i}]")
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=where)
    else:
        assert type(a) is type(b) and a == b, (where, a, b)


# --------------------------------------------------------------------------
# The causal layer on the crash-rich wal_kv, ring of 8
# --------------------------------------------------------------------------
def _causal_outputs(causal, rings, state) -> dict:
    out = dict(explain={}, fp={}, edges={}, walks={})
    for lane in range(len(CRASH_SEEDS)):
        recs = rings.ring_records(state, lane)
        exp = causal.explain_crash(state, lane)
        out["explain"][lane] = exp
        out["edges"][lane] = causal.happens_before(recs)
        steps = np.asarray(recs["step"])
        out["walks"][lane] = causal.walk_lineage(recs, int(steps[len(steps)
                                                                 // 2]))
        for depth in (1, 3, 8):
            out["fp"][f"{lane}:{depth}"] = causal.causal_fingerprint(
                exp, depth)
        out["fp"][f"{lane}:code"] = causal.code_fingerprint(
            exp["crash_code"], exp["crash_node"])
    fps = [out["fp"][f"{lane}:8"] for lane in range(len(CRASH_SEEDS))]
    out["match"] = [[causal.fingerprints_match(a, b) for b in fps]
                    for a in fps]
    short = [out["fp"][f"{lane}:3"] for lane in range(len(CRASH_SEEDS))]
    out["match_short"] = [[causal.fingerprints_match(a, b) for b in fps]
                          for a in short]
    return out


@pytest.fixture(scope="module")
def causal():
    import bench
    from madsim_tpu.obs import causal as jcausal
    from madsim_tpu.obs import rings as jrings
    from madsim_tpu_torch.obs import causal as tcausal
    from madsim_tpu_torch.obs import rings as trings
    with reference_stream():
        jrt = bench._make_crashrich_runtime("wal_kv", trace_cap=8)
        s, _ = jrt.run(jrt.init_batch(CRASH_SEEDS), 128, 128)
        ref = _causal_outputs(jcausal, jrings, s)
    rt = workloads.crashrich_wal_kv_runtime(device="cpu", trace_cap=8)
    t, _ = rt.run(rt.init_batch(CRASH_SEEDS), 128, 128)
    return dict(ref=ref, port=_causal_outputs(tcausal, trings, t), state=t)


@pytest.mark.parametrize("what", ["explain", "edges", "walks", "fp",
                                  "match", "match_short"])
def test_causal_layer_matches_reference(causal, what):
    _equal(causal["ref"][what], causal["port"][what], what)


def test_causal_layer_sees_crashes_and_wrap(causal):
    exp = causal["port"]["explain"]
    assert sum(e["crashed"] for e in exp.values()) >= 8
    assert any(e["truncated"] for e in exp.values())
    assert any(m for row in causal["port"]["match_short"] for m in row)


def test_replay_and_an_absent_sketch_behave_as_the_reference(causal):
    from madsim_tpu_torch.obs import causal as tcausal
    # replay needs the runtime (and its checkpoints), as the reference's
    with pytest.raises(ValueError, match="rt="):
        tcausal.explain_crash(causal["state"], 0, replay=True)
    with pytest.raises(ValueError, match="compiled out"):
        tcausal.sketch_divergence(causal["state"], 0, 1)
    recs = {"step": np.array([], np.int32)}
    with pytest.raises(ValueError, match="no lineage"):
        tcausal.walk_lineage(recs)


# --------------------------------------------------------------------------
# The Chrome-trace export of the golden pingpong, against the frozen bytes
# --------------------------------------------------------------------------
def test_chrome_trace_of_the_golden_pingpong_is_the_frozen_document(
        tmp_path):
    """Lane 0 of the golden pingpong (seed 0: a lane's trajectory does not
    depend on the batch around it) runs to its halt and exports the frozen
    document byte for byte."""
    rt = workloads.build_pingpong(device="cpu")
    st, _ = rt.run(rt.init_batch([0]), 4000, 32)
    assert bool(st.halted.all())
    p = str(tmp_path / "pp.json")
    n = tobs.export_chrome_trace(p, state=st, lane=0)
    gold = os.path.join(os.path.dirname(__file__), "data",
                        "golden_r22_trace.json")
    with open(p, "rb") as a, open(gold, "rb") as g:
        assert a.read() == g.read()
    with open(p) as f:
        doc = json.load(f)
    assert n == sum(1 for e in doc["traceEvents"] if e["ph"] == "i") > 0


def test_chrome_trace_of_an_event_stream_matches_reference(tmp_path):
    with reference_stream():
        jrt = J.Runtime(J.SimConfig(n_nodes=3, time_limit=J.sec(2)),
                        [jpp.PingPong(3, target=8)], jpp.state_spec())
        _, ev = jrt.run_single(4, 256, 64)
        jobs.export_chrome_trace(str(tmp_path / "j.json"), events=ev)
    import madsim_tpu_torch as P
    rt = P.Runtime(P.SimConfig(n_nodes=3, time_limit=P.sec(2)),
                   [tpp.PingPong(3, target=8)], tpp.state_spec(),
                   device="cpu")
    _, ev = rt.run_single(4, 256, 64)
    tobs.export_chrome_trace(str(tmp_path / "t.json"), events=ev)
    with open(tmp_path / "j.json", "rb") as a, \
            open(tmp_path / "t.json", "rb") as b:
        assert a.read() == b.read()
    with pytest.raises(ValueError, match="exactly one"):
        tobs.export_chrome_trace(str(tmp_path / "x.json"))


def test_runtime_trace_shim_writes_the_reference_shims_bytes(tmp_path):
    """runtime/trace.export_chrome_trace(events, path, b, node_names), the
    original exporter signature, writes the JAX package's shim's file
    byte for byte from the same recorded event stream (lane 1 of two,
    named nodes) and counts the same dispatches."""
    from madsim_tpu.runtime import trace as jtrace
    from madsim_tpu_torch.runtime import trace as ttrace
    names = ["alpha", "beta", "gamma"]
    with reference_stream():
        jrt = J.Runtime(J.SimConfig(n_nodes=3, time_limit=J.sec(2)),
                        [jpp.PingPong(3, target=8)], jpp.state_spec())
        _, ev = jrt.run(jrt.init_batch(np.arange(2, dtype=np.uint32)), 192,
                        64, collect_events=True)
        nj = jtrace.export_chrome_trace(ev, str(tmp_path / "j.json"), b=1,
                                        node_names=names)
    import madsim_tpu_torch as P
    rt = P.Runtime(P.SimConfig(n_nodes=3, time_limit=P.sec(2)),
                   [tpp.PingPong(3, target=8)], tpp.state_spec(),
                   device="cpu")
    _, ev = rt.run(rt.init_batch(np.arange(2, dtype=np.uint32)), 192, 64,
                   collect_events=True)
    nt = ttrace.export_chrome_trace(ev, str(tmp_path / "t.json"), b=1,
                                    node_names=names)
    with open(tmp_path / "j.json", "rb") as a, \
            open(tmp_path / "t.json", "rb") as b:
        assert a.read() == b.read()
    assert nt == nj > 0


# --------------------------------------------------------------------------
# The profiler's reports, counter tracks and trace, and the ring's plane
# columns, on pingpong with both planes
# --------------------------------------------------------------------------
def _planes_rt(mod, pp):
    cfg = mod.SimConfig(
        n_nodes=3, time_limit=mod.sec(5), profile=True, latency_hist=24,
        trace_cap=32, complete_kinds=((mod.EV_MSG, 1),),
        net=mod.NetConfig(packet_loss_rate=0.1, send_latency_min=mod.ms(1),
                          send_latency_max=mod.ms(4)))
    sc = mod.Scenario()
    sc.at(mod.ms(40)).kill_random()
    sc.at(mod.ms(400)).restart_random()
    kw = {} if mod is J else dict(device="cpu")
    return mod.Runtime(cfg, [pp.PingPong(3, target=30)], pp.state_spec(),
                       scenario=sc, **kw)


def _profiler_outputs(o, rings, state, path) -> dict:
    ps, ls = o.profile_summary(state), o.latency_summary(state)
    out = dict(profile=ps, latency=ls, format_profile=o.format_profile(ps),
               format_latency=o.format_latency(ls),
               format_latency_named=o.format_latency(
                   ls, node_names=["a", "b", "c"]),
               rows=o.latency_histogram_rows(state),
               attribution=o.attribution_summary(state),
               format_attribution=o.format_attribution(None),
               curve=o.curve_brief([[0, 1.0], [1, 3.5], [2, 2.25]]),
               tracks=o.counter_track_events(state, lane=2),
               rings={lane: rings.ring_records(state, lane)
                      for lane in (0, 5)})
    out["count"] = o.export_profile_trace(path, state, lane=1)
    with open(path, "rb") as f:
        out["trace_bytes"] = f.read()
    return out


@pytest.fixture(scope="module")
def profiler(tmp_path_factory):
    from madsim_tpu.obs import rings as jrings
    from madsim_tpu_torch.obs import rings as trings
    d = tmp_path_factory.mktemp("prof")
    seeds = np.arange(6, dtype=np.uint32)
    with reference_stream():
        jrt = _planes_rt(J, jpp)
        s, _ = jrt.run(jrt.init_batch(seeds), 192, 64)
        ref = _profiler_outputs(jobs, jrings, s, str(d / "j.json"))
    import madsim_tpu_torch as P
    rt = _planes_rt(P, tpp)
    t, _ = rt.run(rt.init_batch(seeds), 192, 64)
    return dict(ref=ref, port=_profiler_outputs(tobs, trings, t,
                                                str(d / "t.json")))


@pytest.mark.parametrize("what", [
    "profile", "latency", "format_profile", "format_latency",
    "format_latency_named", "rows", "attribution", "format_attribution",
    "curve", "tracks", "rings", "count", "trace_bytes"])
def test_profiler_outputs_match_reference(profiler, what):
    _equal(profiler["ref"][what], profiler["port"][what], what)


def test_profiler_outputs_are_not_empty(profiler):
    port = profiler["port"]
    assert port["profile"]["dispatches"] > 0
    assert port["latency"]["completions"] > 0
    names = {e["name"].split(":")[0] for e in port["tracks"]}
    assert {"queue_depth", "busy_pct", "e2e_p99"} <= names
    recs = port["rings"][0]
    assert "qlen" in recs and "lat" in recs and (recs["lat"] >= 0).any()


def test_reports_of_compiled_out_planes_and_unported_branches():
    """The reports of planes compiled out read None; a state carrying the
    series or the span plane (once refused here, before those planes were
    ported) gets the JAX package's series tracks and attribution report."""
    from _torch_parity import jax_state_like
    from madsim_tpu.obs import profiler as jprofiler
    from madsim_tpu_torch import interop
    from madsim_tpu_torch.obs import profiler
    rt = workloads.pingpong_runtime(device="cpu", trace_cap=8)
    s, _ = rt.run(rt.init_batch([1, 2]), 32, 32)
    assert profiler.profile_summary(s) is None
    assert profiler.latency_summary(s) is None
    assert profiler.attribution_summary(s) is None
    assert profiler.format_profile(None).startswith("profiler compiled out")
    assert not [e for e in profiler.counter_track_events(s, 0)
                if e["name"].startswith(("queue_depth", "e2e_p99"))]
    fault = s.sr_fault.new_zeros((2, 4))
    fault[:, 1] = 4
    series = s.replace(sr_qhw=s.sr_qhw.new_full((2, 4), 3),
                       sr_dispatch=s.sr_dispatch.new_ones((2, 4, 3)),
                       sr_busy=s.sr_busy.new_full((2, 4, 3), 7),
                       sr_drop=s.sr_drop.new_zeros((2, 4)),
                       sr_dup=s.sr_dup.new_zeros((2, 4)),
                       sr_complete=s.sr_complete.new_zeros((2, 4)),
                       sr_slo_miss=s.sr_slo_miss.new_zeros((2, 4)),
                       sr_fault=fault,
                       sr_on=s.sr_on.new_ones((2,)))
    spans = s.replace(sa_tail=s.sa_tail.new_ones((2, 3, 4)),
                      sa_bottleneck=s.sa_bottleneck.new_ones((2, 3)),
                      sp_on=s.sp_on.new_ones((2,)))
    with reference_stream():
        want_tracks = jprofiler.counter_track_events(
            jax_state_like(_jax_zeros(series),
                           interop.state_to_numpy(series)), 0)
        want_att = jprofiler.attribution_summary(
            jax_state_like(_jax_zeros(spans), interop.state_to_numpy(spans)))
    got_tracks = profiler.counter_track_events(series, 0)
    assert {e["name"] for e in got_tracks} >= {"queue_depth", "fault"}
    _equal(want_tracks, got_tracks, "series tracks")
    _equal(want_att, profiler.attribution_summary(spans), "attribution")


def _jax_zeros(state):
    """A JAX SimState of the port state's structure and leaf shapes (a
    template for `jax_state_like`)."""
    import jax.numpy as jnp
    from madsim_tpu.core.state import SimState as JState
    from madsim_tpu_torch.core.state import SimState, tree_map
    return JState(**{f: tree_map(lambda t: jnp.zeros(tuple(t.shape)),
                                 getattr(state, f))
                     for f in SimState.field_names()})
