"""The port's windowed series plane (`sr_*`), its readers and the recovery
oracle against the JAX package (tolerance: zero), on the CPU.

Covers every leaf through `run` and `run_fused` on the JAX package's
series pingpong (tests/test_series.py `_pingpong_rt`: 8 windows of 50
ms, latency_hist=24, `clog_node(0)` / `unclog_node(0)`) with partial
`series_lanes`; transparency (the plane changes no other leaf and no
fingerprint); a window_len retuned between two runs; counters at int32
max; the digests and reports (`series_counters`, `series_brief`,
`lane_burst`, `series_summary`, `format_series`, `lane_series`, the
series counter tracks); `recovery_invariant` on pingpong under the two
recipes of bench.py `_make_recovery_runtime` (a clog healed by an
unclog, a `set_latency` never healed) and the heal judged at the healed
queue high-water (no lane crashes): the same CRASH_RECOVERY lanes at
the same step; and a `fuzz` campaign with the burst energy. The JAX side
runs on the non-partitionable threefry stream (see _torch_parity).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import madsim_tpu as J
from _torch_parity import (assert_same, equal_results, jax_leaves,  # noqa
                           one_cpu_thread, reference_stream)
from madsim_tpu.models import pingpong as jpp
from madsim_tpu_torch import interop
from madsim_tpu_torch.core.state import TRACE_FIELDS
from madsim_tpu_torch.core.types import SRF_HEAL, SRF_PARTITION
from madsim_tpu_torch.models import pingpong as tpp

pytestmark = pytest.mark.usefixtures("one_cpu_thread")

I32_MAX = 2**31 - 1
SEEDS = np.arange(6, dtype=np.uint32)
SERIES_LANES = np.array([True, True, False, True, True, False])
SR_LEAVES = ("sr_dispatch", "sr_busy", "sr_drop", "sr_dup", "sr_complete",
             "sr_slo_miss", "sr_lat")


def _pingpong(mod, pp, windows=8, lat=24, trace_cap=16, target=200,
              invariant=None):
    """tests/test_series.py `_pingpong_rt` with three nodes, the ring and
    an SLO target, under a clog of node 0 and its heal."""
    cfg = mod.SimConfig(
        n_nodes=3, time_limit=mod.sec(5), series_windows=windows,
        window_len=mod.ms(50), latency_hist=lat, trace_cap=trace_cap,
        complete_kinds=((mod.EV_MSG, 1),) if lat else (),
        slo_target=mod.ms(3) if lat else 0,
        net=mod.NetConfig(send_latency_min=mod.ms(1),
                          send_latency_max=mod.ms(4)))
    sc = mod.Scenario()
    sc.at(mod.ms(60)).clog_node(0)
    sc.at(mod.ms(130)).unclog_node(0)
    kw = {} if mod is J else dict(device="cpu")
    return mod.Runtime(cfg, [pp.PingPong(3, target=target)], pp.state_spec(),
                       scenario=sc, invariant=invariant, **kw)


def _readers(stats, obs, state) -> dict:
    summary = obs.series_summary(state)
    return dict(counters=stats.series_counters(state),
                brief=stats.series_brief(state),
                burst=stats.lane_burst(state),
                summary=summary, text=obs.format_series(summary),
                lane0=obs.lane_series(state, 0),
                lane2=obs.lane_series(state, 2),
                tracks=obs.counter_track_events(state, 1),
                series_tracks=obs.series_counter_track_events(
                    state, 3, node_names=["a", "b", "c"]),
                faults=obs.fault_names(0x7F))


@pytest.fixture(scope="module")
def series():
    from madsim_tpu import obs as jobs
    from madsim_tpu.parallel import stats as jstats
    from madsim_tpu_torch import obs as tobs
    from madsim_tpu_torch.parallel import stats as tstats
    with reference_stream():
        jrt = _pingpong(J, jpp)
        init = jrt.init_batch(SEEDS, series_lanes=SERIES_LANES)
        s, _ = jrt.run(init, 192, 64)
        ref = jax_leaves(s)
        ref_readers = _readers(jstats, jobs, s)
        f = jrt.run_fused(jrt.init_batch(SEEDS, series_lanes=SERIES_LANES),
                          192, 64)
        ref_fused = jax_leaves(f)
        # window_len retuned between two runs, then counters near int32
        # max (the same compiled step: no new trace)
        r = jrt.set_window_len(s, J.ms(20))
        r, _ = jrt.run(r, 64, 64)
        ref_retuned = jax_leaves(r)
        sat = r.replace(**{k: jnp.full_like(getattr(r, k), I32_MAX - 1)
                           for k in SR_LEAVES})
        sat, _ = jrt.run(sat, 64, 64)
        ref_sat = jax_leaves(sat)
    import madsim_tpu_torch as P
    rt = _pingpong(P, tpp)
    t, _ = rt.run(rt.init_batch(SEEDS, series_lanes=SERIES_LANES), 192, 64)
    u = rt.run_fused(rt.init_batch(SEEDS, series_lanes=SERIES_LANES), 192,
                     64)
    r = rt.set_window_len(t, P.ms(20))
    r, _ = rt.run(r, 64, 64)
    sat = r.replace(**{k: torch.full_like(getattr(r, k), I32_MAX - 1)
                       for k in SR_LEAVES})
    sat, _ = rt.run(sat, 64, 64)
    return dict(ref=ref, ref_fused=ref_fused, ref_readers=ref_readers,
                ref_retuned=ref_retuned, ref_sat=ref_sat, rt=rt, state=t,
                port=interop.state_to_numpy(t),
                port_fused=interop.state_to_numpy(u),
                readers=_readers(tstats, tobs, t),
                retuned=interop.state_to_numpy(r),
                sat=interop.state_to_numpy(sat))


def test_series_plane_matches_reference_leaf_for_leaf(series):
    assert_same(series["ref"], series["port"], what="series run")
    assert_same(series["ref_fused"], series["port_fused"],
                what="series run_fused")
    port = series["port"]
    # the plane recorded on the series lanes only, the clog and its heal
    # marked
    disp = port[".sr_dispatch"].sum((1, 2))
    assert (disp[SERIES_LANES] > 0).all() and (disp[~SERIES_LANES] == 0).all()
    faults = np.bitwise_or.reduce(port[".sr_fault"], axis=(0, 1))
    assert faults & SRF_PARTITION and faults & SRF_HEAL
    assert port[".sr_lat"].sum() > 0 and port[".sr_slo_miss"].sum() > 0


def test_series_plane_changes_no_other_leaf_and_no_fingerprint(series):
    import madsim_tpu_torch as P
    off = _pingpong(P, tpp, windows=0)
    t, _ = off.run(off.init_batch(SEEDS), 192, 64)
    plain = interop.state_to_numpy(t)
    keys = [k for k in plain if k[1:].split("[")[0] not in TRACE_FIELDS]
    assert_same(plain, series["port"], keys=keys, what="series off/on")
    np.testing.assert_array_equal(off.fingerprints(t),
                                  series["rt"].fingerprints(series["state"]))


def test_window_len_retuned_mid_run_and_saturation(series):
    """A set_window_len between two runs re-buckets the later dispatches
    as the JAX package does; counters near int32 max saturate as its
    do."""
    assert_same(series["ref_retuned"], series["retuned"],
                what="window_len retuned")
    assert (series["retuned"][".window_len"] == J.ms(20)).all()
    assert_same(series["ref_sat"], series["sat"], what="saturated series")
    assert (series["sat"][".sr_dispatch"] == I32_MAX).any()
    with pytest.raises(ValueError, match=">= 1 tick"):
        series["rt"].set_window_len(series["state"], 0)
    import madsim_tpu_torch as P
    with pytest.raises(ValueError, match="series_windows > 0"):
        _pingpong(P, tpp, windows=0).set_window_len(series["state"], 5)


@pytest.mark.parametrize("what", [
    "counters", "brief", "burst", "summary", "text", "lane0", "lane2",
    "tracks", "series_tracks", "faults"])
def test_series_readers_match_reference(series, what):
    equal_results(series["ref_readers"][what], series["readers"][what], what)


def test_series_lanes_are_validated():
    import madsim_tpu_torch as P
    rt = _pingpong(P, tpp, windows=0, lat=0, trace_cap=0)
    with pytest.raises(ValueError, match="series_lanes given"):
        rt.init_batch([1, 2], series_lanes=[0])
    with pytest.raises(ValueError, match="span_lanes given"):
        rt.init_batch([1, 2], span_lanes=[0])


# --------------------------------------------------------------------------
# recovery_invariant: bench.py `_make_recovery_runtime`'s two recipes,
# restated on pingpong at a fifth of their time scale (windows of 125 ms,
# the fault in window 1)
# --------------------------------------------------------------------------
RECOVERY_SEEDS = np.arange(4, dtype=np.uint32)


def _recovery_rt(mod, pp, recovery, fault, **inv):
    sc = mod.Scenario()
    if fault == "heal":
        sc.at(mod.ms(240)).clog_node(0)
        sc.at(mod.ms(520)).unclog_node(0)
    else:
        sc.at(mod.ms(240)).set_latency(mod.ms(30), mod.ms(60))
    cfg = mod.SimConfig(
        n_nodes=2, time_limit=mod.sec(2), latency_hist=24,
        series_windows=8, window_len=mod.ms(125),
        complete_kinds=((mod.EV_MSG, 1),),
        net=mod.NetConfig(send_latency_min=mod.ms(1),
                          send_latency_max=mod.ms(4)))
    kw = {} if mod is J else dict(device="cpu")
    return mod.Runtime(cfg, [pp.PingPong(2, target=1200)], pp.state_spec(),
                       scenario=sc, invariant=recovery(**inv), **kw)


# (fault, the invariant's arguments, whether a lane crashes): "healed" is
# the heal judged at the queue high-water the healed windows reach (3, 4,
# 4), so the oracle stays quiet on every lane
RECIPES = {"heal": ("heal", dict(qhw_le=3, within=2), True),
           "noheal": ("noheal", dict(p99_le=J.ms(400), within=2,
                                     min_count=2), True),
           "healed": ("heal", dict(qhw_le=4, within=2), False)}


@pytest.mark.parametrize("recipe", sorted(RECIPES))
def test_recovery_invariant_crashes_the_same_lanes_at_the_same_step(recipe):
    from madsim_tpu.harness.recovery import recovery_invariant as jrec
    from madsim_tpu_torch.core.types import CRASH_RECOVERY
    from madsim_tpu_torch.harness.recovery import recovery_invariant
    fault, inv, crashes = RECIPES[recipe]
    with reference_stream():
        jrt = _recovery_rt(J, jpp, jrec, fault, **inv)
        s, _ = jrt.run(jrt.init_batch(RECOVERY_SEEDS), 256, 128)
        ref = jax_leaves(s)
    import madsim_tpu_torch as P
    rt = _recovery_rt(P, tpp, recovery_invariant, fault, **inv)
    t, _ = rt.run(rt.init_batch(RECOVERY_SEEDS), 256, 128)
    got = interop.state_to_numpy(t)
    assert_same(ref, got, what=f"recovery {recipe}")
    assert (got[".crash_code"] == CRASH_RECOVERY).any() == crashes
    # the healed windows were judged: every lane's clock is past window 4
    assert (got[".now"] >= 5 * J.ms(125)).all()


def test_recovery_invariant_checks_its_arguments_and_plane():
    import madsim_tpu_torch as P
    from madsim_tpu_torch.harness.recovery import recovery_invariant
    with pytest.raises(ValueError, match="p99_le= or qhw_le="):
        recovery_invariant()
    with pytest.raises(ValueError, match="grace"):
        recovery_invariant(qhw_le=1, within=0)
    rt = _pingpong(P, tpp, windows=0, lat=0, trace_cap=0,
                   invariant=recovery_invariant(qhw_le=1))
    with pytest.raises(ValueError, match="series_windows"):
        rt.run(rt.init_batch([1, 2]), 8, 8)
    rt = _pingpong(P, tpp, lat=0, trace_cap=0,
                   invariant=recovery_invariant(p99_le=1))
    with pytest.raises(ValueError, match="latency plane"):
        rt.run(rt.init_batch([1, 2]), 8, 8)


# --------------------------------------------------------------------------
# fuzz with the burst energy
# --------------------------------------------------------------------------
FUZZ = dict(max_steps=96, batch=8, max_rounds=3, chunk=48,
            burst_bonus=0.5, rng_seed=9)


def test_fuzz_with_burst_bonus_builds_the_reference_corpus():
    import madsim_tpu_torch as P
    from madsim_tpu.search import Corpus as JCorpus
    from madsim_tpu.search import KnobPlan as JPlan
    from madsim_tpu.search import fuzz as jfuzz
    from madsim_tpu_torch.search import Corpus as TCorpus
    from madsim_tpu_torch.search import KnobPlan as TPlan
    from madsim_tpu_torch.search import fuzz as tfuzz
    with reference_stream():
        jrt = _pingpong(J, jpp, trace_cap=0)
        jc = JCorpus(JPlan.from_runtime(jrt),
                     rng=np.random.default_rng(FUZZ["rng_seed"]))
        ref = jfuzz(jrt, corpus=jc, **FUZZ)
    rt = _pingpong(P, tpp, trace_cap=0)
    tc = TCorpus(TPlan.from_runtime(rt),
                 rng=np.random.default_rng(FUZZ["rng_seed"]))
    got = tfuzz(rt, corpus=tc, **FUZZ)
    assert tc.burst_bonus == FUZZ["burst_bonus"]
    equal_results(ref, got, "fuzz")
    assert len(jc.entries) == len(tc.entries) > 0
    for a, b in zip(jc.entries, tc.entries):
        equal_results(a, b, "corpus entry")
    energies = {round(float(e["energy"]), 9) for e in tc.entries}
    assert len(energies) > 1
