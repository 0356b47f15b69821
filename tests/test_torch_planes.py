"""The port's sim profiler (`pf_*`) and latency plane (`lh_*`,
`ev_root_t`, the ring's `tr_qlen` / `tr_lat`) against the JAX package
(tolerance: zero), on the CPU.

Covers every leaf through `run` and `run_fused` with partial
`profile_lanes` / `latency_lanes` on pingpong, wal_kv (completions at
its M_ACK replies) and a small Raft flagship with the plane config of
the chip's `planes` phase; transparency (the planes change no other leaf
and no fingerprint); counters at int32 max; `set_slo_target`; an
injected op minting its own root; `slo_invariant`'s CRASH_SLO verdict;
the digests (`profile_counters`, `latency_counters`, `lane_e2e_p99`,
`latency_brief`); the observers' done record; and a `fuzz` campaign with
the tail-latency energy (`lat_bonus`). The JAX side runs on the
non-partitionable threefry stream (see _torch_parity).
"""

import numpy as np
import pytest
import torch

import madsim_tpu as J
from _torch_parity import (assert_same, jax_leaves, one_cpu_thread,  # noqa: F401
                           reference_stream)
from madsim_tpu.models import pingpong as jpp
from madsim_tpu.parallel import stats as jstats
from madsim_tpu_torch import interop, workloads
from madsim_tpu_torch.core.state import TRACE_FIELDS
from madsim_tpu_torch.models import pingpong as tpp
from madsim_tpu_torch.parallel import stats as tstats

pytestmark = pytest.mark.usefixtures("one_cpu_thread")

I32_MAX = 2**31 - 1
TAG_PING = 1
PROFILE_LANES = [0, 2, 3, 5]
LATENCY_LANES = np.array([False, True, True, False, False, True, False,
                          True])


def _pingpong(mod, pp, profile=True, lat=24, trace_cap=16, n=3, target=20,
              invariant=None, loss=0.1, scenario=True):
    cfg = mod.SimConfig(
        n_nodes=n, time_limit=mod.sec(5), profile=profile, latency_hist=lat,
        trace_cap=trace_cap,
        complete_kinds=((mod.EV_MSG, TAG_PING),) if lat else (),
        net=mod.NetConfig(packet_loss_rate=loss, send_latency_min=mod.ms(1),
                          send_latency_max=mod.ms(4)))
    sc = mod.Scenario()
    if scenario:
        sc.at(mod.ms(40)).kill_random()
        sc.at(mod.ms(400)).restart_random()
    kw = {} if mod is J else dict(device="cpu")
    return mod.Runtime(cfg, [pp.PingPong(n, target=target)],
                       pp.state_spec(), scenario=sc, invariant=invariant,
                       **kw)


def _jax_pingpong(**kw):
    return _pingpong(J, jpp, **kw)


def _port_pingpong(**kw):
    import madsim_tpu_torch as P
    return _pingpong(P, tpp, **kw)


def _np(state):
    return interop.state_to_numpy(state)


def _equal_dicts(a, b, where=""):
    """Deep equality of results: dicts, lists, numpy arrays, scalars."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and sorted(a) == sorted(b), where
        for k in a:
            _equal_dicts(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _equal_dicts(x, y, f"{where}[{i}]")
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, where
        np.testing.assert_array_equal(a, b, err_msg=where)
    else:
        assert type(a) is type(b) and a == b, (where, a, b)


def _digests(stats, state) -> dict:
    return dict(profile=stats.profile_counters(state),
                latency=stats.latency_counters(state),
                p99=stats.lane_e2e_p99(state),
                brief=stats.latency_brief(state))


# --------------------------------------------------------------------------
# Pingpong with both planes, lanes masked in part, through both runners
# --------------------------------------------------------------------------
PP_SEEDS = np.arange(8, dtype=np.uint32)


@pytest.fixture(scope="module")
def pingpong():
    out = {}
    with reference_stream():
        jrt = _jax_pingpong()
        init = dict(profile_lanes=PROFILE_LANES,
                    latency_lanes=LATENCY_LANES)
        s, _ = jrt.run(jrt.init_batch(PP_SEEDS, **init), 256, 64)
        out["ref"] = jax_leaves(s)
        out["ref_digests"] = _digests(jstats, s)
        f = jrt.run_fused(jrt.init_batch(PP_SEEDS, **init), 256, 64)
        out["ref_fused"] = jax_leaves(f)
    rt = _port_pingpong()
    init = dict(profile_lanes=PROFILE_LANES, latency_lanes=LATENCY_LANES)
    t, _ = rt.run(rt.init_batch(PP_SEEDS, **init), 256, 64)
    out.update(rt=rt, state=t, port=_np(t),
               port_fused=_np(rt.run_fused(rt.init_batch(PP_SEEDS, **init),
                                           256, 64)))
    return out


def test_pingpong_planes_match_reference_leaf_for_leaf(pingpong):
    assert_same(pingpong["ref"], pingpong["port"], what="pingpong run")
    assert_same(pingpong["ref_fused"], pingpong["port_fused"],
                what="pingpong run_fused")
    port = pingpong["port"]
    # the planes really ran, on the masked lanes only
    on = np.zeros(8, bool)
    on[PROFILE_LANES] = True
    busy = port[".pf_busy"].sum(1)
    assert (busy[on] > 0).all() and (busy[~on] == 0).all()
    e2e = port[".lh_e2e"].sum((1, 2))
    assert (e2e[LATENCY_LANES] > 0).all() and (e2e[~LATENCY_LANES] == 0).all()
    assert (port[".tr_lat"] >= 0).any() and (port[".tr_qlen"] > 0).any()
    assert (port[".ev_root_t"] >= 0).any()


def test_planes_change_no_other_leaf_and_no_fingerprint(pingpong):
    rt = _port_pingpong(profile=False, lat=0)
    t, _ = rt.run(rt.init_batch(PP_SEEDS), 256, 64)
    plain = _np(t)
    keys = [k for k in plain if k[1:].split("[")[0] not in TRACE_FIELDS]
    assert_same(plain, pingpong["port"], keys=keys,
                what="planes off vs on")
    np.testing.assert_array_equal(rt.fingerprints(t),
                                  pingpong["rt"].fingerprints(
                                      pingpong["state"]))


@pytest.mark.parametrize("which", ["profile", "latency", "p99", "brief"])
def test_pingpong_digests_match_reference(pingpong, which):
    got = _digests(tstats, pingpong["state"])[which]
    ref = pingpong["ref_digests"][which]
    if isinstance(ref, dict):
        _equal_dicts(ref, got, which)
    else:
        np.testing.assert_array_equal(ref, got)
    assert got is not None


def test_digests_are_none_with_the_planes_compiled_out():
    rt = _port_pingpong(profile=False, lat=0, trace_cap=0)
    s = rt.init_batch([1, 2])
    assert all(v is None for v in _digests(tstats, s).values())


def test_the_digest_memo_follows_in_place_writes(pingpong, monkeypatch):
    """A digest is confirmed by two agreeing invocations and memoized on
    its leaves' identity and version: read again it is not recomputed,
    and after an in-place write to a leaf it is."""
    calls = []
    digest = tstats.latency_digest

    def counted(state):
        calls.append(1)
        return digest(state)
    counted.__name__ = "latency_digest"
    monkeypatch.setattr(tstats, "latency_digest", counted)
    s = pingpong["rt"].run(pingpong["state"], 64, 64)[0]
    first = tstats.latency_counters(s)
    assert len(calls) == 2 and first["e2e_p99"] > 0
    _equal_dicts(first, tstats.latency_counters(s))
    assert len(calls) == 2
    s.lh_e2e.zero_()                                  # an in-place write
    again = tstats.latency_counters(s)
    assert len(calls) == 4 and again["e2e_p99"] == 0


def test_observer_done_record_carries_the_latency_rollup(pingpong):
    class Rec:
        def __init__(self):
            self.chunks, self.done = [], None

        def on_chunk(self, rec):
            self.chunks.append(rec)

        def on_done(self, rec):
            self.done = rec

    obs = (Rec(), Rec())
    with reference_stream():
        jrt = _jax_pingpong()
        jrt.run(jrt.init_batch(PP_SEEDS), 256, 64, observer=obs[0])
    rt = pingpong["rt"]
    rt.run(rt.init_batch(PP_SEEDS), 256, 64, observer=obs[1])
    timing = ("wall_s", "lane_steps_per_sec")
    for a, b in zip(obs[0].chunks + [obs[0].done],
                    obs[1].chunks + [obs[1].done]):
        assert {k: v for k, v in a.items() if k not in timing} \
            == {k: v for k, v in b.items() if k not in timing}
    assert obs[1].done["lat_p99"] > 0 and "slo_miss" in obs[1].done


def test_lane_masks_are_validated():
    rt = _port_pingpong(profile=False, lat=0, trace_cap=0)
    with pytest.raises(ValueError, match="cfg.profile"):
        rt.init_batch([1, 2], profile_lanes=[0])
    with pytest.raises(ValueError, match="latency_hist == 0"):
        rt.init_batch([1, 2], latency_lanes=[0])
    rt = _port_pingpong()
    with pytest.raises(ValueError, match="mask shape"):
        rt.init_batch([1, 2], latency_lanes=np.array([True]))
    s = rt.init_batch([1, 2, 3], profile_lanes=np.array([False, True, True]))
    assert s.pf_on.tolist() == [False, True, True] and s.lh_on.all()


# --------------------------------------------------------------------------
# wal_kv (completions at the M_ACK replies) and a small Raft flagship
# --------------------------------------------------------------------------
def _wal_kv_planes(mod):
    from madsim_tpu.models.wal_kv import M_ACK
    return dict(profile=True, latency_hist=16, trace_cap=32,
                complete_kinds=((mod.EV_MSG, M_ACK),))


@pytest.fixture(scope="module")
def wal_kv():
    from _grayfail_golden import build_wal_kv as jbuild
    seeds = np.arange(6, dtype=np.uint32)
    with reference_stream():
        jrt = jbuild().derived(**_wal_kv_planes(J))
        s, _ = jrt.run(jrt.init_batch(seeds, latency_lanes=[0, 1, 3, 4]),
                       320, 64)
        ref, ref_digests = jax_leaves(s), _digests(jstats, s)
    import madsim_tpu_torch as P
    rt = workloads.build_wal_kv(device="cpu").derived(**_wal_kv_planes(P))
    t, _ = rt.run(rt.init_batch(seeds, latency_lanes=[0, 1, 3, 4]), 320, 64)
    return dict(ref=ref, ref_digests=ref_digests, port=_np(t), state=t)


def test_wal_kv_planes_match_reference(wal_kv):
    assert_same(wal_kv["ref"], wal_kv["port"], what="wal_kv planes")
    assert wal_kv["port"][".lh_e2e"].sum() > 0
    assert wal_kv["port"][".pf_restart"].sum() > 0     # the boots
    _equal_dicts(wal_kv["ref_digests"], _digests(tstats, wal_kv["state"]),
                 "wal_kv digests")


@pytest.fixture(scope="module")
def raft():
    import bench
    seeds = np.arange(4, dtype=np.uint32)
    planes = workloads.plane_config()
    with reference_stream():
        jrt = bench._make_runtime().derived(trace_cap=64, **planes)
        s, _ = jrt.run(jrt.init_batch(seeds, profile_lanes=[1, 2, 3]), 192,
                       64)
        ref, ref_digests = jax_leaves(s), _digests(jstats, s)
    rt = workloads.plane_flagship_runtime(device="cpu")
    init = rt.init_batch(seeds, profile_lanes=[1, 2, 3])
    t, _ = rt.run(init, 192, 64)
    plain = workloads.flagship_runtime(device="cpu", trace_cap=64)
    p, _ = plain.run(plain.init_batch(seeds), 192, 64)
    return dict(ref=ref, ref_digests=ref_digests, port=_np(t), state=t,
                rt=rt, plain=p, plain_rt=plain)


def test_raft_plane_flagship_matches_reference(raft):
    assert_same(raft["ref"], raft["port"], what="Raft with both planes")
    port = raft["port"]
    assert port[".lh_e2e"].sum() > 0 and port[".pf_dispatch"].sum() > 0
    # root kinds re-mint: a request's e2e is far below the run's clock
    assert 0 < raft["ref_digests"]["latency"]["e2e_p50"] < int(
        port[".now"].max())
    _equal_dicts(raft["ref_digests"], _digests(tstats, raft["state"]),
                 "Raft digests")


def test_raft_planes_change_no_other_leaf(raft):
    plain = _np(raft["plain"])
    keys = [k for k in plain if k[1:].split("[")[0] not in TRACE_FIELDS]
    assert_same(plain, raft["port"], keys=keys, what="Raft planes off/on")
    np.testing.assert_array_equal(
        raft["plain_rt"].fingerprints(raft["plain"]),
        raft["rt"].fingerprints(raft["state"]))


# --------------------------------------------------------------------------
# Edge cases: saturation, set_slo_target, an injected op's root
# --------------------------------------------------------------------------
SAT_LEAVES = ("pf_dispatch", "pf_busy", "pf_kill", "pf_restart", "pf_drop",
              "pf_delay", "lh_sojourn", "lh_e2e", "lh_slo_miss")


def test_counters_saturate_at_int32_max_as_the_reference():
    import jax.numpy as jnp
    seeds = np.arange(4, dtype=np.uint32)
    with reference_stream():
        jrt = _jax_pingpong(trace_cap=0)
        s = jrt.init_batch(seeds)
        s = s.replace(**{k: jnp.full_like(getattr(s, k), I32_MAX - 2)
                         for k in SAT_LEAVES})
        s = jrt.set_slo_target(s, 1)
        s, _ = jrt.run(s, 128, 64)
        ref = jax_leaves(s)
    rt = _port_pingpong(trace_cap=0)
    t = rt.init_batch(seeds)
    t = t.replace(**{k: torch.full_like(getattr(t, k), I32_MAX - 2)
                     for k in SAT_LEAVES})
    t = rt.set_slo_target(t, 1)
    t, _ = rt.run(t, 128, 64)
    got = _np(t)
    assert_same(ref, got, what="saturated counters")
    assert (got[".pf_busy"] == I32_MAX).any()
    assert (got[".lh_slo_miss"] == I32_MAX).any()


def test_set_slo_target_counts_the_same_misses():
    with reference_stream():
        jrt = _jax_pingpong()
        s = jrt.set_slo_target(jrt.init_batch(PP_SEEDS), J.ms(3))
        s, _ = jrt.run(s, 192, 64)
        ref = jax_leaves(s)
    rt = _port_pingpong()
    t = rt.set_slo_target(rt.init_batch(PP_SEEDS), J.ms(3))
    t, _ = rt.run(t, 192, 64)
    got = _np(t)
    assert_same(ref, got, what="set_slo_target")
    assert got[".lh_slo_miss"].sum() > 0
    with pytest.raises(ValueError, match="latency_hist > 0"):
        _port_pingpong(profile=False, lat=0).set_slo_target(t, 5)


def test_an_injected_op_mints_its_own_root():
    ops = [("kill", (1,)), ("restart", (1,)), ("heal", ())]
    with reference_stream():
        jrt = _jax_pingpong(scenario=False, target=1000)
        s, _ = jrt.run(jrt.init_batch(PP_SEEDS), 64, 32)
        for name, args in ops:
            s = getattr(jrt, name)(s, *args)
            s, _ = jrt.run(s, 32, 32)
        ref = jax_leaves(s)
    rt = _port_pingpong(scenario=False, target=1000)
    t, _ = rt.run(rt.init_batch(PP_SEEDS), 64, 32)
    for name, args in ops:
        t = getattr(rt, name)(t, *args)
        t, _ = rt.run(t, 32, 32)
    got = _np(t)
    assert_same(ref, got, what="injected ops with the latency plane")
    assert got[".pf_kill"].sum() > 0 and got[".pf_restart"].sum() > 0


# --------------------------------------------------------------------------
# slo_invariant: the same CRASH_SLO lanes at the same steps
# --------------------------------------------------------------------------
def _slo_rt(mod, pp, slo, min_count=4):
    return _pingpong(mod, pp, profile=False, trace_cap=0, n=2, target=40,
                     loss=0.0, scenario=False,
                     invariant=slo(p99_le=1, min_count=min_count))


def test_slo_invariant_crashes_the_same_lanes_at_the_same_step():
    import madsim_tpu_torch as P
    from madsim_tpu.harness.slo import slo_invariant as jslo
    from madsim_tpu_torch.harness.slo import slo_invariant as tslo
    seeds = np.arange(8, dtype=np.uint32)
    with reference_stream():
        jrt = _slo_rt(J, jpp, jslo)
        ref = jax_leaves(jrt.run_fused(jrt.init_batch(seeds), 256, 64))
        ref_single = jax_leaves(jrt.run_single(3, 256, 64)[0])
    rt = _slo_rt(P, tpp, tslo)
    got = _np(rt.run_fused(rt.init_batch(seeds), 256, 64))
    assert_same(ref, got, what="slo_invariant")
    assert (got[".crash_code"] == P.core.types.CRASH_SLO).all()
    assert_same(ref_single, _np(rt.run_single(3, 256, 64)[0]),
                what="slo_invariant, seed 3 alone")
    # a min_count the lanes never reach never fires
    quiet = _slo_rt(P, tpp, tslo, min_count=10**6)
    assert not quiet.run(quiet.init_batch(seeds[:4]), 128, 64)[0] \
        .crashed.any()


def test_slo_invariant_checks_its_arguments_and_plane():
    import madsim_tpu_torch as P
    from madsim_tpu_torch.harness.slo import slo_invariant
    with pytest.raises(ValueError, match="p99_le"):
        slo_invariant()
    with pytest.raises(ValueError, match="q must"):
        slo_invariant(q="p42", target=5)
    rt = _pingpong(P, tpp, profile=False, lat=0, trace_cap=0,
                   invariant=slo_invariant(p99_le=1))
    with pytest.raises(ValueError, match="latency plane"):
        rt.run(rt.init_batch([1, 2]), 8, 8)


# --------------------------------------------------------------------------
# fuzz with the tail-latency energy
# --------------------------------------------------------------------------
FUZZ = dict(max_steps=240, batch=16, max_rounds=3, chunk=48, lat_bonus=0.5,
            rng_seed=5)


def test_fuzz_with_lat_bonus_builds_the_reference_corpus():
    import madsim_tpu_torch as P
    from madsim_tpu.search import Corpus as JCorpus
    from madsim_tpu.search import KnobPlan as JPlan
    from madsim_tpu.search import fuzz as jfuzz
    from madsim_tpu_torch.search import Corpus as TCorpus
    from madsim_tpu_torch.search import KnobPlan as TPlan
    from madsim_tpu_torch.search import fuzz as tfuzz
    with reference_stream():
        jrt = _pingpong(J, jpp, profile=False, trace_cap=0, n=4, target=6,
                        loss=0.0)
        jc = JCorpus(JPlan.from_runtime(jrt),
                     rng=np.random.default_rng(FUZZ["rng_seed"]))
        ref = jfuzz(jrt, corpus=jc, **FUZZ)
    rt = _pingpong(P, tpp, profile=False, trace_cap=0, n=4, target=6,
                   loss=0.0)
    tc = TCorpus(TPlan.from_runtime(rt),
                 rng=np.random.default_rng(FUZZ["rng_seed"]))
    got = tfuzz(rt, corpus=tc, **FUZZ)
    assert tc.lat_bonus == FUZZ["lat_bonus"]
    _equal_dicts(ref, got, "fuzz")
    assert len(jc.entries) == len(tc.entries) > 0
    for a, b in zip(jc.entries, tc.entries):
        _equal_dicts(a, b, "corpus entry")
    # the latency energy was live: some admitted energy is not the base
    energies = {round(float(e["energy"]), 9) for e in tc.entries}
    assert len(energies) > 1


# --------------------------------------------------------------------------
# The plane leaves cross the package boundary both ways
# --------------------------------------------------------------------------
def test_plane_checkpoints_cross_load_both_ways(pingpong, tmp_path):
    """A plane-on batch saved by the JAX package loads in the port with
    every plane leaf at its real shape, and resumes to the JAX package's
    run; the port's save loads back in the JAX package."""
    from madsim_tpu.runtime import checkpoint as jckpt
    from madsim_tpu_torch.runtime import checkpoint
    init = dict(profile_lanes=PROFILE_LANES, latency_lanes=LATENCY_LANES)
    with reference_stream():
        jrt = _jax_pingpong()
        half, _ = jrt.run(jrt.init_batch(PP_SEEDS, **init), 128, 64)
        jckpt.save(str(tmp_path / "jax.npz"), half)
        like = jrt.init_batch(PP_SEEDS)
    rt = pingpong["rt"]
    loaded = checkpoint.load(str(tmp_path / "jax.npz"),
                             rt.init_batch(PP_SEEDS))
    assert_same(jax_leaves(half), _np(loaded), what="jax -> port")
    assert loaded.lh_e2e.shape[1:] == (3, 24) and loaded.pf_busy.sum() > 0
    resumed, _ = rt.run(loaded, 128, 64)
    assert_same(pingpong["ref"], _np(resumed), what="resumed in the port")
    checkpoint.save(str(tmp_path / "port.npz"), loaded)
    with reference_stream():
        back = jckpt.load(str(tmp_path / "port.npz"), like)
    assert_same(jax_leaves(back), _np(loaded), what="port -> jax")
