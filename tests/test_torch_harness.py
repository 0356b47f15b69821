"""The port's harness and runner remainder against the JAX package
(tolerance: zero), on the CPU.

Covers the chaos recipes (`runtime/chaos.py`), the trace formatter
(`runtime/trace.py`), `Runtime.derived`, `Runtime.run_compacting` (its
result and its observer records), `Runtime.state_at`
(`obs/timetravel.advance_exact`), batch checkpoints across the two
packages (`runtime/checkpoint.py`), the divergence bisection
(`harness/determinism.py`) and the determinism sanitizer
(`harness/simtest.py`: `detsan_perm`, `diff_states`, `detsan_check`,
`DetSanFailure`, `run_seeds(detsan=...)`). The sanitizer on whole Raft
and wal_kv sweeps is in tests/test_torch_harness_detsan.py, minimization
in tests/test_torch_harness_minimize.py. The JAX side runs on the
non-partitionable threefry stream (see _torch_parity); each JAX reference
is computed once per module.
"""

import numpy as np
import pytest
import torch

import madsim_tpu as J
from _torch_parity import (assert_same, jax_leaves, one_cpu_thread,  # noqa: F401
                           reference_stream)
from madsim_tpu.harness import determinism as jdet
from madsim_tpu.harness import simtest as jsim
from madsim_tpu.models import pingpong as jpp
from madsim_tpu.runtime import chaos as jchaos
from madsim_tpu.runtime import checkpoint as jckpt
from madsim_tpu.runtime import trace as jtrace
from madsim_tpu_torch import NetConfig, Runtime, SimConfig, interop, ms, sec
from madsim_tpu_torch.harness import determinism as det
from madsim_tpu_torch.harness import simtest as sim
from madsim_tpu_torch.models import pingpong as pp
from madsim_tpu_torch.runtime import chaos, checkpoint
from madsim_tpu_torch.runtime import trace as trace_mod

pytestmark = pytest.mark.usefixtures("one_cpu_thread")


def _jrt(target=20, n=3, net=None):
    cfg = J.SimConfig(n_nodes=n, time_limit=J.sec(30),
                      net=J.NetConfig(**(net or {})))
    return J.Runtime(cfg, [jpp.PingPong(n, target=target)], jpp.state_spec())


def _prt(target=20, n=3, net=None):
    return Runtime(SimConfig(n_nodes=n, time_limit=sec(30),
                             net=NetConfig(**(net or {}))),
                   [pp.PingPong(n, target=target)], pp.state_spec(),
                   device="cpu")


# latency from 1 to 40 ms: 384 lanes halt from step ~119 to ~174, the
# long tail that compaction is for
WIDE = dict(send_latency_min=ms(1), send_latency_max=ms(40))


def _np(state):
    return interop.state_to_numpy(state)


# --------------------------------------------------------------------------
# chaos recipes
# --------------------------------------------------------------------------
RECIPES = {
    "rolling_kills": lambda c: c.rolling_kills(rounds=3, among=[0, 2, 4]),
    "rolling_pauses": lambda c: c.rolling_pauses(rounds=2, down=ms(200)),
    "split_brain": lambda c: c.split_brain(sec(2), [0, 1], sec(1)),
    "flaky_network": lambda c: c.flaky_network(
        ms(100), 0.3, ms(900), latency=(ms(2), ms(9)),
        restore_latency=(ms(1), ms(3))),
    "flaky_network_no_heal": lambda c: c.flaky_network(
        ms(100), 0.5, ms(300), heal=False, restore_loss=0.05),
    "madraft_churn": lambda c: c.madraft_churn([0, 1, 2], rounds=2),
    "asymmetric_partition": lambda c: c.asymmetric_partition(
        ms(300), [1, 2], ms(400), direction=1),
    "clock_drift_pool": lambda c: c.clock_drift(ms(100), 300, among=[1, 3],
                                                until=ms(800)),
    "clock_drift_node": lambda c: c.clock_drift(ms(100), -200, node=2,
                                                until=ms(700)),
    "slow_disk_pool": lambda c: c.slow_disk(ms(100), ms(20), ms(500)),
    "slow_disk_node": lambda c: c.slow_disk(ms(100), ms(7), ms(500),
                                            node=1),
    "torn_write_kill": lambda c: c.torn_write_kill(ms(300), 0),
    "conn_reset_storm_pool": lambda c: c.conn_reset_storm(
        rounds=3, among=[1, 2]),
    "conn_reset_storm_node": lambda c: c.conn_reset_storm(rounds=2, node=1),
    "retransmit_storm_pool": lambda c: c.retransmit_storm(ms(100), 0.25,
                                                          ms(600)),
    "retransmit_storm_node": lambda c: c.retransmit_storm(ms(100), 0.4,
                                                          ms(600), node=2),
    "half_open_churn": lambda c: c.half_open_churn(1, rounds=2),
    "gray_failure": lambda c: c.gray_failure(ms(200), ms(900), group=(1, 2)),
    "composed": lambda c: c.split_brain(
        sec(2), [0, 1], sec(1), sc=c.rolling_kills(rounds=2, among=[3, 4])),
}


@pytest.mark.parametrize("name", sorted(RECIPES))
def test_chaos_recipe_builds_the_same_rows(name):
    """Every recipe (the 13 helpers, with and without a target node or
    pool, and two composed) gives the same rows and description."""
    got = RECIPES[name](chaos)
    want = RECIPES[name](jchaos)
    assert got.describe() == want.describe()
    cfg_p, cfg_j = SimConfig(n_nodes=5), J.SimConfig(n_nodes=5)
    rp, rj = got.build(cfg_p), want.build(cfg_j)
    assert sorted(rp) == sorted(rj)
    for k in rj:
        np.testing.assert_array_equal(np.asarray(rp[k]), np.asarray(rj[k]),
                                      err_msg=k)


# --------------------------------------------------------------------------
# trace formatting, derived
# --------------------------------------------------------------------------
@pytest.fixture(scope="module")
def traces():
    with reference_stream():
        _, jev = _jrt(target=3).run_single(5, 2000, collect_events=True)
    _, pev = _prt(target=3).run_single(5, 2000, chunk=64,
                                       collect_events=True)
    return jev, pev


@pytest.mark.parametrize("how", ["all", "time_start", "env", "limit",
                                 "node_names"])
def test_format_trace_renders_the_same_lines(traces, how, monkeypatch):
    jev, pev = traces
    kw = dict(all={}, time_start=dict(time_start=ms(5)), env={},
              limit=dict(limit=7),
              node_names=dict(node_names=["srv", "a", "b"]))[how]
    if how == "env":
        monkeypatch.setenv("MADSIM_LOG_TIME_START", "4.5")
    got = trace_mod.format_trace(pev, 0, **kw)
    want = jtrace.format_trace(jev, 0, **kw)
    assert got == want and got
    if how == "limit":
        assert len(got) == 7


def test_derived_runtime_gives_the_same_leaves():
    """derived(trace_cap=64): the recorder compiled into the same world."""
    seeds = np.arange(8, dtype=np.uint32)
    with reference_stream():
        jr = _jrt().derived(trace_cap=64)
        ja, _ = jr.run(jr.init_batch(seeds), 64, chunk=64)
        want = jax_leaves(ja)
    base = _prt()
    pr = base.derived(trace_cap=64)
    assert pr.cfg.trace_cap == 64 and base.cfg.trace_cap == 0
    assert pr.scenario.describe() == base.scenario.describe()
    assert pr.device == base.device
    pa, _ = pr.run(pr.init_batch(seeds), 64, chunk=64)
    assert_same(want, _np(pa), what="derived(trace_cap=64)")


# --------------------------------------------------------------------------
# run_compacting
# --------------------------------------------------------------------------
class _Rec:
    def __init__(self):
        self.recs = []

    def on_chunk(self, rec):
        self.recs.append(rec)

    on_compact = on_done = on_chunk

    def stripped(self):
        return [{k: v for k, v in r.items()
                 if k not in ("wall_s", "lane_steps_per_sec")}
                for r in self.recs]


COMPACT_CASES = {
    # case: (chunk, compact_when, min_batch, held against JAX too)
    "defaults_min_batch_256": (8, 0.5, 256, False),
    "min_batch_32": (8, 0.5, 32, True),
}


@pytest.fixture(scope="module")
def compacted():
    """The JAX package's run_compacting at 384 lanes, where it repacks
    three times (384 -> 256 -> 64 -> 32): its result and records."""
    seeds = np.arange(384, dtype=np.uint32)
    chunk, when, mb, _ = COMPACT_CASES["min_batch_32"]
    with reference_stream():
        jr = _jrt(net=WIDE)
        obs = _Rec()
        js = jr.run_compacting(jr.init_batch(seeds), 2000, chunk=chunk,
                               compact_when=when, min_batch=mb,
                               observer=obs)
        return jax_leaves(js), obs.stripped()


@pytest.fixture(scope="module")
def port_plain_run():
    rt = _prt(net=WIDE)
    s, _ = rt.run(rt.init_batch(np.arange(384, dtype=np.uint32)), 2000,
                  chunk=8)
    return _np(s)


@pytest.mark.parametrize("case", sorted(COMPACT_CASES))
def test_run_compacting_equals_jax_and_run(compacted, port_plain_run, case):
    """At 384 lanes: the result equals the port's own run (held to the
    JAX package's elsewhere) and, with its observer records (but wall_s
    and rates), the JAX package's run_compacting; at least one repack,
    the caller's state unchanged."""
    chunk, when, mb, against_jax = COMPACT_CASES[case]
    rt = _prt(net=WIDE)
    init = rt.init_batch(np.arange(384, dtype=np.uint32))
    before = _np(init)
    obs = _Rec()
    got = rt.run_compacting(init, 2000, chunk=chunk, compact_when=when,
                            min_batch=mb, observer=obs)
    assert_same(port_plain_run, _np(got), what="run_compacting vs run")
    recs = obs.stripped()
    if against_jax:
        want, want_recs = compacted
        assert_same(want, _np(got), what=f"run_compacting {case}")
        assert recs == want_recs
    compacts = [r for r in recs if r["kind"] == "compact"]
    assert len(compacts) == rt.compact_stats["repacks"] >= 1
    assert rt.compact_stats["widths"] == [384] + [r["to_batch"]
                                                 for r in compacts]
    assert recs[-1]["lanes_halted"] == 384
    assert_same(before, _np(init), what="the caller's state")


# --------------------------------------------------------------------------
# time travel, checkpoints
# --------------------------------------------------------------------------
@pytest.fixture(scope="module")
def jax_state_at():
    with reference_stream():
        jr = _jrt(target=8)
        return {k: jax_leaves(jr.state_at(3, k)) for k in (1, 37, 100)}


@pytest.mark.parametrize("k", [1, 37, 100])
def test_state_at_lands_on_the_jax_packages_step(jax_state_at, k):
    rt = _prt(target=8)
    got = rt.state_at(3, k)
    assert_same(jax_state_at[k], _np(got), what=f"state_at(3, {k})")
    direct, _ = rt.run(rt.init_single(3), k, chunk=k)
    assert rt.fingerprints(direct)[0] == rt.fingerprints(got)[0]


@pytest.fixture(scope="module")
def jax_half():
    with reference_stream():
        jr = _jrt()
        half, _ = jr.run(jr.init_batch(np.arange(16)), 64, chunk=64)
        full, _ = jr.run(jr.init_batch(np.arange(16)), 4000, chunk=64)
        return jr, half, jax_leaves(full)


def test_a_jax_checkpoint_loads_and_resumes_in_the_port(jax_half, tmp_path):
    jr, half, full = jax_half
    p = str(tmp_path / "jax.npz")
    jckpt.save(p, half)
    rt = _prt()
    loaded = checkpoint.load(p, rt.init_batch(np.arange(16)))
    assert_same(jax_leaves(half), _np(loaded), what="loaded")
    resumed, _ = rt.run(loaded, 4000, chunk=64)
    assert_same(full, _np(resumed), what="resumed")


def test_a_port_checkpoint_loads_in_the_jax_package(jax_half, tmp_path):
    jr, half, _ = jax_half
    rt = _prt()
    mine, _ = rt.run(rt.init_batch(np.arange(16)), 64, chunk=64)
    p = str(tmp_path / "port.npz")
    checkpoint.save(p, mine)
    with reference_stream():
        loaded = jckpt.load(p, jr.init_batch(np.arange(16)))
    assert_same(jax_leaves(loaded), _np(mine), what="port -> jax")
    assert_same(jax_leaves(half), _np(mine), what="the same state")


@pytest.mark.parametrize("bad", ["wrong_batch", "wrong_world"])
def test_checkpoint_load_refuses_another_shape(jax_half, tmp_path, bad):
    """A file of 4 lanes into an 8-lane state, or of pingpong into Raft:
    both packages raise ValueError with the same message."""
    from madsim_tpu.models.raft import make_raft_runtime as jraft
    from madsim_tpu_torch.models.raft import make_raft_runtime
    rt = _prt()
    p = str(tmp_path / "four.npz")
    checkpoint.save(p, rt.init_batch(np.arange(4)))
    if bad == "wrong_batch":
        like_p, like_j = rt.init_batch(np.arange(8)), \
            jax_half[0].init_batch(np.arange(8))
    else:
        like_p = make_raft_runtime(3, 8, device="cpu").init_batch(
            np.arange(4))
        like_j = jraft(3, 8).init_batch(np.arange(4))
    with pytest.raises(ValueError) as ep:
        checkpoint.load(p, like_p)
    with pytest.raises(ValueError) as ej:
        jckpt.load(p, like_j)
    assert str(ep.value) == str(ej.value)


# --------------------------------------------------------------------------
# divergence bisection
# --------------------------------------------------------------------------
def test_no_divergence_on_a_deterministic_program():
    with reference_stream():
        want = jdet.find_divergence(_jrt(target=5), seed=3, max_steps=2000)
    assert want is None
    assert det.find_divergence(_prt(target=5), seed=3, max_steps=2000) \
        is None


def test_bisection_localizes_the_same_step_as_the_jax_package():
    """The duck-typed runtime of the JAX package's own test, replica B
    (every odd runner call) perturbed while it executes step K, and its
    torch mirror: the same step and the same event."""
    import jax.numpy as jnp
    K = 37

    def jax_twin():
        calls = {"n": 0}

        def runner(state, chunk):
            is_b = calls["n"] % 2 == 1
            calls["n"] += 1
            step = int(state["step"][0])
            x = state["x"]
            if is_b and step <= K < step + chunk:
                x = x + 1
            ev = dict(step=jnp.arange(step, step + chunk,
                                      dtype=jnp.int32)[:, None])
            return dict(x=x, step=state["step"] + chunk), ev

        class FakeRT:
            _run_chunk = {True: runner}

            def init_single(self, seed):
                return dict(x=jnp.zeros((1,), jnp.int32),
                            step=jnp.zeros((1,), jnp.int32))
        return FakeRT()

    class TorchTwin:
        """The same runtime over tensors, through the port's interface."""

        def __init__(self):
            self.calls = 0

        def init_single(self, seed):
            return dict(x=torch.zeros(1, dtype=torch.int32),
                        step=torch.zeros(1, dtype=torch.int32))

        def run_exact(self, state, steps, collect_events=False):
            is_b = self.calls % 2 == 1
            self.calls += 1
            step = int(state["step"][0])
            x = state["x"]
            if is_b and step <= K < step + steps:
                x = x + 1
            ev = dict(step=np.arange(step, step + steps,
                                     dtype=np.int32)[:, None])
            return dict(x=x, step=state["step"] + steps), ev

        def fingerprints(self, state):
            return state["x"].numpy().astype(np.uint32)

    want = jdet.find_divergence(jax_twin(), seed=0, max_steps=64, probe=64)
    got = det.find_divergence(TorchTwin(), seed=0, max_steps=64, probe=64)
    assert got["step"] == want["step"] == K
    assert sorted(got["event"]) == sorted(want["event"])
    assert int(got["event"]["step"]) == int(want["event"]["step"]) == K


# --------------------------------------------------------------------------
# the determinism sanitizer
# --------------------------------------------------------------------------
@pytest.mark.parametrize("B", [1, 2, 3, 16, 512])
def test_detsan_perm_is_the_jax_packages(B):
    got = sim.detsan_perm(B)
    np.testing.assert_array_equal(got, jsim.detsan_perm(B))
    assert got.dtype == np.int64 and sorted(got.tolist()) == list(range(B))


@pytest.fixture(scope="module")
def planted():
    """A pingpong batch after 64 steps and a copy with planted changes:
    `.now` moved in lanes 1, 4 and 6; `.loss` -0.0 against 0.0 in lane 0
    and NaN against NaN in lane 2 (no difference), NaN against a number
    in lane 5 (a difference)."""
    with reference_stream():
        jr = _jrt()
        ja, _ = jr.run(jr.init_batch(np.arange(8)), 64, chunk=64)
    a = jax_leaves(ja)
    b = {k: v.copy() for k, v in a.items()}
    b[".now"][[1, 4, 6]] += 1
    a[".loss"][0], b[".loss"][0] = -0.0, 0.0
    a[".loss"][2] = b[".loss"][2] = np.nan
    b[".loss"][5] = np.nan
    return ja, a, b


def _jax_state(ja, leaves):
    """`ja`'s structure with every leaf taken from `leaves`."""
    import jax
    import jax.numpy as jnp
    paths = list(jax_leaves(ja))
    return jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(ja),
        [jnp.asarray(leaves[k]) for k in paths])


@pytest.mark.parametrize("align", ["none", "permuted"])
def test_diff_states_names_the_same_leaves_and_lanes(planted, align):
    ja, a, b = planted
    perm = sim.detsan_perm(8)
    if align == "permuted":     # b as the permuted run would leave it
        b = {k: v[perm] for k, v in b.items()}
        al = np.argsort(perm)
    else:
        al = None
    want = jsim.diff_states(_jax_state(ja, a), _jax_state(ja, b), align=al)
    got = sim.diff_states(interop.state_from_numpy(a, "cpu"),
                          interop.state_from_numpy(b, "cpu"), align=al)
    assert got == want
    assert [(d["leaf"], d["lanes"]) for d in got] == [
        (".now", [1, 4, 6]), (".loss", [5])]


def test_a_planted_baseline_raises_with_the_jax_packages_report():
    """A baseline whose lane 3 disagrees with the permuted replay: both
    packages raise DetSanFailure naming seed 3, with the same text."""
    seeds = np.arange(8)
    with reference_stream():
        jr = _jrt(target=4, n=2)
        ja = jr.run_fused(jr.init_batch(seeds), 256, 16)
        jbad = ja.replace(now=ja.now.at[3].add(1))
        with pytest.raises(jsim.DetSanFailure) as ej:
            jsim.detsan_check(jr, seeds, 256, 16, baseline_state=jbad)
    rt = _prt(target=4, n=2)
    a = rt.run_fused(rt.init_batch(seeds), 256, 16)
    bad = a.replace(now=a.now.clone())
    bad.now[3] += 1
    with pytest.raises(sim.DetSanFailure) as ep:
        sim.detsan_check(rt, seeds, 256, 16, baseline_state=bad)
    assert ep.value.seed == ej.value.seed == 3
    assert str(ep.value) == str(ej.value)
    assert ep.value.diffs == ej.value.diffs
    rep = sim.detsan_check(rt, seeds, 256, 16, baseline_state=bad,
                           raise_on_diff=False)
    assert not rep["ok"] and rep["diffs"] == ej.value.diffs


def test_run_seeds_runs_the_sanitizer_by_flag_and_env(monkeypatch):
    rt = _prt(target=4, n=2)
    calls = []
    real = sim.detsan_check

    def spy(*a, **kw):
        calls.append(kw)
        return real(*a, **kw)

    monkeypatch.setattr(sim, "detsan_check", spy)
    state = sim.run_seeds(rt, np.arange(8), 256, chunk=16, detsan=True)
    assert bool(state.halted.all()) and tuple(state.now.shape) == (8,)
    monkeypatch.setenv("MADSIM_TEST_DETSAN", "1")
    sim.run_seeds(rt, np.arange(8), 256, chunk=16)
    monkeypatch.delenv("MADSIM_TEST_DETSAN")
    sim.run_seeds(rt, np.arange(8), 256, chunk=16)
    assert len(calls) == 2
    assert all(kw["fused"] is False and kw["baseline_state"] is not None
               for kw in calls)
