"""Chaos-script minimization against the JAX package (tolerance: zero), on
the CPU: `harness/minimize.py`'s batched ddmin over a scenario
(`minimize_scenario`) and over a fuzzer knob vector (`minimize_knobs`),
the serial pass, `fuzz(minimize=True)`, and the MADSIM_TEST_MINIMIZE
report of `run_seeds`.

The workload is the unsynced-WAL red case of the JAX package's
tests/test_minimize.py (wal_kv, 2 clients, 12 ops, wal_cap 64,
sync_wal=False, seed 0) with two kill/restart pairs and a 1 s time limit,
so a candidate whose server never comes back halts within ~100 steps:
every candidate run costs the port's eager CPU step some seconds. The
results do not depend on `chunk` (a halted lane is a fixed point), so
both sides run chunks of 16 steps. The JAX side runs on the
non-partitionable threefry stream (see _torch_parity), once per module.
"""

import numpy as np
import pytest

from _torch_parity import one_cpu_thread, reference_stream  # noqa: F401
from madsim_tpu_torch import interop
from madsim_tpu_torch.harness import minimize as mini
from madsim_tpu_torch.harness import simtest as sim

SEED = 0
STEPS = 60_000
CHUNK = 16
LOST_WRITE = 301

pytestmark = pytest.mark.usefixtures("one_cpu_thread")


def _chaos(M, pairs=2):
    sc = M.Scenario()
    for t in range(pairs):
        sc.at(M.ms(150) + M.ms(250) * t).kill(0)
        sc.at(M.ms(210) + M.ms(250) * t).restart(0)
    return sc


def _jax_runtime():
    import madsim_tpu as M
    from madsim_tpu.models.wal_kv import make_wal_kv_runtime
    cfg = M.SimConfig(n_nodes=3, event_capacity=256, payload_words=8,
                      time_limit=M.sec(1),
                      net=M.NetConfig(send_latency_min=M.ms(1),
                                      send_latency_max=M.ms(8)))
    return make_wal_kv_runtime(n_clients=2, n_ops=12, wal_cap=64,
                               sync_wal=False, scenario=_chaos(M), cfg=cfg)


def _port_runtime():
    import madsim_tpu_torch as M
    from madsim_tpu_torch.models.wal_kv import make_wal_kv_runtime
    cfg = M.SimConfig(n_nodes=3, event_capacity=256, payload_words=8,
                      time_limit=M.sec(1),
                      net=M.NetConfig(send_latency_min=M.ms(1),
                                      send_latency_max=M.ms(8)))
    return make_wal_kv_runtime(n_clients=2, n_ops=12, wal_cap=64,
                               sync_wal=False, scenario=_chaos(M), cfg=cfg,
                               device="cpu")


FUZZ = dict(max_steps=STEPS, batch=4, max_rounds=1, chunk=CHUNK,
            minimize=True)


@pytest.fixture(scope="module")
def jax_results():
    from madsim_tpu.harness.minimize import minimize_knobs, \
        minimize_scenario
    from madsim_tpu.search.fuzz import fuzz
    from madsim_tpu.search.mutate import KnobPlan
    with reference_stream():
        rt = _jax_runtime()
        scen = minimize_scenario(rt, SEED, STEPS, CHUNK)
        plan = KnobPlan.from_runtime(rt)
        knobs = minimize_knobs(rt, plan, plan.base_knobs(), SEED, STEPS,
                               CHUNK)
        fz = fuzz(rt, **FUZZ)
    return dict(scenario=scen, knobs=knobs, fuzz=fz)


def _same_knobs(a: dict, b: dict):
    a, b = interop.knobs_to_numpy(a), interop.knobs_to_numpy(b)
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_minimize_scenario_gives_the_jax_packages_script(jax_results):
    rt = _port_runtime()
    full = rt.scenario.describe()
    minimal, info = mini.minimize_scenario(rt, SEED, STEPS, CHUNK)
    want_min, want_info = jax_results["scenario"]
    assert minimal.describe() == want_min.describe()
    assert info == want_info
    assert info["mode"] == "batched" and info["crash_code"] == LOST_WRITE
    assert info["kept"] < info["kept"] + info["dropped"]
    assert rt.scenario.describe() == full        # the runtime restored


def test_minimize_knobs_gives_the_jax_packages_knobs(jax_results):
    from madsim_tpu_torch.search.mutate import KnobPlan
    rt = _port_runtime()
    plan = KnobPlan.from_runtime(rt)
    minimal, info = mini.minimize_knobs(rt, plan, plan.base_knobs(), SEED,
                                        STEPS, CHUNK)
    want_min, want_info = jax_results["knobs"]
    _same_knobs(minimal, want_min)
    assert info == want_info
    assert info["crash_code"] == LOST_WRITE and info["dropped"] > 0


def test_fuzz_minimize_gives_the_jax_packages_table(jax_results):
    """fuzz(minimize=True) shrinks each crash code's first repro; the
    `minimized` table (kept, dropped, runs, code, script, knobs) is the
    JAX package's."""
    from madsim_tpu_torch.search import fuzz
    got = fuzz(_port_runtime(), **FUZZ)
    want = jax_results["fuzz"]
    assert sorted(got["minimized"]) == sorted(want["minimized"]) \
        == [LOST_WRITE]
    for c in want["minimized"]:
        g, w = dict(got["minimized"][c]), dict(want["minimized"][c])
        _same_knobs(g.pop("knobs"), w.pop("knobs"))
        assert g == w
    assert got["crash_repros"][LOST_WRITE]["script"] \
        == want["crash_repros"][LOST_WRITE]["script"]


def test_run_seeds_reports_the_minimal_script_under_the_env(monkeypatch):
    """MADSIM_TEST_MINIMIZE=1: the crash report carries the minimizer's
    script (its kept / total rows and runs); a minimizer that fails
    leaves the repro line standing with the reason."""
    rt = _port_runtime()
    sc = rt.scenario
    calls = []

    def fake(rt_, seed, max_steps, chunk):
        calls.append((seed, max_steps, chunk))
        return sc, dict(kept=2, dropped=3, runs=4)

    monkeypatch.setattr(mini, "minimize_scenario", fake)
    monkeypatch.setenv("MADSIM_TEST_MINIMIZE", "1")
    with pytest.raises(sim.SimFailure) as ei:
        sim.run_seeds(rt, np.arange(2), STEPS, chunk=CHUNK)
    assert calls == [(SEED, STEPS, CHUNK)]
    text = str(ei.value)
    assert "minimal chaos script (2 of 5 rows, 4 runs):" in text
    assert sc.describe() in text and "MADSIM_TEST_SEED=0" in text

    def broken(*a):
        raise ValueError("nothing to minimize")

    monkeypatch.setattr(mini, "minimize_scenario", broken)
    with pytest.raises(sim.SimFailure) as ei:
        sim.run_seeds(rt, np.arange(2), STEPS, chunk=CHUNK)
    assert "(minimization unavailable: nothing to minimize)" \
        in str(ei.value)


@pytest.mark.slow
def test_the_serial_pass_gives_the_jax_packages_script():
    """batched=False, the one-run-a-candidate loop the batched pass falls
    back to (mode "serial")."""
    from madsim_tpu.harness.minimize import minimize_scenario
    with reference_stream():
        want = minimize_scenario(_jax_runtime(), SEED, STEPS, CHUNK,
                                 batched=False)
    got = mini.minimize_scenario(_port_runtime(), SEED, STEPS, CHUNK,
                                 batched=False)
    assert got[0].describe() == want[0].describe()
    assert got[1] == want[1] and got[1]["mode"] == "serial"


def test_durable_fuzz_minimize_writes_the_script_into_its_bucket(
        jax_results, tmp_path):
    """With a store, fuzz(minimize=True) also writes each shrunk script
    into the bucket that the run opened for its crash code (the repro
    handle stays): the JAX package's `minimized` entry less its knobs."""
    import json
    from madsim_tpu_torch.search import fuzz
    from madsim_tpu_torch.service import CorpusStore
    d = str(tmp_path / "camp")
    got = fuzz(_port_runtime(), corpus_dir=d, **FUZZ)
    store = CorpusStore(d, create=False)
    recs = [store.load_bucket(k) for k in got["buckets_opened"]]
    assert recs and {r["crash_code"] for r in recs} == {LOST_WRITE}
    want = {k: v for k, v in jax_results["fuzz"]["minimized"][
        LOST_WRITE].items() if k != "knobs"}
    for rec in recs:
        assert rec["minimized"] == json.loads(json.dumps(want))
        seed, _ = store.load_bucket_repro(rec["key"])
        assert seed == rec["repro"]["seed"]
