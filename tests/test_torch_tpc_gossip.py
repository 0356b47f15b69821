"""The port's two-phase commit (`models/two_phase_commit.py`) and gossip
(`models/gossip.py`) against the JAX package (tolerance: zero), on the
CPU.

The cases are the JAX package's tests/test_two_phase_commit.py (a clean
run; loss with two coordinator kill/restarts; the `early_decide_quorum=2`
bug, which crashes lanes with the reference's codes) and
tests/test_gossip.py (a clean run; the origin cut off by a partition
until a heal), each held leaf for leaf through `run`. Fewer seeds than
the JAX tests, and the partition healed at 1 s instead of 2 s: the
port's eager CPU step costs 20-40 ms (ROADMAP F24). The JAX side runs on
the non-partitionable threefry stream (see _torch_parity).
"""

import numpy as np
import pytest

import madsim_tpu as J
import madsim_tpu_torch as P
from _torch_parity import (assert_same, jax_leaves, one_cpu_thread,  # noqa
                           reference_stream)
from madsim_tpu.models import gossip as jgossip
from madsim_tpu.models import two_phase_commit as jtpc
from madsim_tpu_torch import interop
from madsim_tpu_torch.models import gossip as tgossip
from madsim_tpu_torch.models import two_phase_commit as ttpc

pytestmark = pytest.mark.usefixtures("one_cpu_thread")

N, TX = 5, 6


def _tpc_cfg(mod, loss=0.0, time_limit=None):
    return mod.SimConfig(n_nodes=N, event_capacity=128,
                         time_limit=time_limit or mod.sec(20),
                         net=mod.NetConfig(packet_loss_rate=loss,
                                           send_latency_min=mod.ms(1),
                                           send_latency_max=mod.ms(10)))


def _coordinator_crashes(mod):
    sc = mod.Scenario()
    sc.at(mod.ms(100)).kill(0)
    sc.at(mod.ms(600)).restart(0)
    sc.at(mod.ms(900)).kill(0)
    sc.at(mod.ms(1400)).restart(0)
    return sc


def _partition_heal(mod):
    sc = mod.Scenario()
    sc.at(mod.ms(0)).partition([0])     # isolate the origin immediately
    sc.at(mod.sec(1)).heal()
    return sc


# case: maker(package, model module, keywords), seeds, max_steps, chunk
CASES = {
    "tpc_clean": (lambda m, md, kw: md.make_tpc_runtime(
        N, TX, cfg=_tpc_cfg(m), **kw), 8, 20_000, 128),
    "tpc_coordinator_crash": (lambda m, md, kw: md.make_tpc_runtime(
        N, TX, scenario=_coordinator_crashes(m),
        cfg=_tpc_cfg(m, loss=0.1, time_limit=m.sec(30)), **kw),
        8, 60_000, 128),
    "tpc_early_decide_bug": (lambda m, md, kw: md.make_tpc_runtime(
        N, TX, early_decide_quorum=2, p_yes=0.6,
        cfg=_tpc_cfg(m, loss=0.15, time_limit=m.sec(30)), **kw),
        24, 60_000, 128),
    "gossip_clean": (lambda m, md, kw: md.make_gossip_runtime(
        n_nodes=8, n_rumors=4, **kw), 8, 20_000, 128),
    "gossip_partition_heal": (lambda m, md, kw: md.make_gossip_runtime(
        n_nodes=8, n_rumors=4, scenario=_partition_heal(m),
        cfg=m.SimConfig(n_nodes=8, event_capacity=192, time_limit=m.sec(20),
                        net=m.NetConfig(packet_loss_rate=0.2)), **kw),
        8, 40_000, 128),
}


def _run_case(case):
    make, n, max_steps, chunk = CASES[case]
    jmod, tmod = ((jtpc, ttpc) if case.startswith("tpc")
                  else (jgossip, tgossip))
    seeds = np.arange(n, dtype=np.uint32)
    with reference_stream():
        jrt = make(J, jmod, {})
        s, _ = jrt.run(jrt.init_batch(seeds), max_steps, chunk)
        ref = jax_leaves(s)
    rt = make(P, tmod, dict(device="cpu"))
    t, _ = rt.run(rt.init_batch(seeds), max_steps, chunk)
    got = interop.state_to_numpy(t)
    assert_same(ref, got, what=case)
    return got


@pytest.mark.parametrize("case", sorted(CASES))
def test_model_matches_reference(case):
    got = _run_case(case)
    assert got[".halted"].all()
    crashed = got[".crashed"]
    if case.startswith("tpc"):
        dec = got[".node_state['decided']"]      # [B, N, TX]
        if case == "tpc_early_decide_bug":
            # the bug fires on some lanes, with the reference's codes
            assert crashed.any()
            assert set(got[".crash_code"][crashed].tolist()) <= {
                ttpc.CRASH_DIVERGED, ttpc.CRASH_NO_VOTE_COMMIT}
            return
        assert not crashed.any()
        for b in range(dec.shape[0]):
            for t in range(TX):
                vals = set(dec[b, 1:, t].tolist()) - {ttpc.NONE}
                assert len(vals) <= 1     # never both COMMIT and ABORT
        if case == "tpc_clean":
            assert (dec[:, 1:, :] != ttpc.NONE).all()
    else:
        assert not crashed.any()
        assert (got[".node_state['have']"] == 15).all()
        assert (got[".node_state['infected_at']"] >= 0).all()
        if case == "gossip_partition_heal":
            assert (got[".now"] > P.sec(1)).mean() >= 0.75


def test_popcount_and_invariant_match_reference():
    """`_popcount` stays int32 (ROADMAP F2) and the atomicity invariant
    flags exactly the lanes the reference flags."""
    import jax.numpy as jnp
    import torch
    x = np.array([0, 1, 0b10110, 0x7FFFFFFF, -1, 1 << 30], np.int32)
    got = ttpc._popcount(torch.as_tensor(x), 31)
    assert got.dtype == torch.int32
    want = [int(jtpc._popcount(jnp.asarray(v), 31)) for v in x]
    assert got.tolist() == want
    rng = np.random.default_rng(5)
    dec = rng.integers(0, 3, (64, N, TX)).astype(np.int32)
    dec[::3] = np.where(dec[::3] == ttpc.ABORT, ttpc.COMMIT, dec[::3])
    st = P.SimState.__new__(P.SimState)
    st.node_state = dict(decided=torch.as_tensor(dec))
    bad, code = ttpc.tpc_invariant(N, TX)(st)
    jinv = jtpc.tpc_invariant(N, TX)

    class JState:
        node_state = None

    ref = []
    for b in range(dec.shape[0]):
        js = JState()
        js.node_state = dict(decided=jnp.asarray(dec[b]))
        jb, jc = jinv(js)
        ref.append((bool(jb), int(jc)))
    assert [(bool(b), int(c)) for b, c in zip(bad, code)] == ref
    assert any(b for b, _ in ref) and not all(b for b, _ in ref)
