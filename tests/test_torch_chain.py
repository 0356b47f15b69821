"""The port's chain replication (`models/chain.py`) against the JAX
package (tolerance: zero), on the CPU.

The cases are the reference's tests/test_chain.py at its table of 384
event rows (the plain path of the select and the emission write): a
clean run; the middle replica killed; the blip restart (killed and
restarted twice before the detector fires); and the buggy master wait,
whose two-tails invariant crashes the same lanes with 501 in both
packages. Each run is held leaf for leaf through `run`; the clients'
histories are then equal, and each is checked linearizable with the
port's checker. Fewer seeds (2-4, JAX: 8-16) and
simulated seconds (3 s, JAX: 6-12 s), one victim position (JAX: each of
three): the port's eager CPU step costs 20-40 ms (ROADMAP F24). The JAX
side runs on the non-partitionable threefry stream (see _torch_parity).
"""

import numpy as np
import pytest

import madsim_tpu as J
import madsim_tpu_torch as P
from _torch_parity import (assert_same, jax_leaves, one_cpu_thread,  # noqa
                           reference_stream)
from madsim_tpu.models import chain as jc
from madsim_tpu_torch import interop
from madsim_tpu_torch.models import chain as tc
from madsim_tpu_torch.native import check_kv_history

pytestmark = pytest.mark.usefixtures("one_cpu_thread")

R, NC, OPS = 3, 2, 20


def _cfg(pkg, time_limit):
    return pkg.SimConfig(n_nodes=1 + R + NC, event_capacity=384,
                         payload_words=12, time_limit=time_limit,
                         net=pkg.NetConfig(send_latency_min=pkg.ms(1),
                                           send_latency_max=pkg.ms(8)))


def _scenario(pkg, case):
    sc = pkg.Scenario()
    if case == "kill_middle":
        sc.at(pkg.ms(250)).kill(2)
    elif case == "blip_restart":
        sc.at(pkg.ms(250)).kill(2)
        sc.at(pkg.ms(300)).restart(2)
        sc.at(pkg.ms(500)).kill(2)
        sc.at(pkg.ms(550)).restart(2)
    elif case == "buggy_master_wait":
        sc.at(pkg.ms(150)).pause(R)
        sc.at(pkg.ms(330)).resume(R)
    return sc


def _runtime(pkg, case, kw):
    mod = jc if pkg is J else tc
    extra = (dict(lease=pkg.ms(400), master_wait=pkg.ms(1))
             if case == "buggy_master_wait" else {})
    return mod.make_chain_runtime(R, NC, OPS, scenario=_scenario(pkg, case),
                                  cfg=_cfg(pkg, pkg.sec(3)), **extra, **kw)


CASES = {"clean": 3, "kill_middle": 2, "blip_restart": 2,
         "buggy_master_wait": 4}


@pytest.mark.parametrize("case", sorted(CASES))
def test_chain_matches_reference(case):
    seeds = np.arange(CASES[case], dtype=np.uint32)
    with reference_stream():
        jrt = _runtime(J, case, {})
        s, _ = jrt.run(jrt.init_batch(seeds), 40_000, 256)
        ref = jax_leaves(s)
    rt = _runtime(P, case, dict(device="cpu"))
    assert rt.cfg.event_capacity == 384
    t, _ = rt.run(rt.init_batch(seeds), 40_000, 256)
    got = interop.state_to_numpy(t)
    assert_same(ref, got, what=case)
    assert got[".halted"].all()
    crashed = got[".crashed"]
    if case == "buggy_master_wait":
        assert crashed.all()
        assert (got[".crash_code"] == tc.CRASH_TWO_TAILS).all()
        return
    assert not crashed.any() and (got[".oops"] == 0).all()
    assert (got[".node_state['c_opn']"][:, 1 + R:] >= OPS).all()
    hists = tc.extract_histories(t, R, NC)
    assert len(hists) == len(seeds)
    assert all(check_kv_history(h) for h in hists)
    if case == "clean":
        # every replica converged on the same registers
        kv = got[".node_state['kv']"][:, 1:1 + R]
        assert (kv == kv[:, :1]).all()
