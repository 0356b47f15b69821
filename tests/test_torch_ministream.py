"""The port's streaming dataflow (`models/ministream.py`) against the JAX
package (tolerance: zero), on the CPU.

The cases are the reference's tests/test_ministream.py: exactly-once
under loss; under mapper kill/restart chaos; the alignment bug
(`strict_barrier=False`), which crashes the same lanes with 401 in both
packages; k=31 at the one-word bitmask ceiling under chaos; k=32 refused
by both. Each run is held leaf for leaf through `run`. Fewer seeds (4-8,
JAX: 16-48) and, under loss, 2 epochs (JAX: 4): the port's eager CPU
step costs 20-40 ms (ROADMAP F24). The JAX side runs on the
non-partitionable threefry stream (see _torch_parity).
"""

import numpy as np
import pytest

import madsim_tpu as J
import madsim_tpu_torch as P
from _torch_parity import (assert_same, jax_leaves, one_cpu_thread,  # noqa
                           reference_stream)
from madsim_tpu.models import ministream as jms
from madsim_tpu_torch import interop, workloads
from madsim_tpu_torch.models import ministream as tms

pytestmark = pytest.mark.usefixtures("one_cpu_thread")


def _mod(pkg):
    return jms if pkg is J else tms


def _mapper_chaos(pkg, pairs):
    sc = pkg.Scenario()
    for t in range(pairs):
        sc.at(pkg.ms(300 + 700 * t)).kill_random(among=(jms.MAP_A,
                                                        jms.MAP_B))
        sc.at(pkg.ms(600 + 700 * t)).restart_random(among=(jms.MAP_A,
                                                           jms.MAP_B))
    return sc


def _ceiling(pkg, kw):
    sc = pkg.Scenario()
    sc.at(pkg.ms(300)).kill_random(among=(jms.MAP_A, jms.MAP_B))
    sc.at(pkg.ms(700)).restart_random(among=(jms.MAP_A, jms.MAP_B))
    cfg = pkg.SimConfig(n_nodes=4, event_capacity=320, time_limit=pkg.sec(60),
                        net=pkg.NetConfig(packet_loss_rate=0.05))
    return _mod(pkg).make_ministream_runtime(k=31, epochs=2, scenario=sc,
                                             cfg=cfg, **kw)


def _port_or_jax(name):
    """The workloads builder for the port; the same config for JAX."""
    def make(pkg, kw):
        if pkg is P:
            return getattr(workloads, name)(**kw)
        strict = name == "ministream_runtime"
        return jms.make_ministream_runtime(
            k=8, epochs=4, strict_barrier=strict,
            scenario=_mapper_chaos(J, 3) if strict else None)
    return make


# case: maker(package, device keywords), seeds, epochs committed (None:
# the red case)
CASES = {
    "loss": (lambda pkg, kw: _mod(pkg).make_ministream_runtime(
        k=8, epochs=2, **kw), 4, 2),
    "mapper_chaos": (_port_or_jax("ministream_runtime"), 4, 4),
    "overtake_bug": (_port_or_jax("ministream_overtake_runtime"), 8, None),
    "k31_ceiling": (_ceiling, 4, 2),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_ministream_matches_reference(case):
    make, n, epochs = CASES[case]
    seeds = np.arange(n, dtype=np.uint32)
    with reference_stream():
        jrt = make(J, {})
        s, _ = jrt.run(jrt.init_batch(seeds), 80_000, 256)
        ref = jax_leaves(s)
    rt = make(P, dict(device="cpu"))
    t, _ = rt.run(rt.init_batch(seeds), 80_000, 256)
    got = interop.state_to_numpy(t)
    assert_same(ref, got, what=case)
    assert got[".halted"].all()
    crashed = got[".crashed"]
    if epochs is None:
        # the oracle fires, with the reference's code, on the same lanes
        assert crashed.any()
        assert (got[".crash_code"][crashed]
                == tms.CRASH_STREAM_LOST_OR_DUP).all()
        return
    assert not crashed.any() and (got[".oops"] == 0).all()
    committed = got[".node_state['k_committed']"][:, tms.SINK]
    assert (committed == epochs).all()


def test_k32_is_refused_as_in_the_reference():
    with pytest.raises(AssertionError):
        jms.make_ministream_runtime(k=32, epochs=2)
    with pytest.raises(AssertionError):
        tms.make_ministream_runtime(k=32, epochs=2, device="cpu")
