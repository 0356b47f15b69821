"""The port's failure-detector helpers (`utils/detector.py`) against the
JAX package (tolerance: zero), on the CPU.

The model is the reference's tests/test_detector.py `Monitored` cluster
(every node heartbeats and keeps its suspect mask), written once for each
package, in the reference's three cases — a clean cluster, a kill, a kill
and a restart — each held leaf for leaf through `run` and checked as the
reference checks it. Fewer seeds (8, JAX: 32) and shorter runs (the kill
at 0.5 s, JAX: 1 s) than the JAX tests: the port's eager CPU step costs
20-40 ms (ROADMAP F24). The JAX side runs on the non-partitionable
threefry stream (see _torch_parity).
"""

import numpy as np
import pytest
import torch

import madsim_tpu as J
import madsim_tpu_torch as P
from _torch_parity import (assert_same, jax_leaves, one_cpu_thread,  # noqa
                           reference_stream)
from madsim_tpu.utils import detector as jfd
from madsim_tpu_torch import interop
from madsim_tpu_torch.utils import detector as tfd

pytestmark = pytest.mark.usefixtures("one_cpu_thread")

FD_TICK = 1
N = 5
SEEDS = 8


def _monitored(pkg):
    """The reference test's Monitored program for `pkg`."""
    fd = jfd if pkg is J else tfd
    period, timeout = pkg.ms(50), pkg.ms(200)
    if pkg is J:
        import jax.numpy as jnp
        where = jnp.where
    else:
        where = torch.where

    class Monitored(pkg.Program):
        def init(self, ctx):
            st = dict(ctx.state)
            st = fd.reset(st, ctx.now)      # boot grace period
            ctx.set_timer(ctx.randint(0, period), FD_TICK)
            ctx.state = st

        def on_timer(self, ctx, tag, payload):
            st = dict(ctx.state)
            tick = tag == FD_TICK
            st = fd.saw(st, ctx.node, ctx.now, when=tick)    # self-refresh
            fd.beat(ctx, N, when=tick)
            t = tick[:, None] if pkg is P else tick
            st["fd_susp"] = where(t, fd.suspects(st, ctx.now, timeout),
                                  st["fd_susp"])
            ctx.set_timer(period, FD_TICK, when=tick)
            ctx.state = st

        def on_message(self, ctx, src, tag, payload):
            st = dict(ctx.state)
            st = fd.saw(st, src, ctx.now, when=tag == fd.TAG_HEARTBEAT)
            ctx.state = st

    return Monitored()


def _scenario(pkg, case):
    if case == "clean":
        return None, pkg.ms(600)
    sc = pkg.Scenario()
    sc.at(pkg.ms(500)).kill(2)
    if case == "kill":
        return sc, pkg.ms(1000)
    sc.at(pkg.ms(1000)).restart(2)
    return sc, pkg.ms(1500)


def _runtime(pkg, case, kw):
    fd = jfd if pkg is J else tfd
    sc, until = _scenario(pkg, case)
    cfg = pkg.SimConfig(n_nodes=N, event_capacity=160, time_limit=until,
                        net=pkg.NetConfig(packet_loss_rate=0.05))
    return pkg.Runtime(cfg, [_monitored(pkg)], fd.detector_state(N),
                       scenario=sc, **kw)


def test_heartbeats_match_reference():
    assert tfd.TAG_HEARTBEAT == jfd.TAG_HEARTBEAT


@pytest.mark.parametrize("case", ["clean", "kill", "restart"])
def test_detector_matches_reference(case):
    seeds = np.arange(SEEDS, dtype=np.uint32)
    with reference_stream():
        jrt = _runtime(J, case, {})
        s, _ = jrt.run(jrt.init_batch(seeds), 40_000, 256)
        ref = jax_leaves(s)
    rt = _runtime(P, case, dict(device="cpu"))
    t, _ = rt.run(rt.init_batch(seeds), 40_000, 256)
    got = interop.state_to_numpy(t)
    assert_same(ref, got, what=case)
    assert got[".halted"].all() and not got[".crashed"].any()
    susp = got[".node_state['fd_susp']"]
    alive = got[".alive"]
    if case == "kill":
        assert (~alive[:, 2]).all()
        others = [i for i in range(N) if i != 2]
        # every survivor suspects the victim, and nobody a live node
        assert (susp[:, others, 2] == 1).all()
        assert (susp[:, others][:, :, others] == 0).all()
    else:
        # clean, or the victim back: suspicion cleared everywhere
        assert alive.all()
        assert (susp == 0).all()
