"""The port's net layer (`net/rpc.py`, `net/service.py`) and the RPC echo
service (`models/rpc_echo.py`, BASELINE.md config 3) against the JAX
package (tolerance: zero), on the CPU.

Covers the rpc helpers and the service's method tags (the same hash of
the same `__qualname__`), a Service with two @rpc methods driven through
a whole run, the refusal of an @rpc_stream service whose state spec
lacks the streaming leaves, the three cases of the JAX package's tests/test_rpc_echo.py
(clean, 30% loss, a server kill and restart at 1 s, not 2 s), and config
3 as `workloads.echo_config3_runtime` builds it. The two-phase commit
and gossip models are in tests/test_torch_tpc_gossip.py. The JAX side
runs on the non-partitionable threefry stream (see _torch_parity).
"""

import numpy as np
import pytest
import torch

import madsim_tpu as J
import madsim_tpu_torch as P
from _torch_parity import (assert_same, jax_leaves, one_cpu_thread,  # noqa
                           reference_stream)
from madsim_tpu.models import rpc_echo as jecho
from madsim_tpu.net import rpc as jrpc
from madsim_tpu.net import service as jservice
from madsim_tpu_torch import interop, workloads
from madsim_tpu_torch.models import rpc_echo as techo
from madsim_tpu_torch.net import rpc as trpc
from madsim_tpu_torch.net import service as tservice

pytestmark = pytest.mark.usefixtures("one_cpu_thread")

SEEDS = np.arange(8, dtype=np.uint32)


# --------------------------------------------------------------------------
# rpc helpers and service tags
# --------------------------------------------------------------------------
def test_rpc_helpers_match_reference():
    tags = np.array([0, 1, 7, (1 << 29) - 1, (1 << 30) | 3], np.int32)
    assert trpc.REPLY_BIT == jrpc.REPLY_BIT
    for t in tags.tolist():
        assert trpc.reply_tag(t) == jrpc.reply_tag(t)
        assert trpc.is_reply(t) == jrpc.is_reply(t)
    got = trpc.is_reply(torch.as_tensor(tags)).numpy()
    want = np.asarray(jrpc.is_reply(tags))
    np.testing.assert_array_equal(got, want)
    pay = torch.tensor([[5, 1], [6, 2]], dtype=torch.int32)
    np.testing.assert_array_equal(
        trpc.matches(pay, torch.tensor([5, 5], dtype=torch.int32)).numpy(),
        [True, False])


@pytest.mark.parametrize("name", [
    "Counter.add", "Counter.get", "a", "", "Ünïcode.method",
    "x" * 300])
def test_method_tag_hash_matches_reference(name):
    assert tservice._hash33(name) == jservice._hash33(name)


def _counter_runtime(mod, svc, rpc, where, col, z, **kw):
    """A Service with two @rpc methods (the same __qualname__ in both
    packages) and a client calling them in turn, with retries, under
    loss. `where` and `col(payload, i)` are the package's select and
    payload column; `z` its int32 zero."""

    class Counter(svc.Service):
        @svc.rpc
        def add(self, ctx, st, payload, when):
            st["total"] = st["total"] + where(when, col(payload, 1), 0)
            return [st["total"], col(payload, 1)]

        @svc.rpc
        def get(self, ctx, st, payload, when):
            return [st["total"]]

    def next_call(ctx, st, cid, when):
        method = where(st["n"] % 2 == 0, Counter.add.tag, Counter.get.tag)
        rpc.call(ctx, 0, method, [st["n"] + ctx.node], cid,
                 retry_timer_tag=1, timeout=mod.ms(30), when=when)

    class Client(mod.Program):
        def init(self, ctx):
            st = dict(ctx.state)
            st["cid"] = rpc.new_call_id(ctx)
            next_call(ctx, st, st["cid"], True)
            ctx.state = st

        def on_timer(self, ctx, tag, payload):
            st = ctx.state
            next_call(ctx, st, st["cid"],
                      (col(payload, 0) == st["cid"]) & (st["n"] < 6))

        def on_message(self, ctx, src, tag, payload):
            st = dict(ctx.state)
            hit = rpc.is_reply(tag) & rpc.matches(payload, st["cid"])
            st["n"] = st["n"] + hit
            st["seen"] = where(hit, st["seen"] + col(payload, 1),
                               st["seen"])
            new_id = rpc.new_call_id(ctx)
            st["cid"] = where(hit, new_id, st["cid"])
            next_call(ctx, st, new_id, hit & (st["n"] < 6))
            ctx.state = st

    cfg = mod.SimConfig(n_nodes=3, time_limit=mod.sec(2),
                        net=mod.NetConfig(packet_loss_rate=0.2))
    return Counter, mod.Runtime(cfg, [Counter(), Client()],
                                dict(total=z, cid=z, n=z, seen=z),
                                node_prog=np.array([0, 1, 1], np.int32),
                                **kw)


def test_service_tags_and_dispatch_match_reference():
    """The method tags are the JAX package's for the same qualified name,
    and a Service under loss runs leaf for leaf as the reference's."""
    import jax.numpy as jnp
    with reference_stream():
        jc, jrt = _counter_runtime(J, jservice, jrpc, jnp.where,
                                   lambda p, i: p[i],
                                   jnp.asarray(0, jnp.int32))
        s, _ = jrt.run(jrt.init_batch(SEEDS[:4]), 256, 64)
        ref = jax_leaves(s)
    tc, trt = _counter_runtime(P, tservice, trpc, torch.where,
                               lambda p, i: p[:, i],
                               torch.tensor(0, dtype=torch.int32),
                               device="cpu")
    assert tc.add.__qualname__ == jc.add.__qualname__
    assert (tc.add.tag, tc.get.tag) == (jc.add.tag, jc.get.tag)
    assert [m.tag for m in tc()._handlers()] == \
        [m.tag for m in jc()._handlers()]
    t, _ = trt.run(trt.init_batch(SEEDS[:4]), 256, 64)
    got = interop.state_to_numpy(t)
    assert_same(ref, got, what="service")
    assert (got[".node_state['n']"][:, 1:] > 0).all()
    assert (got[".node_state['total']"][:, 0] > 0).all()


def test_a_streaming_service_is_refused():
    class Streamer(tservice.Service):
        @tservice.rpc
        def unary(self, ctx, st, payload, when):
            return [payload[:, 1]]

        @tservice.rpc_stream
        def upload(self, ctx, st, src, kind, call_id, body, when):
            pass

    assert Streamer.upload.tag == jservice._hash33(
        Streamer.upload.__qualname__) % (1 << 29)
    # the stream dispatch needs streaming_state(...) in the spec: without
    # it the service is refused when its handler first runs, as the JAX
    # package refuses it when its step is traced
    rt = P.Runtime(P.SimConfig(n_nodes=2), [Streamer()],
                   dict(x=torch.tensor(0, dtype=torch.int32)), device="cpu")
    with pytest.raises(AssertionError, match="streaming_state"):
        rt.run(rt.init_batch(SEEDS[:2]), 4, 4)


# --------------------------------------------------------------------------
# rpc_echo: the three cases of tests/test_rpc_echo.py, and config 3
# --------------------------------------------------------------------------
def _cfg(mod, loss=0.0, time_limit=None):
    return mod.SimConfig(n_nodes=6, event_capacity=256,
                         time_limit=time_limit or mod.sec(20),
                         net=mod.NetConfig(packet_loss_rate=loss,
                                           send_latency_min=mod.ms(1),
                                           send_latency_max=mod.ms(10)))


def _kill_restart(mod):
    sc = mod.Scenario()
    sc.at(mod.ms(20)).kill(0)
    sc.at(mod.sec(1)).restart(0)
    return sc


# case: (make args, max_steps, chunk): the JAX test's configs and seeds,
# but the server restarted at 1 s (the JAX test: 2 s), which halves the
# dead window's retries (the port's eager CPU step costs 20-40 ms, F24)
ECHO_CASES = {
    "clean": (lambda m: dict(target=10, cfg=_cfg(m)), 10_000, 64),
    "loss_30": (lambda m: dict(target=5, cfg=_cfg(m, loss=0.3)), 40_000,
                64),
    "kill_restart": (lambda m: dict(target=16, scenario=_kill_restart(m),
                                    cfg=_cfg(m)), 40_000, 128),
}


@pytest.mark.parametrize("case", sorted(ECHO_CASES))
def test_rpc_echo_matches_reference(case):
    args, max_steps, chunk = ECHO_CASES[case]
    with reference_stream():
        jrt = jecho.make_echo_runtime(n_nodes=6, **args(J))
        s, _ = jrt.run(jrt.init_batch(SEEDS), max_steps, chunk)
        ref = jax_leaves(s)
    rt = techo.make_echo_runtime(n_nodes=6, device="cpu", **args(P))
    t, _ = rt.run(rt.init_batch(SEEDS), max_steps, chunk)
    got = interop.state_to_numpy(t)
    assert_same(ref, got, what=f"rpc_echo {case}")
    target = args(P)["target"]
    acked = got[".node_state['acked']"]
    assert got[".halted"].all() and not got[".crashed"].any()
    assert (acked[:, 1:] >= target).all()
    if case == "kill_restart":
        # the dead window forced client retries past the restart (the
        # server's volatile `served` counter restarted with it)
        assert (got[".now"] > P.sec(1)).all()
    else:
        # at-least-once: retries mean the server served >= acked total
        assert (got[".node_state['served']"][:, 0] >= 5 * target).all()


def test_echo_config3_matches_reference():
    """BASELINE.md config 3 exactly as scripts/baseline_configs.py builds
    it (no halt_when: every lane runs to its 6 s limit)."""
    with reference_stream():
        sc = J.Scenario()
        sc.at(J.ms(300)).kill(0)
        sc.at(J.ms(700)).restart(0)
        cfg = J.SimConfig(n_nodes=3, event_capacity=48, time_limit=J.sec(6),
                          net=J.NetConfig(packet_loss_rate=0.1))
        jrt = J.Runtime(cfg, [jecho.EchoServer(),
                              jecho.EchoClient(target=10, timeout=J.ms(60))],
                        jecho.server_state_spec(), node_prog=[0, 1, 1],
                        scenario=sc)
        s, _ = jrt.run(jrt.init_batch(SEEDS), 20_000, 128)
        ref = jax_leaves(s)
    rt = workloads.echo_config3_runtime(device="cpu")
    assert rt.cfg.structural_signature() == cfg.structural_signature()
    t, _ = rt.run(rt.init_batch(SEEDS), 20_000, 128)
    got = interop.state_to_numpy(t)
    assert_same(ref, got, what="config 3")
    assert not got[".crashed"].any()
    assert (got[".node_state['acked']"][:, 1:] == 10).all()
    assert (got[".now"] == P.sec(6)).all()
