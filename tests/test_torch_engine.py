"""The port's engine against the JAX package, leaf for leaf (tolerance:
zero), on the CPU.

Covers the slice's main path — the batched 5-node Raft chaos sweep
(bench.py `_make_runtime`) and the golden pingpong workload — through the
port's public entry points: init_batch, run, run_single, inject,
set_time_limit, run_seeds, simtest, check_determinism and the interop
carry-over of a mid-run state; plus the handler and extension APIs, the
Raft invariant and `_apply_super` on every opcode. The JAX side runs on
the non-partitionable threefry stream (see _torch_parity).
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_same, jax_leaves, reference_stream
from madsim_tpu_torch import interop, workloads
from madsim_tpu_torch.harness.simtest import SimFailure, run_seeds

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "data", "golden_r22_leaves.json")


# --------------------------------------------------------------------------
# The flagship: bench.py's 5-node Raft chaos config at B=8 over 512 steps,
# two lanes with a nonzero PCT priority nudge.
# --------------------------------------------------------------------------
FLAG_B = 8
NUDGES = np.array([0, 12345, 0, 0, 0, -7, 0, 0], np.int32)


def _jax_flagship():
    import bench
    return bench._make_runtime()


@pytest.fixture(scope="module")
def flagship():
    seeds = np.arange(FLAG_B, dtype=np.uint32)
    with reference_stream():
        jrt = _jax_flagship()
        s = jrt.init_batch(seeds)
        s = s.replace(prio_nudge=jnp.asarray(NUDGES))
        ref = dict(init=jax_leaves(s))
        s, _ = jrt.run(s, 256, chunk=256)
        ref["mid"] = jax_leaves(s)
        s, _ = jrt.run(s, 256, chunk=256)
        ref["final"] = jax_leaves(s)
        ref["fp"] = jrt.fingerprints(s)
    # The port runs the first 256 steps from its own init_batch, and the
    # next 256 from the REFERENCE's step-256 state carried over by interop.
    # With the step-256 states equal leaf for leaf, that second half is the
    # port's own continuation too (the step is a pure function of state),
    # so one run checks both the full 512 steps and the carry-over.
    rt = workloads.flagship_runtime(device="cpu")
    t = rt.init_batch(seeds).replace(prio_nudge=torch.as_tensor(NUDGES))
    port = dict(init=interop.state_to_numpy(t))
    t, _ = rt.run(t, 256, chunk=256)
    port["mid"] = interop.state_to_numpy(t)
    t = interop.state_from_numpy(ref["mid"], "cpu")
    t, _ = rt.run(t, 256, chunk=256)
    port["final"] = interop.state_to_numpy(t)
    port["fp"] = rt.fingerprints(t)
    return dict(ref=ref, port=port)


def test_flagship_init_batch_matches(flagship):
    assert set(flagship["ref"]["init"]) == set(flagship["port"]["init"])
    assert_same(flagship["ref"]["init"], flagship["port"]["init"],
                what="init_batch")


def test_flagship_matches_reference_leaf_for_leaf(flagship):
    ref, port = flagship["ref"], flagship["port"]
    assert_same(ref["mid"], port["mid"], what="after 256 steps")
    assert_same(ref["final"], port["final"], what="after 512 steps")
    # a real chaos run: dispatching, no crash, no overflow, nudges live
    final = port["final"]
    assert (final[".steps"] == 512).all()
    assert not final[".crashed"].any() and not final[".oops"].any()
    assert (final[".prio_nudge"] != 0).sum() == 2


def test_flagship_resumes_from_reference_mid_state(flagship):
    """A JAX state taken at step 256, carried over with state_from_numpy
    and stepped 256 more by the port, ends where the JAX run ends, with
    the JAX package's fingerprints."""
    assert_same(flagship["ref"]["final"], flagship["port"]["final"],
                what="resumed from the reference's step-256 state")
    np.testing.assert_array_equal(flagship["port"]["fp"],
                                  flagship["ref"]["fp"])


@pytest.mark.slow
def test_flagship_b64_1024_steps_matches():
    seeds = np.arange(64, dtype=np.uint32)
    with reference_stream():
        jrt = _jax_flagship()
        s, _ = jrt.run(jrt.init_batch(seeds), 1024, chunk=256)
        ref = jax_leaves(s)
    rt = workloads.flagship_runtime(device="cpu")
    t, _ = rt.run(rt.init_batch(seeds), 1024, chunk=256)
    assert_same(ref, interop.state_to_numpy(t), what="B=64, 1024 steps")
    assert not ref[".crashed"].any() and not ref[".oops"].any()


# --------------------------------------------------------------------------
# Pingpong: the frozen golden workload, and a heavier chaos script that
# drives every fault op of the engine (pause/resume, clogs, one-way and
# two-way partitions, loss/latency, skew, slow disk, duplicate delivery).
# --------------------------------------------------------------------------
def _chaos_scenario(sc_mod, ms):
    sc = sc_mod.Scenario()
    sc.at(ms(2)).set_skew(1, 300)
    sc.at(ms(3)).set_disk(2, ms(2))
    sc.at(ms(4)).set_dup(1, 0.3)
    sc.at(ms(5)).pause_random()
    sc.at(ms(9)).resume_random()
    sc.at(ms(12)).clog_link(0, 1)
    sc.at(ms(14)).set_loss(0.2)
    sc.at(ms(20)).partition_oneway([0, 2], direction=1)
    sc.at(ms(25)).kill_random()
    sc.at(ms(31)).clog_node(3)
    sc.at(ms(36)).set_latency(ms(1), ms(4))
    sc.at(ms(40)).heal()
    sc.at(ms(45)).restart_random()
    sc.at(ms(50)).partition([1])
    sc.at(ms(60)).unclog_link(0, 1)
    sc.at(ms(70)).heal()
    return sc


def test_pingpong_chaos_matches_reference_leaf_for_leaf():
    import madsim_tpu as J
    import madsim_tpu.runtime.scenario as jsc
    from madsim_tpu.models.pingpong import PingPong, state_spec
    import madsim_tpu_torch as P
    import madsim_tpu_torch.runtime.scenario as tsc
    from madsim_tpu_torch.models import pingpong as tpp
    net = dict(packet_loss_rate=0.1, send_latency_min=J.ms(1),
               send_latency_max=J.ms(3), op_jitter_max=20)
    jcfg = J.SimConfig(n_nodes=4, time_limit=J.sec(2),
                       net=J.NetConfig(**net))
    tcfg = P.SimConfig(n_nodes=4, time_limit=P.sec(2),
                       net=P.NetConfig(**net))
    seeds = np.arange(48, dtype=np.uint32)
    with reference_stream():
        jrt = J.Runtime(jcfg, [PingPong(4, target=40)], state_spec(),
                        scenario=_chaos_scenario(jsc, J.ms))
        init = jax_leaves(jrt.init_batch(seeds))
        s, _ = jrt.run(jrt.init_batch(seeds), 128, chunk=64)
        ref = jax_leaves(s)
    trt = P.Runtime(tcfg, [tpp.PingPong(4, target=40)], tpp.state_spec(),
                    scenario=_chaos_scenario(tsc, P.ms), device="cpu")
    assert_same(init, interop.state_to_numpy(trt.init_batch(seeds)),
                what="chaos init_batch")
    t, _ = trt.run(trt.init_batch(seeds), 128, chunk=64)
    got = interop.state_to_numpy(t)
    assert_same(ref, got, what="chaos after 128 steps")
    # the script really exercised the fault planes
    assert got[".msg_dropped"].sum() > 0
    assert (got[".skew"] != 0).any() and (got[".disk_lat"] != 0).any()


def test_pingpong_matches_frozen_golden_digests():
    """The frozen golden pingpong run (64 seeds, 4000 steps, chunk 256):
    every engine leaf's digest equals tests/data/golden_r22_leaves.json.
    The 13 flight-recorder and lineage leaves are skipped: the golden run
    had the recorder compiled in, the port has it out."""
    with open(GOLDEN) as f:
        golden = json.load(f)["pingpong"]["run"]
    from _grayfail_golden import build_pingpong
    p = workloads.PINGPONG_RUN
    seeds = np.arange(p["seeds"], dtype=np.uint32)
    rt = workloads.pingpong_runtime(device="cpu")
    # workloads.pingpong_runtime is build_pingpong with the recorder out
    with reference_stream():
        ref_init = jax_leaves(
            build_pingpong().derived(trace_cap=0).init_batch(seeds))
    assert_same(ref_init, interop.state_to_numpy(rt.init_batch(seeds)),
                what="golden pingpong init_batch")
    s, _ = rt.run(rt.init_batch(seeds), p["max_steps"], p["chunk"])
    got = interop.leaf_digests(s)
    engine = [k for k in golden if k not in workloads.RECORDER_LEAVES]
    assert len(engine) == 67 and len(golden) - len(engine) == 13
    bad = [k for k in engine if got.get(k) != golden[k]]
    assert not bad, f"golden digests differ for {bad}"


def test_injection_matches_reference():
    """Host-injected kill / restart / pause / resume / clog_link / heal
    between chunks, on both sides."""
    import madsim_tpu as J
    from madsim_tpu.models.pingpong import PingPong, state_spec
    import madsim_tpu_torch as P
    from madsim_tpu_torch.models import pingpong as tpp
    seeds = np.arange(16, dtype=np.uint32)
    ops = [("kill", (1,)), ("clog_link", (0, 2)), ("restart", (1,)),
           ("pause", (3,)), ("heal", ()), ("resume", (3,))]
    with reference_stream():
        jrt = J.Runtime(J.SimConfig(n_nodes=4, time_limit=J.sec(5)),
                        [PingPong(4, target=1000)], state_spec())
        s = jrt.init_batch(seeds)
        ref = []
        for name, args in ops:
            s, _ = jrt.run(s, 6, chunk=6)
            s = getattr(jrt, name)(s, *args)
            ref.append(jax_leaves(s))
    trt = P.Runtime(P.SimConfig(n_nodes=4, time_limit=P.sec(5)),
                    [tpp.PingPong(4, target=1000)], tpp.state_spec(),
                    device="cpu")
    t = trt.init_batch(seeds)
    for (name, args), want in zip(ops, ref):
        t, _ = trt.run(t, 6, chunk=6)
        t = getattr(trt, name)(t, *args)
        assert_same(want, interop.state_to_numpy(t), what=f"after {name}")


def test_time_limit_net_override_and_event_trace_match_reference():
    """set_time_limit, a network override and run_single's event trace."""
    import madsim_tpu as J
    import madsim_tpu.harness.simtest as jst
    from madsim_tpu.models.pingpong import PingPong, state_spec
    import madsim_tpu_torch as P
    from madsim_tpu_torch.harness.simtest import apply_net_override
    from madsim_tpu_torch.models import pingpong as tpp
    seeds = np.arange(16, dtype=np.uint32)
    net = dict(packet_loss_rate=0.25, send_latency_min=J.ms(2),
               send_latency_max=J.ms(9))
    with reference_stream():
        jrt = J.Runtime(J.SimConfig(n_nodes=4, time_limit=J.sec(5)),
                        [PingPong(4, target=1000)], state_spec())
        s = jst.apply_net_override(jrt.init_batch(seeds),
                                   J.NetConfig(**net))
        s = jrt.set_time_limit(s, J.ms(30))
        s, _ = jrt.run(s, 240, chunk=6)
        ref = jax_leaves(s)
        _, jev = jrt.run_single(5, 36, chunk=6)
    trt = P.Runtime(P.SimConfig(n_nodes=4, time_limit=P.sec(5)),
                    [tpp.PingPong(4, target=1000)], tpp.state_spec(),
                    device="cpu")
    t = apply_net_override(trt.init_batch(seeds), P.NetConfig(**net))
    t = trt.set_time_limit(t, P.ms(30))
    t, _ = trt.run(t, 240, chunk=6)
    assert_same(ref, interop.state_to_numpy(t), what="time limit + net")
    assert ref[".halted"].all()
    _, tev = trt.run_single(5, 36, chunk=6)
    assert sorted(tev) == sorted(jev)
    for k in jev:
        np.testing.assert_array_equal(tev[k], np.asarray(jev[k]),
                                      err_msg=f"event field {k}")


def test_extension_hooks_match_reference():
    """An extension's state, custom scheduled op, per-event hook and
    node-reset hook (the JAX suite's PowerMeter, and its batched port)."""
    import madsim_tpu as J
    from madsim_tpu.models.pingpong import PingPong, state_spec
    from test_extension import OP_SET_BUDGET, PowerMeter
    import madsim_tpu_torch as P
    from madsim_tpu_torch.core import types as TT
    from madsim_tpu_torch.models import pingpong as tpp
    from madsim_tpu_torch.ops.select import put_row, take1

    class PortPowerMeter(P.Extension):
        name = "power"

        def __init__(self, n):
            self.n = n

        def state(self, cfg):
            return dict(used=torch.zeros(self.n, dtype=torch.int32),
                        budget=torch.full((self.n,), 10 ** 9,
                                          dtype=torch.int32))

        def on_op(self, cfg, sub, op, target, src, payload, key):
            t = torch.clamp(target, 0, self.n - 1)
            return dict(sub, budget=put_row(sub["budget"], t,
                                            payload[:, 0],
                                            op == OP_SET_BUDGET))

        def on_event(self, cfg, sub, state, record):
            n = torch.clamp(record["node"], 0, self.n - 1)
            hit = record["fired"] & (record["kind"] != TT.EV_SUPER)
            return dict(sub, used=put_row(sub["used"], n,
                                          take1(sub["used"], n) + 1, hit))

        def reset_node(self, cfg, sub, node, when):
            n = torch.clamp(node, 0, self.n - 1)
            return dict(sub, used=put_row(sub["used"], n, 0, when))

    def scenario(mod):
        sc = mod.Scenario()
        sc.at(mod.ms(1)).custom(OP_SET_BUDGET, node=1, payload=(777,))
        sc.at(mod.ms(30)).kill(2)
        sc.at(mod.ms(60)).restart(2)
        return sc

    seeds = np.arange(8, dtype=np.uint32)
    with reference_stream():
        jrt = J.Runtime(J.SimConfig(n_nodes=3, time_limit=J.sec(2)),
                        [PingPong(3, target=30)], state_spec(),
                        scenario=scenario(J), extensions=[PowerMeter(3)])
        s, _ = jrt.run(jrt.init_batch(seeds), 128, chunk=128)
        ref = jax_leaves(s)
    trt = P.Runtime(P.SimConfig(n_nodes=3, time_limit=P.sec(2)),
                    [tpp.PingPong(3, target=30)], tpp.state_spec(),
                    scenario=scenario(P), extensions=[PortPowerMeter(3)],
                    device="cpu")
    t, _ = trt.run(trt.init_batch(seeds), 128, chunk=128)
    got = interop.state_to_numpy(t)
    assert_same(ref, got, what="with an extension")
    assert (got[".ext['power']['budget']"][:, 1] == 777).all()
    assert got[".ext['power']['used']"].sum() > 0


def _sink_programs():
    """The same small protocol written for both packages, exercising the
    handler API the models above leave out: bernoulli, uniform, the
    per-node hash stream, cancel_timer and defer."""
    from madsim_tpu import Program as JProgram
    from madsim_tpu_torch import Program as TProgram

    class JSink(JProgram):
        def init(self, ctx):
            ctx.set_timer(ctx.randint(0, 500), 1)
            ctx.set_timer(10_000, 2)

        def on_timer(self, ctx, tag, payload):
            st = dict(ctx.state)
            coin = ctx.bernoulli(0.5)
            low = ctx.uniform() < 0.25
            h = ctx.hash_randint(0, 1000)
            st["acc"] = st["acc"] + coin + low + h
            ctx.cancel_timer(2, when=tag == 1)
            ctx.send((ctx.node + 1) % 3, 5, [st["acc"]], when=coin)
            ctx.defer(3, [h], when=tag == 1)
            ctx.set_timer(ctx.randint(100, 900), 1, when=tag == 1)
            ctx.state = st

        def on_message(self, ctx, src, tag, payload):
            st = dict(ctx.state)
            st["got"] = st["got"] + payload[0]
            ctx.set_timer(50, 2)
            ctx.state = st

    class TSink(TProgram):
        def init(self, ctx):
            ctx.set_timer(ctx.randint(0, 500), 1)
            ctx.set_timer(10_000, 2)

        def on_timer(self, ctx, tag, payload):
            st = dict(ctx.state)
            coin = ctx.bernoulli(0.5)
            low = ctx.uniform() < 0.25
            h = ctx.hash_randint(0, 1000)
            st["acc"] = st["acc"] + coin + low + h
            ctx.cancel_timer(2, when=tag == 1)
            ctx.send((ctx.node + 1) % 3, 5, [st["acc"]], when=coin)
            ctx.defer(3, [h], when=tag == 1)
            ctx.set_timer(ctx.randint(100, 900), 1, when=tag == 1)
            ctx.state = st

        def on_message(self, ctx, src, tag, payload):
            st = dict(ctx.state)
            st["got"] = st["got"] + payload[:, 0]
            ctx.set_timer(50, 2)
            ctx.state = st

    return JSink(), TSink()


def test_handler_api_matches_reference():
    """Also runs the narrow event table (table_dtype="int16", CPU only:
    the CUDA select kernel takes int32 tables)."""
    import madsim_tpu as J
    import madsim_tpu_torch as P
    jprog, tprog = _sink_programs()
    seeds = np.arange(16, dtype=np.uint32)
    with reference_stream():
        spec = dict(acc=jnp.int32(0), got=jnp.int32(0))
        jrt = J.Runtime(J.SimConfig(n_nodes=3, time_limit=J.sec(5),
                                    table_dtype="int16"), [jprog], spec)
        s, _ = jrt.run(jrt.init_batch(seeds), 96, chunk=96)
        ref = jax_leaves(s)
    spec = dict(acc=torch.tensor(0, dtype=torch.int32),
                got=torch.tensor(0, dtype=torch.int32))
    trt = P.Runtime(P.SimConfig(n_nodes=3, time_limit=P.sec(5),
                                table_dtype="int16"), [tprog], spec,
                    device="cpu")
    t, _ = trt.run(trt.init_batch(seeds), 96, chunk=96)
    got = interop.state_to_numpy(t)
    assert_same(ref, got, what="handler API program")
    assert (got[".node_state['got']"] != 0).any()
    assert got[".t_kind"].dtype == np.int16


class _Crashy:
    """pingpong whose node 0 asserts after two acknowledged pongs."""

    @staticmethod
    def build(mod, pp):
        class Crashy(pp.PingPong):
            def on_message(self, ctx, src, tag, payload):
                super().on_message(ctx, src, tag, payload)
                ctx.crash_if((ctx.node == 0) & (ctx.state["acked"] >= 2), 7)
        return mod.Runtime(mod.SimConfig(n_nodes=3, time_limit=mod.sec(2)),
                           [Crashy(3, target=5)], pp.state_spec(),
                           **({"device": "cpu"} if mod.__name__
                              == "madsim_tpu_torch" else {}))


def test_run_seeds_raises_sim_failure_with_repro_line():
    import madsim_tpu as J
    import madsim_tpu.harness.simtest as jst
    from madsim_tpu.models import pingpong as jpp
    import madsim_tpu_torch as P
    from madsim_tpu_torch.models import pingpong as tpp
    seeds = np.arange(5, 13, dtype=np.uint32)
    with reference_stream():
        with pytest.raises(jst.SimFailure) as jexc:
            jst.run_seeds(_Crashy.build(J, jpp), seeds, 512, chunk=64)
    with pytest.raises(SimFailure) as texc:
        run_seeds(_Crashy.build(P, tpp), seeds, 512, chunk=64)
    assert "MADSIM_TEST_SEED=" in str(texc.value)
    assert (texc.value.seed, texc.value.code, texc.value.node) == \
        (jexc.value.seed, jexc.value.code, jexc.value.node)
    assert texc.value.code == 7


def test_simtest_decorator_reports_the_crash():
    import madsim_tpu_torch as P
    from madsim_tpu_torch.harness.simtest import simtest
    from madsim_tpu_torch.models import pingpong as tpp

    @simtest(num_seeds=4, max_steps=256, seed=5, chunk=64)
    def crashy():
        return _Crashy.build(P, tpp)

    @simtest(num_seeds=4, max_steps=256, seed=5, chunk=64)
    def green():
        return P.Runtime(P.SimConfig(n_nodes=3, time_limit=P.sec(2)),
                         [tpp.PingPong(3, target=3)], tpp.state_spec(),
                         device="cpu")

    with pytest.raises(SimFailure, match="MADSIM_TEST_SEED=5"):
        crashy()
    assert bool(green().halted.all())


def test_check_determinism_holds():
    rt = workloads.flagship_runtime(device="cpu")
    assert rt.check_determinism(3, 64, chunk=64)


def test_raft_invariant_matches_reference_at_wrap_boundaries():
    """State Machine Safety evaluates an int32 wraparound digest chain with
    cumsum (torch widens it to int64): on random node states with large
    log values, both invariant forms give the JAX verdicts."""
    from madsim_tpu.models import raft as jraft
    from madsim_tpu_torch.models import raft as traft
    rng = np.random.default_rng(9)
    Bn, N, L = 64, 5, 8
    commit = rng.integers(0, L + 1, (Bn, N)).astype(np.int32)
    ns = dict(
        role=rng.integers(0, 3, (Bn, N)).astype(np.int32),
        term=rng.integers(0, 3, (Bn, N)).astype(np.int32),
        snap_len=np.zeros((Bn, N), np.int32),
        log_len=np.maximum(commit, rng.integers(0, L + 1, (Bn, N))).astype(
            np.int32),
        commit=commit,
        snap_digest=rng.integers(-2 ** 31, 2 ** 31 - 1, (Bn, N)).astype(
            np.int32),
        log_term=rng.integers(2 ** 30, 2 ** 31 - 1, (Bn, N, L)).astype(
            np.int32),
        log_cmd=rng.integers(-2 ** 31, 2 ** 31 - 1, (Bn, N, L)).astype(
            np.int32))
    # half the lanes agree on their committed prefixes
    ns["log_term"][::2] = ns["log_term"][::2, :1]
    ns["log_cmd"][::2] = ns["log_cmd"][::2, :1]
    ns["snap_digest"][::2] = ns["snap_digest"][::2, :1]

    class St:
        def __init__(self, node_state, now):
            self.node_state, self.now = node_state, now

    for slides in (False, True):
        jinv = jraft.raft_invariant(N, L, window_slides=slides)
        jbad, jcode = jax.vmap(lambda d: jinv(St(d, None)))(
            {k: jnp.asarray(v) for k, v in ns.items()})
        tinv = traft.raft_invariant(N, L, window_slides=slides)
        tbad, tcode = tinv(St({k: torch.as_tensor(v) for k, v in ns.items()},
                              torch.zeros(Bn)))
        np.testing.assert_array_equal(tbad.numpy(), np.asarray(jbad))
        np.testing.assert_array_equal(tcode.numpy(), np.asarray(jcode))
        assert 0 < tbad.sum() < Bn


def test_apply_super_matches_reference_on_every_opcode():
    """The supervisor op (ROADMAP K3; on CPU tensors `apply_super` takes
    its plain version) on random batched states, with every
    opcode, NODE_RANDOM pools, and a node-state schema that carries the
    fs and conn/stream leaves, so the torn-write flush and the reset-peer
    tear run too."""
    from madsim_tpu.core import state as jst
    from madsim_tpu.core import step as jstep
    from madsim_tpu.core import types as JT
    from madsim_tpu_torch.ops.apply_super import SuperPlan, apply_super
    N, F, S, W, Bn = 5, 2, 6, 3, 96
    cfg = JT.SimConfig(n_nodes=N, event_capacity=16, payload_words=4)
    shapes = dict(fs_mem=(F, S), fs_mlen=(F,), fs_disk=(F, S), fs_dlen=(F,),
                  cn_state=(N,), cn_epoch=(N,), sx_seq=(N,), sx_base=(N,),
                  sx_val=(N, W), sr_next=(N,), sr_val=(N, W),
                  sr_have=(N, W), st_epoch=(N,), x=())
    persist = {k: k in ("fs_disk", "fs_dlen", "x") for k in shapes}
    rng = np.random.default_rng(11)

    def spec_value(k, shape):
        dt = bool if k == "sr_have" else np.int32
        return rng.integers(0, 2 if dt is bool else 9, shape).astype(dt)

    spec = {k: spec_value(k, v) for k, v in shapes.items()}
    with reference_stream():
        template = jst.init_state(
            cfg, jnp.zeros(2, jnp.uint32),
            {k: jnp.broadcast_to(jnp.asarray(v), (N,) + v.shape)
             for k, v in spec.items()})
    leaves = {k: np.broadcast_to(v, (Bn,) + v.shape).copy()
              for k, v in jax_leaves(template).items()}
    for k in list(leaves):
        a = leaves[k]
        if k.startswith(".node_state"):
            if a.dtype == bool:
                leaves[k] = rng.random(a.shape) < 0.5
            elif "len" in k:
                leaves[k] = rng.integers(0, S + 1, a.shape).astype(a.dtype)
            else:
                leaves[k] = rng.integers(-50, 50, a.shape).astype(a.dtype)
    leaves[".node_state['fs_mlen']"] = np.maximum(
        leaves[".node_state['fs_mlen']"], leaves[".node_state['fs_dlen']"])
    for k in (".alive", ".paused", ".clog_node", ".torn"):
        leaves[k] = rng.random(leaves[k].shape) < 0.5
    leaves[".clog_link"] = rng.random(leaves[".clog_link"].shape) < 0.3
    leaves[".t_kind"] = rng.integers(0, 4, leaves[".t_kind"].shape).astype(
        np.int32)
    leaves[".t_node"] = rng.integers(0, N, leaves[".t_node"].shape).astype(
        np.int32)
    op = rng.integers(0, 20, Bn).astype(np.int32)
    node = rng.integers(-1, N, Bn).astype(np.int32)
    src = rng.integers(-1, N + 1, Bn).astype(np.int32)
    payload = rng.integers(0, 2 ** 12, (Bn, 4)).astype(np.int32)
    payload[::3, 0] = 0                       # no pool: every node a target
    keys = rng.integers(-2 ** 31, 2 ** 31 - 1, (Bn, 2)).astype(np.int32)

    with reference_stream():
        treedef = jax.tree.structure(template)
        order = [k for k in jax_leaves(template)]
        batched = jax.tree.unflatten(treedef, [jnp.asarray(leaves[k])
                                               for k in order])
        spec_j = {k: jnp.asarray(v) for k, v in spec.items()}
        out = jax.vmap(lambda s, o, n, c, p, k: jstep._apply_super(
            cfg, spec_j, persist, s, o, n, c, p, k))(
                batched, op, node, src, payload, keys.view(np.uint32))
        ref_state = jax_leaves(out[0])
        ref_rest = [np.asarray(x) for x in out[1:]]
    port = interop.state_from_numpy(leaves, "cpu")
    spec_t = {k: torch.as_tensor(v) for k, v in spec.items()}
    t_out = apply_super(
        SuperPlan(cfg, spec_t, persist), port, torch.as_tensor(op),
        torch.as_tensor(node), torch.as_tensor(src),
        torch.as_tensor(payload), torch.as_tensor(keys))
    assert_same(ref_state, interop.state_to_numpy(t_out[0]),
                what="_apply_super state")
    for name, r, t in zip(("init_node", "target", "reset_mask"), ref_rest,
                          t_out[1:]):
        np.testing.assert_array_equal(t.numpy(), r, err_msg=name)
    # the draw really covered torn flushes and reset-peer tears
    flushed = (interop.state_to_numpy(t_out[0])[".node_state['fs_dlen']"]
               != leaves[".node_state['fs_dlen']"])
    assert flushed.any()
    assert (op == JT.OP_RESET_PEER).any() and (op == JT.OP_KILL).any()


# --------------------------------------------------------------------------
# The package boundary
# --------------------------------------------------------------------------
def test_import_pulls_in_no_jax_and_no_reference_package():
    code = ("import sys, madsim_tpu_torch, madsim_tpu_torch.workloads, "
            "madsim_tpu_torch.interop, madsim_tpu_torch.harness.simtest, "
            "madsim_tpu_torch.search, madsim_tpu_torch.parallel.explore, "
            "madsim_tpu_torch.parallel.stats, madsim_tpu_torch.ops.kernels"
            "\n"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith("
            "('jax.', 'jaxlib', 'madsim_tpu.')) or m == 'madsim_tpu']\n"
            "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_runtime_runs_on_cuda_unless_cpu_is_asked_for():
    import madsim_tpu_torch as P
    from madsim_tpu_torch.models import pingpong as tpp
    cfg = P.SimConfig(n_nodes=2)
    if torch.cuda.is_available():
        rt = P.Runtime(cfg, [tpp.PingPong(2)], tpp.state_spec())
        assert rt.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            P.Runtime(cfg, [tpp.PingPong(2)], tpp.state_spec())
    rt = P.Runtime(cfg, [tpp.PingPong(2)], tpp.state_spec(), device="cpu")
    assert rt.init_batch([1]).now.device.type == "cpu"


@pytest.mark.parametrize("field,value", [
    ("profile", True), ("latency_hist", 4), ("sketch_slots", 2),
    ("series_windows", 2), ("span_attr", True)])
def test_unported_planes_are_refused(field, value):
    import madsim_tpu_torch as P
    from madsim_tpu_torch.models import pingpong as tpp
    # the span plane needs the latency plane and completion kinds with it
    needs = (dict(latency_hist=4, complete_kinds=((P.EV_MSG, 1),))
             if field == "span_attr" else {})
    cfg = P.SimConfig(n_nodes=2, **{field: value}, **needs)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        P.Runtime(cfg, [tpp.PingPong(2)], tpp.state_spec(), device="cpu")


