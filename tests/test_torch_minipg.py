"""The port's minipg (`models/minipg.py`), the connection-fault workloads
over it (`workloads.connfault_runtime`) and the gray-failure workloads
(`workloads.grayfail_runtime`) against the JAX package (tolerance:
zero), on the CPU.

  * minipg clean (`make_minipg_runtime()`), with `wrong_password=True`,
    and bench.py's connfault `mix` recipe with the incarnation guards off
    (the red control) and on: 2 seeds each (JAX's tests/test_minipg.py
    and test_connfault.py run 8-48 to the halt), through `run` for 32
    steps and `run_fused` from there to a cap of 96 (128 with the wrong
    password), the connfault cases from the reference's state at step 32
    (carried over by `interop`; the port's eager CPU step costs ~90 ms
    here: ROADMAP F24), leaf for leaf against the reference's `run` to
    the same step; and seed 76, which crashes with 403 under the mix
    WITH the guards (298 of seeds 0-16,383 do, in the JAX package and on
    the card alike; the reference's tests run 48 seeds): the port takes
    over 32 steps before the crash and crashes the same way;
  * tests/test_connfault.py's TestResetPeer on the same inputs (minipg of
    50 txns, a reset_peer or a kill of the server at 400 ms, the halt at
    401 ms; 8 seeds): the reference runs to a step before the fault, the
    state crosses to the port (`interop`), the port runs to the halt,
    equal to the reference leaf for leaf, and the reference test's
    assertions hold on the port's state; and its inert case (a model
    without conn/stream leaves under reset_peer_random, 8 seeds);
  * `apply_super_plain` against the JAX package's `_apply_super` on
    minipg's own schema (5-d stream rings, 32 leaves), every opcode and
    OP_RESET_PEER lanes at every node;
  * bench.py's grayfail `mix` and `torn` recipes (Percolator-lite on 5
    nodes under group commit), 2 seeds: the reference to step 192 / 128,
    the port from there through the recipe's torn-write kill of shard 1
    to step 320 / 224 (the fs leaves after the flush held leaf for
    leaf). JAX's tests/test_grayfail.py runs 24-32 seeds to the halt.

Each reference run (a minipg configuration's step costs ~35 s of XLA to
compile on the CPU) is recorded in tests/data/test_torch_minipg_golden.npz
(tests/_torch_golden.py writes it): the tier-1 tests hold the port to that
recording, and the `slow` test_golden_is_the_jax_packages_output[case]
runs the JAX package again, case by case, and holds it to the recording.
The JAX side runs on the non-partitionable threefry stream (see
_torch_parity).

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_minipg.py -q
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import madsim_tpu as J
import madsim_tpu_torch as P
from _torch_parity import (assert_golden_is_reference, assert_same,  # noqa
                           golden, jax_leaves, one_cpu_thread,
                           reference_stream)
from madsim_tpu.models import minipg as jm
from madsim_tpu_torch import interop, workloads
from madsim_tpu_torch.core import types as T
from madsim_tpu_torch.models import minipg as tm
from madsim_tpu_torch.net import conn as tconn
from madsim_tpu_torch.ops.apply_super import apply_super

pytestmark = pytest.mark.usefixtures("one_cpu_thread")

MODULE = "test_torch_minipg"
SEEDS = np.arange(2, dtype=np.uint32)
EAGER_STEPS = 32      # through run, then run_fused to the case's cap
CHUNK = 32


def _clean(pkg):
    mod = tm if pkg is P else jm
    kw = dict(device="cpu") if pkg is P else {}
    return mod.make_minipg_runtime(**kw)


def _wrong(pkg):
    mod = tm if pkg is P else jm
    kw = dict(device="cpu") if pkg is P else {}
    return mod.make_minipg_runtime(wrong_password=True, **kw)


def _connfault(guard):
    def make(pkg):
        if pkg is P:
            return workloads.connfault_runtime("mix", guard=guard,
                                               device="cpu")
        import bench
        return bench._make_connfault_runtime("mix", guard=guard)
    return make


# case: (builder, step cap, the reference's steps the port takes over at:
# the connfault cases start from the reference's state after the
# handshakes, so that the port's share is the reset and dup storm)
CASES = {"clean": (_clean, 96, 0), "wrong_password": (_wrong, 128, 0),
         "connfault_mix_unguarded": (_connfault(False), 96, 32),
         "connfault_mix_guarded": (_connfault(True), 96, 32)}


def _minipg_reference(case):
    """{"ref": the reference's leaves at the case's cap, "mid": at the
    step the port takes over (the connfault cases), and for the guarded
    mix the crash of GUARDED_CRASH_SEED: "crash_ref" and "crash_mid"}."""
    make, cap, prefix = CASES[case]
    with reference_stream():
        jrt = make(J)
        out = {"ref": jax_leaves(jrt.run(jrt.init_batch(SEEDS), cap,
                                         CHUNK)[0])}
        if prefix:
            out["mid"] = jax_leaves(jrt.run(jrt.init_batch(SEEDS), prefix,
                                            CHUNK)[0])
        if case == "connfault_mix_guarded":
            seeds = np.full(2, GUARDED_CRASH_SEED, dtype=np.uint32)
            ref = jax_leaves(jrt.run(jrt.init_batch(seeds), 8192, CHUNK)[0])
            k = (int(ref[".steps"].min()) - 32) // CHUNK * CHUNK
            out["crash_ref"] = ref
            out["crash_mid"] = jax_leaves(jrt.run(jrt.init_batch(seeds), k,
                                                  CHUNK)[0])
    return out


@pytest.mark.parametrize("case", sorted(CASES))
def test_minipg_matches_reference(case):
    make, cap, prefix = CASES[case]
    rec = golden(MODULE, case)
    rt = make(P)
    t = (interop.state_from_numpy(rec["mid"], "cpu") if prefix
         else rt.init_batch(SEEDS))
    t, _ = rt.run(t, EAGER_STEPS, CHUNK)
    t = rt.run_fused(t, cap - prefix - EAGER_STEPS, chunk=CHUNK)
    got = interop.state_to_numpy(t)
    assert_same(rec["ref"], got, what=case)
    assert got[".node_state['sx_val']"].shape[2:] == (3, 8, tm.FRAME_WORDS)
    if case == "wrong_password":
        # the refusal path: ERROR / RST, never READY, both clients done
        assert got[".halted"].all() and not got[".crashed"].any()
        assert (got[".node_state['c_rej']"][:, 1:] == 1).all()
        assert (got[".node_state['c_phase']"][:, 1:] < 3).all()
    elif case == "clean":
        # by the cap: the sessions are up and queries flow
        assert (got[".node_state['c_phase']"][:, 1:] == 3).all()
        assert (got[".node_state['sess']"][:, 0, 1:] == tm.S_READY).all()
    else:
        # the reset storm started at 30 ms: incarnations moved past 0
        assert (got[".node_state['cn_epoch']"][:, 0, 1:] > 0).all()
    if case == "connfault_mix_guarded":
        _guarded_crash_matches_reference(make, rec)


# seed 76 is the first of the 298 of 0-16,383 whose lane crashes with 403
# (CRASH_VISIBILITY) under the connfault mix WITH the incarnation guards,
# in the JAX package (on the reference stream) and on the card alike; the
# reference's tests run 48 seeds, which miss them
GUARDED_CRASH_SEED = 76


def _guarded_crash_matches_reference(make, rec):
    """The reference ran seed GUARDED_CRASH_SEED (twice, at the batch its
    parity run compiled) to its crash; the port takes over 32 steps before
    it and must crash the same way, leaf for leaf."""
    ref, mid = rec["crash_ref"], rec["crash_mid"]
    assert ref[".crashed"].all() and not mid[".crashed"].any()
    assert (ref[".crash_code"] == tm.CRASH_VISIBILITY).all()
    rt = make(P)
    t = rt.run_fused(interop.state_from_numpy(mid, "cpu"), 8192,
                     chunk=CHUNK)
    assert_same(ref, interop.state_to_numpy(t), what="guarded crash")


# --------------------------------------------------------------------------
# tests/test_connfault.py TestResetPeer, on the same inputs
# --------------------------------------------------------------------------
RESET_SEEDS = np.arange(8, dtype=np.uint32)


def _reset_rt(pkg, reset):
    sc = pkg.Scenario()
    if reset:
        sc.at(pkg.ms(400)).reset_peer(0)
    else:
        sc.at(pkg.ms(400)).kill(0)
    sc.at(pkg.ms(401)).halt()      # sample before watchdog recovery
    if pkg is P:
        return tm.make_minipg_runtime(n_clients=2, n_txns=50, scenario=sc,
                                      device="cpu")
    return jm.make_minipg_runtime(n_clients=2, n_txns=50, scenario=sc)


def _reset_reference(reset):
    """{"mid": the reference's last state (in chunks of 8 steps) with
    every lane short of the 400 ms fault, "ref": its state at the halt}."""
    chunk = 8
    with reference_stream():
        jrt = _reset_rt(J, reset)
        s, _ = jrt.run(jrt.init_batch(RESET_SEEDS), 640, chunk)
        mid = jax_leaves(s)
        while True:
            s, _ = jrt.run(s, chunk, chunk)
            nxt = jax_leaves(s)
            if (nxt[".now"] >= P.ms(400)).any():
                break
            mid = nxt
        ref = jax_leaves(jrt.run(s, 20_000, chunk)[0])
    return {"mid": mid, "ref": ref}


def test_reset_peer_tears_both_sides_kill_leaves_half_open():
    """Both of TestResetPeer's runs: the port takes over the reference's
    last state short of the fault and runs it to the halt."""
    for reset in (True, False):
        rec = golden(MODULE, "reset_peer" if reset else "kill")
        mid = rec["mid"]
        assert (mid[".now"] < P.ms(400)).all() and not mid[".halted"].any()
        rt = _reset_rt(P, reset)
        t = rt.run_fused(interop.state_from_numpy(mid, "cpu"), 20_000,
                         chunk=8)
        got = interop.state_to_numpy(t)
        assert_same(rec["ref"], got, what="reset" if reset else "kill")
        assert got[".halted"].all()
        cn = got[".node_state['cn_state']"]
        ep = got[".node_state['cn_epoch']"]
        sx = got[".node_state['sx_seq']"]
        if reset:
            assert (cn[:, 0, 1:] == tconn.CLOSED).all()
            assert (cn[:, 1:, 0] == tconn.CLOSED).all()
            assert (ep[:, 0, 1:] >= 1).all() and (ep[:, 1:, 0] >= 1).all()
            assert (sx[:, 0, 1:] == 0).all()
            assert (sx[:, 1:, 0] <= 1).all()
        else:
            # the survivors keep ESTABLISHED state toward the corpse
            assert (cn[:, 1:, 0] == tconn.ESTABLISHED).any()


class CountPing(P.Program):
    """tests/test_connfault.py's _CountPing on the port."""

    def init(self, ctx):
        ctx.set_timer(P.ms(2), 1, [0], when=ctx.node == 0)

    def on_timer(self, ctx, tag, payload):
        ctx.send(1, 7, [0])

    def on_message(self, ctx, src, tag, payload):
        st = dict(ctx.state)
        st["seen"] = st["seen"] + 1
        ctx.state = st


def _inert_rt(pkg):
    sc = pkg.Scenario()
    sc.at(500).reset_peer_random()
    cfg = pkg.SimConfig(n_nodes=2, time_limit=pkg.sec(1),
                        net=pkg.NetConfig(send_latency_min=pkg.ms(1),
                                          send_latency_max=pkg.ms(4)))
    if pkg is P:
        return P.Runtime(cfg, [CountPing()],
                         dict(seen=torch.tensor(0, dtype=torch.int32)),
                         scenario=sc, device="cpu")
    import test_connfault as jcf
    return J.Runtime(cfg, [jcf._CountPing()], jcf._COUNT_SPEC, scenario=sc)


def _inert_reference():
    with reference_stream():
        jrt = _inert_rt(J)
        return {"ref": jax_leaves(jrt.run_fused(jrt.init_batch(RESET_SEEDS),
                                                4_000, 256))}


def test_reset_peer_is_inert_without_conn_state():
    """A model with no conn/stream leaves (tests/test_connfault.py's
    _CountPing) under reset_peer_random: the op resolves and does
    nothing; equal to the reference."""
    rt = _inert_rt(P)
    got = interop.state_to_numpy(rt.run_fused(rt.init_batch(RESET_SEEDS),
                                              4_000, chunk=256))
    assert_same(golden(MODULE, "inert")["ref"], got, what="inert")
    assert not got[".crashed"].any()
    assert (got[".node_state['seen']"][:, 1] == 1).all()


# --------------------------------------------------------------------------
# the supervisor op on minipg's schema
# --------------------------------------------------------------------------
def test_apply_super_plain_matches_reference_on_minipg_schema():
    """`apply_super_plain` (what the CPU runs, and what chip_smoke holds
    the CUDA kernel to) against the JAX package's `_apply_super` on
    random states of minipg's schema (5-d sx_val / sr_val, 3-d rb), with
    every opcode and RESET_PEER lanes targeting each node in turn."""
    import chip_smoke
    from test_torch_step_kernels import _jax_apply_super
    B = 512
    rt = tm.make_minipg_runtime(device="cpu")
    plan, s, op, node, src, payload, key = chip_smoke.super_edge_operands(
        rt, B, seed=18)
    lanes = torch.arange(B, dtype=torch.int32)
    rp = lanes[3::5]
    op[rp] = T.OP_RESET_PEER
    node[rp] = rp % rt.cfg.n_nodes
    with reference_stream():
        jrt = jm.make_minipg_runtime()
        template = jrt.init_batch(np.arange(B, dtype=np.uint32))
        spec = {k: jnp.asarray(v) for k, v in
                jm.pg_state_spec(3, 4).items()}
    ref, ref_rest = _jax_apply_super(
        jrt.cfg, spec, jm.pg_persist_spec(spec), template,
        interop.state_to_numpy(s), op, node, src, payload, key)
    out = apply_super(plan, s, op, node, src, payload, key)
    got = interop.state_to_numpy(out[0])
    assert_same(ref, got, what="apply_super minipg")
    for name, r, t in zip(("init_node", "target", "reset_mask"), ref_rest,
                          out[1:]):
        np.testing.assert_array_equal(t.numpy(), r, err_msg=name)
    # the RESET_PEER lanes tore the rings and bumped each touched epoch
    # once (the target's own entry too)
    before = interop.state_to_numpy(s)
    lanes_rp = rp.numpy()
    torn = got[".node_state['sx_val']"] != before[".node_state['sx_val']"]
    assert torn[lanes_rp].any()
    bumped = (got[".node_state['st_epoch']"]
              - before[".node_state['st_epoch']"])[lanes_rp]
    assert set(np.unique(bumped)) == {0, 1}
    tgt = rp.numpy() % rt.cfg.n_nodes
    assert (bumped[np.arange(len(tgt)), tgt, tgt] == 1).all()


# --------------------------------------------------------------------------
# the gray-failure workloads (bench.py _make_grayfail_runtime)
# --------------------------------------------------------------------------
# recipe: (step cap, the reference's steps the port takes over at): each
# cap passes the recipe's torn-write kill of shard 1 (mix: 650 ms, ~step
# 270; torn: 150 ms, ~step 180), so the port's share holds the flush
GRAY_CASES = {"mix": (320, 192), "torn": (224, 128)}


def _grayfail_reference(recipe):
    import bench
    cap, prefix = GRAY_CASES[recipe]
    with reference_stream():
        jrt = bench._make_grayfail_runtime(recipe)
        return {"ref": jax_leaves(jrt.run(jrt.init_batch(SEEDS), cap,
                                          CHUNK)[0]),
                "mid": jax_leaves(jrt.run(jrt.init_batch(SEEDS), prefix,
                                          CHUNK)[0])}


@pytest.mark.parametrize("recipe", sorted(GRAY_CASES))
def test_grayfail_matches_reference(recipe):
    cap, prefix = GRAY_CASES[recipe]
    rec = golden(MODULE, f"grayfail_{recipe}")
    mid = rec["mid"]
    rt = workloads.grayfail_runtime(recipe, device="cpu")
    t, _ = rt.run(interop.state_from_numpy(mid, "cpu"), EAGER_STEPS, CHUNK)
    t = rt.run_fused(t, cap - prefix - EAGER_STEPS, chunk=CHUNK)
    got = interop.state_to_numpy(t)
    assert_same(rec["ref"], got, what=recipe)
    # the torn kill happened in the port's share: shard 1 went down in
    # torn mode after the prefix (its durable log is what the flush left)
    kill_at = P.ms(650 if recipe == "mix" else 150)
    assert (mid[".now"] < kill_at).all() and (got[".now"] > kill_at).all()
    assert got[".torn"][:, 1].all()


# --------------------------------------------------------------------------
# the recording against the JAX package
# --------------------------------------------------------------------------
REFERENCES = {
    **{case: (lambda c=case: _minipg_reference(c)) for case in CASES},
    "reset_peer": lambda: _reset_reference(True),
    "kill": lambda: _reset_reference(False),
    "inert": _inert_reference,
    **{f"grayfail_{r}": (lambda r=r: _grayfail_reference(r))
       for r in GRAY_CASES},
}


@pytest.mark.slow
@pytest.mark.parametrize("case", sorted(REFERENCES))
def test_golden_is_the_jax_packages_output(case):
    assert_golden_is_reference(MODULE, case, REFERENCES[case]())
