"""The port's sharded KV (`models/shard_kv.py`) against the JAX package
(tolerance: zero), on the CPU.

After the reference's tests/test_shard_kv.py: a live migration (the
controller group's configs advance, a shard moves between the two kv
groups while the clients run) held leaf for leaf through `run`, every
client done and every history linearizable under the port's checker;
`compose_invariants`' rule (the FIRST bad group's code) on random
verdicts against the JAX function; and the packing and serving-gate
helpers; and bench.py's shape (L=192, 64 ops, max_cfg 8: the card's
sharded-KV cell, `workloads.shardkv_runtime`) over its first 512 steps,
where the card's run is held to the port's CPU lanes. The migration runs
a cut config: 2 ops a client (JAX: 5),
max_cfg 3 (JAX: 4), a 1.2 s limit (JAX: 60 s), seeds 7 and 9 (JAX: 12;
at this cut some seeds' random moves leave every shard where it was, or
their clients are not done by 1.2 s) — the port's eager CPU step here
costs ~90 ms (three Raft groups; ROADMAP F24). The JAX side
runs on the non-partitionable threefry stream (see _torch_parity).
"""

import numpy as np
import pytest
import torch

import madsim_tpu as J
import madsim_tpu_torch as P
from _torch_parity import (assert_same, jax_leaves, one_cpu_thread,  # noqa
                           reference_stream)
from madsim_tpu.models import shard_kv as js
from madsim_tpu_torch import interop, workloads
from madsim_tpu_torch.models import shard_kv as ts
from madsim_tpu_torch.native import check_kv_history

pytestmark = pytest.mark.usefixtures("one_cpu_thread")

RC, RG, G, NC = 3, 3, 2, 2
CLIENTS_BASE = RC + G * RG
N = CLIENTS_BASE + NC
N_OPS, MAX_CFG = 2, 3
SEEDS = (7, 9)


def _runtime(pkg, kw):
    cfg = pkg.SimConfig(n_nodes=N, event_capacity=160, payload_words=12,
                        time_limit=pkg.ms(1200),
                        net=pkg.NetConfig(send_latency_min=pkg.ms(1),
                                          send_latency_max=pkg.ms(10)))
    mod = js if pkg is J else ts
    return mod.make_shard_runtime(n_groups=G, rg=RG, rc=RC, n_clients=NC,
                                  n_ops=N_OPS, max_cfg=MAX_CFG, cfg=cfg, **kw)


def test_migration_matches_reference_and_is_linearizable():
    seeds = np.asarray(SEEDS, np.uint32)
    with reference_stream():
        jrt = _runtime(J, {})
        s, _ = jrt.run(jrt.init_batch(seeds), 30_000, 256)
        ref = jax_leaves(s)
    rt = _runtime(P, dict(device="cpu"))
    assert len(rt.state_spec) == 48       # K3's node-leaf limit
    t, _ = rt.run(rt.init_batch(seeds), 30_000, 256)
    got = interop.state_to_numpy(t)
    assert_same(ref, got, what="migration")
    assert got[".halted"].all() and not got[".crashed"].any()
    assert (got[".node_state['c_opn']"][:, CLIENTS_BASE:] >= N_OPS).all()
    # configs advanced past the initial assignment, and a kv group froze
    # a lost shard's image for its new owner on every lane
    assert (got[".node_state['cfg_n']"][:, :RC].max(1) == MAX_CFG).all()
    out_num = got[".node_state['out_num']"][:, RC:CLIENTS_BASE]
    assert (out_num >= 2).any((1, 2)).all()
    hists = ts.extract_histories(t, CLIENTS_BASE, NC)
    assert [len(h["op"]) for h in hists] == [NC * N_OPS] * len(SEEDS)
    assert all(check_kv_history(h) for h in hists)


def test_bench_shape_matches_reference_over_its_first_steps():
    """bench.py:276-283 at its own widths (11 nodes, C=160, L=192), seeds
    0 and 1 for 512 steps: configs advance and the first client ops
    commit by then. Its lanes run 11,000-12,300 steps to the halt."""
    seeds = np.asarray((0, 1), np.uint32)
    with reference_stream():
        cfg = J.SimConfig(n_nodes=11, event_capacity=160, payload_words=12,
                          time_limit=J.sec(600),
                          net=J.NetConfig(send_latency_min=J.ms(1),
                                          send_latency_max=J.ms(10)))
        jrt = js.make_shard_runtime(n_groups=2, rg=3, rc=3, n_clients=2,
                                    n_ops=64, max_cfg=8, log_capacity=192,
                                    cfg=cfg)
        s, _ = jrt.run(jrt.init_batch(seeds), 512, 128)
        ref = jax_leaves(s)
    rt = workloads.shardkv_runtime("cpu")
    assert rt.cfg.event_capacity == 160
    t, _ = rt.run(rt.init_batch(seeds), 512, 128)
    got = interop.state_to_numpy(t)
    assert_same(ref, got, what="bench shape")
    assert got[".node_state['log_term']"].shape[-1] == 192
    assert (got[".steps"] == 512).all() and not got[".crashed"].any()
    assert (got[".node_state['cfg_n']"][:, :RC].max(1) >= 2).all()
    assert got[".node_state['c_opn']"][:, CLIENTS_BASE:].sum() > 0


def test_compose_invariants_gives_the_first_bad_code():
    """Three invariants with random verdicts and codes per lane: the port's
    composition against the reference's, lane by lane."""
    import jax
    import jax.numpy as jnp
    rng = np.random.default_rng(7)
    B, K = 512, 3
    bads = rng.random((K, B)) < 0.4
    codes = rng.integers(100, 200, (K, B)).astype(np.int32)

    def inv(i, xp):
        return lambda s: (xp.asarray(bads[i])[s], xp.asarray(codes[i])[s])

    tinv = ts.compose_invariants(*[
        (lambda i: lambda s: (torch.as_tensor(bads[i]),
                              torch.as_tensor(codes[i])))(i)
        for i in range(K)])
    tb, tc = tinv(None)
    jinv = js.compose_invariants(*[inv(i, jnp) for i in range(K)])
    with reference_stream():
        jb, jc = jax.vmap(jinv)(jnp.arange(B))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    assert tc.dtype == torch.int32
    first = np.argmax(bads, 0)
    want = np.where(bads.any(0), codes[first, np.arange(B)], 0)
    np.testing.assert_array_equal(tc.numpy(), want)


def test_packing_and_the_serving_gate_match_reference():
    asn = (1 << 0) | (0 << 3) | (1 << 6) | (1 << 9)
    for s in range(4):
        assert int(ts.grp_of(asn, s)) == int(js.grp_of(asn, s))
    srv = ts.ShardServer(N, 64, gid=1, rc=RC, rg=RG, n_groups=G, n_keys=8,
                         n_shards=4, n_clients=NC, max_cfg=MAX_CFG)
    one = torch.ones(1, dtype=torch.int32)
    st = dict(my_cfg=2 * one, my_asn=asn * one, ready=0b0101 * one)
    got = [bool(srv._owns(st, s * one)) for s in range(4)]
    # owned + ready (0, 2); the other group's (1); owned, not ready (3)
    assert got == [True, False, True, False]
    st0 = dict(st, my_cfg=0 * one)
    assert not bool(srv._owns(st0, 0 * one))    # no config yet
