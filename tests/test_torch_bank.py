"""The port's bank workload (`models/bank.py`) against the JAX package
(tolerance: zero), on the CPU.

Cases after the reference's tests/test_bank.py: a clean run at log 32,
a kill/restart chaos run at log 48, each held leaf for leaf through
`run` with every completed READ seeing the conserving total; and the
poisoned variant (the fifth appended entry's amount inflated on one
node), whose per-event conservation check crashes the same lanes with
the same codes (money leak 501, or the log-matching check's 102) in
both packages. Fewer servers, clients, ops, seeds and simulated seconds
than the JAX tests (ROADMAP F24).
"""

import numpy as np
import pytest
import torch

import chip_smoke
import madsim_tpu as J
import madsim_tpu_torch as P
from _torch_kv_cases import chaos, run_both
from _torch_parity import assert_same, one_cpu_thread  # noqa: F401
from madsim_tpu.models import bank as jbank
from madsim_tpu_torch.models import bank as tbank

pytestmark = pytest.mark.usefixtures("one_cpu_thread")

TOTAL = 6 * 100


def _bank(pkg):
    return jbank if pkg is J else tbank


def _clean(pkg, kw):
    return _bank(pkg).make_bank_runtime(n_raft=3, n_clients=2, n_ops=6,
                                        log_capacity=32, **kw)


def _chaos_l48(pkg, kw):
    cfg = pkg.SimConfig(n_nodes=5, event_capacity=96, payload_words=13,
                        time_limit=pkg.sec(4),
                        net=pkg.NetConfig(packet_loss_rate=0.05))
    return _bank(pkg).make_bank_runtime(
        n_raft=3, n_clients=2, n_ops=6, log_capacity=48,
        scenario=chaos(pkg, 3, 2, 200, 700), cfg=cfg, **kw)


class _JaxLeaky(jbank.RaftBank):
    """The reference test's poisoned replica: the 5th appended entry's
    amount is inflated by 7."""

    def _extra_message(self, ctx, st, src, tag, payload):
        import jax.numpy as jnp
        super()._extra_message(ctx, st, src, tag, payload)
        bad = (st["log_len"] == 5) & (st["log_op"][4] == jbank.OP_TRANSFER)
        st["log_amt"] = st["log_amt"].at[4].set(
            jnp.where(bad, st["log_amt"][4] + 7, st["log_amt"][4]))


def _leaky(pkg, kw):
    """The poisoned runtime: the reference test's, and chip_smoke's
    `leaky_bank_runtime` (the same replica on batched lanes)."""
    if pkg is P:
        return chip_smoke.leaky_bank_runtime(kw["device"])
    n_raft, n_clients = 3, 2
    n = n_raft + n_clients
    cfg = J.SimConfig(n_nodes=n, event_capacity=96, payload_words=13,
                      time_limit=J.sec(20))
    return J.Runtime(cfg, [_JaxLeaky(n, 6, 100, 32, n_peers=n_raft),
                           jbank.BankClient(n_raft, 6, 6)],
                     jbank.bank_state_spec(n, 32, 6),
                     node_prog=np.asarray([0] * n_raft + [1] * n_clients),
                     invariant=jbank.bank_invariant(n, 32, n_raft, 6, 100),
                     persist=jbank.bank_persist_spec(),
                     halt_when=jbank.all_clients_done(n_raft, 6))


@pytest.mark.parametrize("case", ["clean_L32", "chaos_L48"])
def test_bank_matches_reference_and_conserves(case):
    make = _clean if case == "clean_L32" else _chaos_l48
    ref, got, _ = run_both(make, np.arange(4), 30_000, 64)
    assert_same(ref, got, what=case)
    assert got[".halted"].all() and not got[".crashed"].any()
    totals = got[".node_state['h_total']"][:, 3:]
    resp = got[".node_state['h_resp']"][:, 3:]
    seen = totals[resp >= 0]
    assert len(seen) == 4 * 2 * 6      # every client op completed
    assert (seen == TOTAL).all()


def test_poisoned_replica_crashes_the_same_lanes():
    ref, got, _ = run_both(_leaky, np.arange(8), 30_000, 64)
    assert_same(ref, got, what="leaky")
    crashed = got[".crashed"]
    assert crashed.any()
    assert set(got[".crash_code"][crashed].tolist()) <= {
        tbank.CRASH_MONEY_LEAK, 102}


def test_conservation_check_matches_reference():
    """bank_invariant on random ledgers, lane by lane against the JAX
    invariant: in-range and out-of-range accounts, commits past the log,
    leaks on one node, transfers and READs mixed."""
    import jax
    import jax.numpy as jnp
    from _torch_parity import reference_stream
    rng = np.random.default_rng(3)
    B, N, L, n_raft = 256, 5, 16, 3
    ns = dict(
        role=rng.integers(0, 2, (B, N)), term=rng.integers(0, 3, (B, N)),
        snap_len=np.zeros((B, N)), log_len=rng.integers(0, L + 1, (B, N)),
        commit=rng.integers(0, L + 1, (B, N)),
        snap_digest=np.zeros((B, N)), log_term=np.ones((B, N, L)),
        log_op=rng.integers(0, 3, (B, N, L)),
        log_afrom=rng.integers(-1, 8, (B, N, L)),
        log_ato=rng.integers(-1, 8, (B, N, L)),
        log_amt=rng.integers(1, 20, (B, N, L)),
        log_client=np.zeros((B, N, L)), log_rtag=np.zeros((B, N, L)))
    ns = {k: v.astype(np.int32) for k, v in ns.items()}
    ns["commit"] = np.minimum(ns["commit"], ns["log_len"])
    # equal logs on every node, so only the conservation check can fire
    for k in ("log_op", "log_afrom", "log_ato", "log_amt"):
        ns[k][:] = ns[k][:, :1]
    st = P.SimState.__new__(P.SimState)
    st.node_state = {k: torch.as_tensor(v) for k, v in ns.items()}
    st.now = torch.zeros(B, dtype=torch.int32)
    bad, code = tbank.bank_invariant(N, L, n_raft, 6, 100)(st)

    class JState:
        node_state = None

    jinv = jbank.bank_invariant(N, L, n_raft, 6, 100)
    with reference_stream():
        js = JState()
        js.node_state = {k: jnp.asarray(v) for k, v in ns.items()}
        jb, jc = jax.vmap(lambda d: jinv(type("S", (), {
            "node_state": d})()))(js.node_state)
    np.testing.assert_array_equal(bad.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(code.numpy(), np.asarray(jc))
    assert 0 < int(bad.sum()) < B


def test_reference_runs_take_nothing_from_the_persistent_cache():
    """Inside `reference_stream` jax neither reads nor writes its
    persistent compilation cache, even in a worker whose earlier compiles
    decided to use it (jax decides once a process; a read of that cache
    crashed a worker inside this file's reference run, ROADMAP F28); on
    exit the decision is taken afresh from the restored flag."""
    import jax
    import jax.numpy as jnp
    from jax._src import compilation_cache, xla_bridge
    from _torch_parity import reference_stream
    backend = xla_bridge.get_backend()
    jax.jit(lambda x: x + 1)(jnp.arange(3))     # a compile outside
    outside = compilation_cache.is_cache_used(backend)
    with reference_stream():
        assert not compilation_cache.is_cache_used(backend)
        jax.jit(lambda x: x * 3 + 1)(jnp.arange(4))
        assert not compilation_cache.is_cache_used(backend)
    assert compilation_cache.is_cache_used(backend) == outside


@pytest.mark.parametrize("limit", ["far", "near"])
def test_reference_stream_drops_cached_executables_near_the_mapping_limit(
        monkeypatch, limit):
    """Past half the kernel's per-process mapping limit, `reference_stream`
    first drops the executables that only the caches hold (a test worker
    at the limit dies in its next compile, ROADMAP F28); below it, it
    keeps them."""
    import jax
    import jax.numpy as jnp
    import _torch_parity as tp
    from madsim_tpu.compile.cache import PROGRAM_CACHE
    f = jax.jit(lambda x: x * 5 + 2)
    f(jnp.arange(7))
    PROGRAM_CACHE.get(("mapping-limit-probe",), lambda: f)
    monkeypatch.setattr(tp, "mapping_limit",
                        (lambda: 1 << 40) if limit == "far" else (lambda: 0))
    with tp.reference_stream():
        pass
    dropped = limit == "near"
    assert f._cache_size() == (0 if dropped else 1)
    assert (len(PROGRAM_CACHE) == 0) == dropped
    assert tp.mapping_count() > 0
