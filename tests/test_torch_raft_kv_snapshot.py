"""The port's replicated KV store with log compaction and chunked
InstallSnapshot, and at a long log, against the JAX package (tolerance:
zero), on the CPU.

Cases after the reference's tests/test_kv_snapshot.py (log 12 with
compact_threshold 4: the window slides, K11 takes its pairwise form,
and a lagging server catches up through the chunked image) and
tests/test_kv_linearizability.py:110 (one key, log 96). Each is held
leaf for leaf through `run`, with equal histories that both packages'
checkers find linearizable. Fewer servers, clients, ops and simulated
seconds than the JAX tests (ROADMAP F24).
"""

import numpy as np
import pytest

from _torch_kv_cases import chaos, run_both
from _torch_parity import assert_same, one_cpu_thread  # noqa: F401
from madsim_tpu import native as jnative
from madsim_tpu.models import raft_kv as jkv
from madsim_tpu_torch import native
from madsim_tpu_torch.models import raft_kv as tkv

pytestmark = pytest.mark.usefixtures("one_cpu_thread")


def _kv(pkg):
    return jkv if pkg.__name__ == "madsim_tpu" else tkv


def _compaction_l12(pkg, kw):
    cfg = pkg.SimConfig(n_nodes=5, event_capacity=128, payload_words=12,
                        time_limit=pkg.sec(4),
                        net=pkg.NetConfig(packet_loss_rate=0.05,
                                          send_latency_min=pkg.ms(1),
                                          send_latency_max=pkg.ms(10)))
    return _kv(pkg).make_kv_runtime(
        3, 2, n_keys=3, n_ops=8, log_capacity=12,
        scenario=chaos(pkg, 3, 2, 150, 600), cfg=cfg, compact_threshold=4,
        **kw)


def _one_key_l96(pkg, kw):
    return _kv(pkg).make_kv_runtime(n_raft=3, n_clients=3, n_keys=1,
                                    n_ops=8, log_capacity=96, **kw)


# case: (maker, servers, clients, ops, seeds, max_steps, chunk)
CASES = {"compaction_L12": (_compaction_l12, 3, 2, 8, 4, 30_000, 64),
         "one_key_L96": (_one_key_l96, 3, 3, 8, 3, 30_000, 64)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_kv_matches_reference(case):
    make, n_raft, n_clients, n_ops, n, max_steps, chunk = CASES[case]
    ref, got, state = run_both(make, np.arange(n), max_steps, chunk)
    assert_same(ref, got, what=case)
    assert got[".halted"].all() and not got[".crashed"].any()
    assert (got[".oops"] == 0).all()
    assert (got[".node_state['c_opn']"][:, n_raft:] == n_ops).all()
    if case == "compaction_L12":
        snap = got[".node_state['snap_len']"][:, :n_raft]
        commit = got[".node_state['commit']"][:, :n_raft]
        assert (snap.max(1) > 0).all()          # compaction happened
        assert (commit.max(1) > 12).all()       # the window slid
    hists = tkv.extract_histories(state, n_raft, n_clients)
    for h in hists:
        assert len(h["op"]) == n_clients * n_ops
        assert native.check_kv_history(h)
        assert jnative.check_kv_history(h)
