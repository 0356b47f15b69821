"""The port's replicated KV store (`models/raft_kv.py`) and its history
checker against the JAX package (tolerance: zero), on the CPU.

Cases after the reference's tests/test_kv_linearizability.py: a clean
3-server, 2-client run at log 32, and a kill/restart chaos run at log 64
(raft_kv's default log length, past the 32 slots K11's first
instantiation takes). Each is held leaf for leaf through `run`; the
client histories `extract_histories` pulls out are equal, every one is
linearizable and both packages' checkers give the same verdicts; a
corrupted GET is rejected. Fewer seeds, ops and simulated seconds than
the JAX tests (ROADMAP F24: the port's eager CPU step costs 20-40 ms);
BASELINE.md config 4 and the full configs run in chip_smoke.py. The
compaction and long-log cases are in test_torch_raft_kv_snapshot.py.
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

GET = tkv.OP_GET


def _kv(pkg):
    return jkv if pkg.__name__ == "madsim_tpu" else tkv


def _clean(pkg, kw):
    return _kv(pkg).make_kv_runtime(n_raft=3, n_clients=2, n_keys=2,
                                    n_ops=6, log_capacity=32, **kw)


def _chaos_l64(pkg, kw):
    cfg = pkg.SimConfig(n_nodes=5, event_capacity=128, payload_words=12,
                        time_limit=pkg.sec(8),
                        net=pkg.NetConfig(packet_loss_rate=0.05))
    return _kv(pkg).make_kv_runtime(
        n_raft=3, n_clients=2, n_keys=2, n_ops=6, log_capacity=64,
        scenario=chaos(pkg, 3, 2, 200, 700), cfg=cfg, **kw)


# case: (maker, seeds, max_steps, chunk)
CASES = {"clean_L32": (_clean, 4, 30_000, 64),
         "chaos_L64": (_chaos_l64, 4, 30_000, 64)}
_RUNS = {}


def _run(case):
    if case not in _RUNS:
        make, n, max_steps, chunk = CASES[case]
        _RUNS[case] = run_both(make, np.arange(n), max_steps, chunk)
    return _RUNS[case]


class _JaxState:
    """The one attribute the JAX extract_histories reads."""

    def __init__(self, leaves):
        self.node_state = {k: leaves[f".node_state['{k}']"] for k in
                           ("h_op", "h_key", "h_val", "h_inv", "h_resp")}


@pytest.mark.parametrize("case", sorted(CASES))
def test_kv_matches_reference(case):
    ref, got, _ = _run(case)
    assert_same(ref, got, what=case)
    assert got[".halted"].all() and not got[".crashed"].any()
    assert (got[".oops"] == 0).all()
    opn = got[".node_state['c_opn']"][:, 3:]
    assert (opn == 6).all()          # every client finished every op


@pytest.mark.parametrize("case", sorted(CASES))
def test_histories_and_verdicts_match_reference(case):
    ref, _, state = _run(case)
    mine = tkv.extract_histories(state, 3, 2)
    theirs = jkv.extract_histories(_JaxState(ref), 3, 2)
    assert len(mine) == len(theirs) == state.now.shape[0]
    for a, b in zip(mine, theirs):
        assert sorted(a) == sorted(b) == ["inv", "key", "op", "resp", "val"]
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        assert len(a["op"]) == 12
        for force in (False, True):
            v = native.check_kv_history(a, force_python=force)
            assert v is True
            assert v is jnative.check_kv_history(b, force_python=force)


def test_a_corrupted_get_is_rejected():
    _, _, state = _run("clean_L32")
    rejected = 0
    for h in tkv.extract_histories(state, 3, 2):
        gets = np.nonzero((h["op"] == GET) & (h["resp"] >= 0))[0]
        if not len(gets):
            continue
        h["val"][gets[0]] = 999_999          # a value nobody ever wrote
        assert not native.check_kv_history(h)
        assert not native.check_kv_history(h, force_python=True)
        assert not jnative.check_kv_history(h)
        rejected += 1
    assert rejected
