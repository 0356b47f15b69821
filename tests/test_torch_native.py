"""The port's host-side native components (`madsim_tpu_torch/native.py`)
against the JAX package's `madsim_tpu.native` (tolerance: zero — every
result is a verdict or an integer count).

The checker's verdicts on the reference's unit cases
(tests/test_kv_linearizability.py:24-43) and on seeded random register
histories, some above the 57 operations the C++ search takes; where the
port builds its libraries and what it does when a build fails; and the
single-seed native baseline's counts.
"""

import os

import numpy as np
import pytest

from madsim_tpu import native as jnative
from madsim_tpu_torch import native

PUT, GET = 1, 2

# the reference's checker unit cases: (ops, expected)
CASES = [
    ([(GET, 0, 0, 1)], True),                       # read initial value
    ([(GET, 5, 0, 1)], False),                      # read from nowhere
    ([(PUT, 5, 0, 1), (GET, 5, 2, 3)], True),
    ([(PUT, 5, 0, 1), (GET, 0, 2, 3)], False),      # stale read
    ([(PUT, 5, 0, 10), (GET, 5, 1, 2)], True),      # concurrent put/get
    ([(PUT, 5, 0, 10), (GET, 0, 1, 2)], True),
    ([(PUT, 1, 0, 1), (PUT, 2, 2, 3), (GET, 2, 4, 5), (GET, 1, 6, 7)],
     False),                                        # value regression
    ([(PUT, 9, 0, -1), (GET, 9, 5, 6)], True),      # pending put applied
    ([(PUT, 9, 0, -1), (GET, 0, 5, 6)], True),      # ... or not
    ([(GET, 9, 0, 1), (PUT, 9, 5, -1)], False),     # not before its inv
    ([(PUT, 1, 0, 10), (PUT, 2, 0, 10), (GET, 1, 11, 12),
      (GET, 2, 13, 14)], False),                    # 2 then 1 impossible
]


def _h(ops):
    a = np.asarray(ops, np.int64).reshape(-1, 4)
    return a[:, 0], a[:, 1], a[:, 2], a[:, 3]


@pytest.mark.parametrize("i", range(len(CASES)))
def test_checker_unit_cases_match_reference(i):
    ops, expected = CASES[i]
    args = _h(ops)
    for force in (False, True):
        got = native.check_register(*args, force_python=force)
        assert got is expected
        assert got is jnative.check_register(*args, force_python=force)


def _random_history(rng, n, corrupt, pending):
    """A register history of n ops whose linearization points are drawn
    inside their intervals (so it is linearizable), mostly sequential
    with some overlap; `pending` ops lose their response; `corrupt`
    changes one completed GET's value to one nobody wrote."""
    inv = np.cumsum(rng.integers(1, 4, n)) * 10
    resp = inv + rng.integers(1, 25, n)
    lp = inv + (resp - inv) * rng.random(n)
    op = np.where(rng.random(n) < 0.5, PUT, GET)
    val = np.zeros(n, np.int64)
    cur = 0
    for i in np.argsort(lp, kind="stable"):
        if op[i] == PUT:
            val[i] = cur = int(rng.integers(1, 6))
        else:
            val[i] = cur
    if pending:
        resp[rng.choice(n, pending, replace=False)] = -1
    if corrupt:
        gets = np.nonzero((op == GET) & (resp >= 0))[0]
        if len(gets):
            val[rng.choice(gets)] = 999_999
    return op, val, inv, resp


@pytest.mark.parametrize("n", [3, 9, 20, 40, 57, 58, 70])
def test_random_histories_match_reference(n):
    """Seeded random histories around the 57-op split: the port's verdict
    (C++ up to 57 ops, Python above) equals the reference's and its own
    Python mirror's, linearizable and corrupted alike."""
    rng = np.random.default_rng(n)
    verdicts = []
    for trial in range(12):
        args = _random_history(rng, n, corrupt=trial % 3 == 2,
                               pending=trial % 4)
        got = native.check_register(*args)
        assert got is jnative.check_register(*args)
        assert got is native.check_register(*args, force_python=True)
        verdicts.append(got)
    assert True in verdicts and False in verdicts


def test_kv_history_splits_keys_like_reference():
    """check_kv_history decides each key on its own: the port and the
    reference agree on a multi-key history above 57 ops and on the same
    history with one key's GET corrupted."""
    rng = np.random.default_rng(7)
    parts = [_random_history(rng, n, False, 1) for n in (60, 20, 5)]
    hist = {k: np.concatenate([p[i] for p in parts])
            for i, k in enumerate(("op", "val", "inv", "resp"))}
    hist["key"] = np.repeat(np.arange(3), [60, 20, 5])
    for force in (False, True):
        assert native.check_kv_history(hist, force_python=force)
        assert jnative.check_kv_history(hist, force_python=force)
    gets = np.nonzero((hist["op"] == GET) & (hist["resp"] >= 0)
                      & (hist["key"] == 1))[0]
    hist["val"][gets[0]] = 999_999
    assert not native.check_kv_history(hist)
    assert not jnative.check_kv_history(hist)


def test_libraries_build_into_the_build_dir():
    native.check_register(*_h(CASES[2][0]))
    native.native_baseline_run(0, 100)
    for name in native.SOURCES:
        path = native.lib_path(name)
        assert os.path.dirname(path) == native.BUILD_DIR
        assert os.path.exists(path)
    assert native.BUILD_DIR == os.path.join(
        os.path.dirname(native.__file__), "_build")
    assert not [f for f in os.listdir(native.SRC_DIR)
                if not f.endswith(".cpp")]


def test_a_failed_build_raises(monkeypatch, tmp_path):
    """No silent fallback: a missing compiler and a source that does not
    compile both raise, and leave no library behind."""
    monkeypatch.setattr(native, "_LIBS", {})
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(native, "CXX", str(tmp_path / "no-such-g++"))
    with pytest.raises(RuntimeError, match="cannot run"):
        native.check_register(*_h(CASES[0][0]))
    with pytest.raises(RuntimeError):
        native.native_baseline_run(0, 10)
    monkeypatch.setattr(native, "CXX", "g++")
    src = tmp_path / "src"
    src.mkdir()
    (src / "linearize.cpp").write_text("this is not C++\n")
    monkeypatch.setattr(native, "SRC_DIR", str(src))
    with pytest.raises(RuntimeError, match="failed for linearize"):
        native.check_register(*_h(CASES[0][0]))
    assert os.listdir(tmp_path / "build") == []
    # force_python never builds
    assert native.check_register(*_h(CASES[2][0]), force_python=True)


@pytest.mark.parametrize("seed", [0, 17])
def test_native_baseline_counts_match_reference(seed):
    got = native.native_baseline_run(seed, 20_000)
    want = jnative.native_baseline_run(seed, 20_000)
    assert want is not None
    for k in ("events", "max_commit", "elections"):
        assert got[k] == want[k], k
    assert got["events"] == 20_000 and got["elections"] > 0
