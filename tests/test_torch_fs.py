"""The simulated filesystem and the golden workloads of the port against
the JAX package (tolerance: zero), on the CPU.

Covers the frozen golden workloads of tests/_grayfail_golden.py —
pingpong with the flight recorder compiled in (trace_cap=64) and the
wal_kv kill/restart matrix on `fs.py` — through `run` and `run_fused`:
all 342 leaf digests of tests/data/golden_r22_leaves.json, ring and
lineage leaves included; their `init_batch`; `fs.py` on random files;
and wal_kv's durability oracle going red without the WAL sync. The JAX
side runs on the non-partitionable threefry stream (see _torch_parity).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_same, jax_leaves, reference_stream
from madsim_tpu_torch import interop, workloads

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "data", "golden_r22_leaves.json")


# --------------------------------------------------------------------------
# The frozen goldens: 80 + 80 + 91 + 91 leaf digests
# --------------------------------------------------------------------------
_RUNS: dict = {}


def _golden_run(name: str) -> dict:
    """{runner: leaf digests} of the port's run of one golden workload,
    both runners from ONE initial state, with that state's digests before
    ("input") and after ("input_after") the two runs (memoized: each
    test reads the same runs)."""
    if name not in _RUNS:
        p = workloads.GOLDEN_RUNS[name]
        rt = workloads.GOLDEN_WORKLOADS[name](device="cpu")
        seeds = np.arange(p["seeds"], dtype=np.uint32)
        init = rt.init_batch(seeds)
        before = interop.leaf_digests(init)
        s, _ = rt.run(init, p["max_steps"], p["chunk"])
        f = rt.run_fused(init, p["max_steps"], p["chunk"])
        _RUNS[name] = {"run": interop.leaf_digests(s),
                       "run_fused": interop.leaf_digests(f),
                       "input": before,
                       "input_after": interop.leaf_digests(init)}
    return _RUNS[name]


@pytest.mark.parametrize("name,runner", [
    ("pingpong", "run"), ("pingpong", "run_fused"),
    ("wal_kv", "run"), ("wal_kv", "run_fused")])
def test_golden_workload_reproduces_frozen_digests(name, runner):
    with open(GOLDEN) as f:
        want = json.load(f)[name][runner]
    got = _golden_run(name)[runner]
    assert len(want) == {"pingpong": 80, "wal_kv": 91}[name]
    bad = [k for k in want if got.get(k) != want[k]]
    assert not bad, f"{name} {runner}: digests differ for {bad}"


@pytest.mark.parametrize("name", ["pingpong", "wal_kv"])
def test_runners_leave_the_callers_state_unchanged(name):
    """The step writes its input's event table and ring in place, so each
    runner steps a private copy: `run` then `run_fused` from one state
    leave it bit-identical, and the two runs agree leaf for leaf with each
    other and with the JAX reference's frozen digests."""
    with open(GOLDEN) as f:
        want = json.load(f)[name]
    runs = _golden_run(name)
    assert runs["input_after"] == runs["input"]
    assert runs["run"] == runs["run_fused"]
    assert all(runs["run"][k] == want["run"][k] for k in want["run"])
    moved = [k for k in runs["input"] if runs["input"][k] != runs["run"][k]]
    assert ".t_payload" in moved and ".t_node" in moved


@pytest.mark.parametrize("name", ["pingpong", "wal_kv"])
def test_golden_init_batch_matches_reference(name):
    import _grayfail_golden as gg
    seeds = np.arange(8, dtype=np.uint32)
    with reference_stream():
        build = dict(pingpong=gg.build_pingpong, wal_kv=gg.build_wal_kv)
        ref = jax_leaves(build[name]().init_batch(seeds))
    rt = workloads.GOLDEN_WORKLOADS[name](device="cpu")
    got = interop.state_to_numpy(rt.init_batch(seeds))
    assert set(ref) == set(got)
    assert_same(ref, got, what=f"{name} init_batch")


# --------------------------------------------------------------------------
# fs.py on random files
# --------------------------------------------------------------------------
def test_fs_matches_reference_on_random_files():
    """Every fs.py call, masked per lane, on random files of 3 lanes x 2
    files x 6 words, with static and per-lane file ids and offsets that
    overrun the file."""
    from madsim_tpu import fs as jfs
    from madsim_tpu_torch import fs as tfs
    rng = np.random.default_rng(7)
    B, F, S = 3, 2, 6
    st0 = dict(fs_mem=rng.integers(-9, 9, (B, F, S)).astype(np.int32),
               fs_mlen=rng.integers(0, S + 1, (B, F)).astype(np.int32),
               fs_disk=rng.integers(-9, 9, (B, F, S)).astype(np.int32),
               fs_dlen=rng.integers(0, S + 1, (B, F)).astype(np.int32))
    f_lane = np.array([0, 1, 1], np.int32)
    off = np.array([0, 4, -1], np.int32)
    words = rng.integers(-99, 99, (B, 3)).astype(np.int32)
    when = np.array([True, False, True])
    nl = np.array([2, 9, 0], np.int32)

    def script(fs, st, f, off, words, when, nl, stack):
        out = []
        out.append(fs.read_at(st, f, off, 4))
        out.append(fs.file_len(st, 1))
        out.append(fs.write_all_at(st, f, off, words, when=when))
        out.append(fs.write_all_at(st, 0, 2, words[..., :2]))
        out.append(fs.read_at(st, 0, 1, 5))
        fs.sync_all(st, f, when=when)
        fs.set_len(st, 1, nl, when=when)
        fs.set_len(st, f, 3)
        fs.sync_all(st, 0)
        fs.mount(st, when=~when)
        out.append(fs.read_at(st, 1, 0, S))
        return stack(out)

    def jstep(st, f, off, words, when, nl):
        st = dict(st)
        res = script(jfs, st, f, off, words, when, nl,
                     lambda xs: [jnp.asarray(x).astype(jnp.int32)
                                 for x in xs])
        return st, res

    jst, jres = jax.vmap(jstep)(
        {k: jnp.asarray(v) for k, v in st0.items()}, jnp.asarray(f_lane),
        jnp.asarray(off), jnp.asarray(words), jnp.asarray(when),
        jnp.asarray(nl))
    tst = {k: torch.as_tensor(v) for k, v in st0.items()}
    tres = script(tfs, tst, torch.as_tensor(f_lane), torch.as_tensor(off),
                  torch.as_tensor(words), torch.as_tensor(when),
                  torch.as_tensor(nl),
                  lambda xs: [x.to(torch.int32) for x in xs])
    for k in st0:
        np.testing.assert_array_equal(tst[k].numpy(), np.asarray(jst[k]),
                                      err_msg=k)
    for i, (a, b) in enumerate(zip(tres, jres)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                      err_msg=f"result {i}")
    assert tres[2].tolist() == [True, False, False]


def test_wal_kv_without_sync_loses_a_write_as_the_reference_does():
    """The red case of the durability oracle (tests/test_fs.py's torn-write
    matrix: sync_wal=False, torn-write kills) crashes the same lanes with
    CRASH_LOST_WRITE on both sides, the torn flush included."""
    import madsim_tpu as J
    from madsim_tpu.models import wal_kv as jwal
    import madsim_tpu_torch as P
    from madsim_tpu_torch.models import wal_kv as twal
    seeds = np.arange(16, dtype=np.uint32)

    def scenario(mod, ms):
        sc = mod.Scenario()
        sc.at(500).set_disk(0, 0, torn=True)
        for t in range(6):
            sc.at(ms(150) + ms(250) * t).kill(0)
            sc.at(ms(150) + ms(250) * t + ms(60)).restart(0)
        return sc

    kw = dict(n_clients=2, n_ops=12, wal_cap=64, sync_wal=False)
    with reference_stream():
        jrt = jwal.make_wal_kv_runtime(**kw, scenario=scenario(J, J.ms))
        s, _ = jrt.run(jrt.init_batch(seeds), 128, chunk=128)
        ref = jax_leaves(s)
    trt = twal.make_wal_kv_runtime(**kw, scenario=scenario(P, P.ms),
                                   device="cpu")
    t, _ = trt.run(trt.init_batch(seeds), 128, chunk=128)
    got = interop.state_to_numpy(t)
    assert_same(ref, got, what="wal_kv sync_wal=False, torn kills")
    assert (got[".crash_code"] == twal.CRASH_LOST_WRITE).any()
