"""Chaos-test harness: the `#[madsim::test]` analog.

The seed loop is the batch axis: MADSIM_TEST_NUM seeds run as one batch,
and a failure names the first crashed seed in a `MADSIM_TEST_SEED=<n>`
repro line with the config hash, as `madsim_tpu.harness.simtest` does.
Env knobs: MADSIM_TEST_SEED, MADSIM_TEST_NUM, MADSIM_TEST_TIME_LIMIT
(seconds), MADSIM_TEST_CHECK_DETERMINISM, MADSIM_TEST_CONFIG (a TOML
network config), MADSIM_TEST_DETSAN (the determinism sanitizer,
`detsan_check`) and MADSIM_TEST_MINIMIZE (shrink a crashing seed's chaos
script in the failure report, `harness.minimize`).

The JAX package's `run_seeds` also turns on its persistent compilation
cache; the port compiles nothing per run, so it has no counterpart.
"""

from __future__ import annotations

import functools
import hashlib
import os
from typing import Callable

import numpy as np
import torch

from ..core import types as T
from ..interop import state_leaves
from ..ops.lane_diff import lane_diff
from ..ops.lane_rows import lane_take
from ..runtime.runtime import Runtime

_CODE_NAMES = {
    T.CRASH_DEADLOCK: "DEADLOCK (no runnable event — 'task will block forever')",
    T.CRASH_TIME_LIMIT: "TIME_LIMIT exceeded",
    T.CRASH_INVARIANT: "INVARIANT violated",
}


class SimFailure(AssertionError):
    def __init__(self, seed, code, node, cfg_hash, msg=""):
        self.seed, self.code, self.node = int(seed), int(code), int(node)
        name = _CODE_NAMES.get(self.code, f"user crash code {self.code}")
        super().__init__(
            f"simulation failed: {name} at node {self.node}. {msg}\n"
            f"reproduce with: MADSIM_TEST_SEED={self.seed} "
            f"(MADSIM_CONFIG_HASH={cfg_hash})")


class DetSanFailure(AssertionError):
    """The determinism sanitizer (detsan=True) found a seed whose final
    state depends on WHICH LANE it ran in: a violation of lane
    independence (seed i in any batch == seed i alone)."""

    def __init__(self, diffs: list, seeds, cfg_hash: str):
        self.diffs = diffs
        first = diffs[0]
        lane = first["lanes"][0] if first["lanes"] else 0
        seeds = np.asarray(seeds).reshape(-1)
        self.seed = int(seeds[lane])
        leaves = ", ".join(d["leaf"] for d in diffs[:8])
        # a single-seed repro line would be a lie here: the seed's
        # trajectory depended on its lane placement, so only re-creating
        # the exact batch reproduces it
        super().__init__(
            f"determinism sanitizer: {len(diffs)} state leaf(s) differ "
            f"between identity and permuted lane placement.\n"
            f"  first: leaf {first['leaf']}, {first['n_lanes']} lane(s), "
            f"first lane {lane} (seed {self.seed})\n"
            f"  differing leaves: {leaves}\n"
            f"reproduce the exact batch with: "
            f"MADSIM_TEST_SEED={int(seeds[0])} "
            f"MADSIM_TEST_NUM={len(seeds)} MADSIM_TEST_DETSAN=1 "
            f"(MADSIM_CONFIG_HASH={cfg_hash}; the differing seed alone "
            f"may pass — lane placement is the variable under test)")


def _env_int(name, default):
    v = os.environ.get(name)
    return int(v) if v else default


def apply_net_override(state, net, cfg=None):
    """Apply a NetConfig onto a batched state's dynamic network knobs."""
    if net is None:
        return state
    if cfg is not None and net.op_jitter_max > 0 \
            and cfg.net.op_jitter_max == 0:
        raise ValueError(
            "op_jitter_max override needs a build with jitter enabled: "
            "construct SimConfig(net=NetConfig(op_jitter_max>0))")
    return state.replace(
        loss=torch.full_like(state.loss, net.packet_loss_rate),
        lat_lo=torch.full_like(state.lat_lo, net.send_latency_min),
        lat_hi=torch.full_like(state.lat_hi, net.send_latency_max),
        jitter=torch.full_like(state.jitter, net.op_jitter_max))


def env_net_override():
    """NetConfig from the MADSIM_TEST_CONFIG env var (a TOML file path)."""
    path = os.environ.get("MADSIM_TEST_CONFIG")
    if not path:
        return None
    with open(path) as f:
        return T.NetConfig.from_toml(f.read())


def effective_config_hash(rt: Runtime, net_override=None,
                          time_limit_override=None) -> str:
    """Repro hash covering the static config and any runtime overrides."""
    h = rt.cfg.hash()
    if net_override is None and not time_limit_override:
        return h
    blob = f"{h}|{net_override}|{time_limit_override}".encode()
    return hashlib.sha256(blob).hexdigest()[:8]


def detsan_perm(B: int) -> np.ndarray:
    """The sanitizer's deterministic lane permutation: a Knuth-hash
    shuffle (a real permutation for any B), falling back to reversal if
    the hash order happens to be the identity, so for B > 1 the permuted
    run always places at least one seed in a different lane."""
    keys = (np.arange(B, dtype=np.uint64) * np.uint64(2654435761)
            + np.uint64(0x9E3779B9)) & np.uint64(0xFFFFFFFF)
    perm = np.argsort(keys, kind="stable").astype(np.int64)
    if B > 1 and bool((perm == np.arange(B)).all()):
        perm = np.arange(B - 1, -1, -1, dtype=np.int64)
    return perm


def diff_states(a, b, align=None) -> list[dict]:
    """Leaf-for-leaf diff of two batched states (the detsan comparator).
    `align` re-indexes `b`'s lanes first (`lane_take`: the inverse of the
    lane permutation, so lane i compares against the lane that ran seed
    i). Returns one dict per differing leaf: {leaf, n_lanes, lanes} with
    `lanes` the first 8 differing lane indices. Compared by value (NaN
    == NaN: a NaN that reproduces is deterministic); zero-size leaves are
    skipped. On the card this is one `lane_diff` launch and one read of
    its [n_leaves, B] flags."""
    if align is not None:
        b = lane_take(b, np.asarray(align))
    la, lb = state_leaves(a), state_leaves(b)
    flags = lane_diff(list(la.values()), list(lb.values())).cpu().numpy()
    diffs: list[dict] = []
    for (path, x), row in zip(la.items(), flags):
        if not x.numel():
            continue
        lanes = np.nonzero(row)[0]
        if not lanes.size:
            continue
        diffs.append(dict(leaf=path, n_lanes=int(len(lanes)),
                          lanes=lanes[:8].tolist()))
    return diffs


def detsan_check(rt: Runtime, seeds, max_steps: int, chunk: int = 512, *,
                 net_override=None, time_limit_override=None,
                 fused: bool = True, perm=None, baseline_state=None,
                 raise_on_diff: bool = True) -> dict:
    """The determinism sanitizer: run the seed batch twice, once in the
    given order and once under a permuted LANE PLACEMENT, un-permute, and
    diff the final states leaf for leaf. Lane independence makes the two
    runs bitwise equal; whatever breaks it shows up as a named leaf,
    lane and seed.

    Both runs use the same runner (`fused` selects `run_fused` or
    `run`). With `baseline_state` (run_seeds already ran the batch) only
    the permuted sweep runs.

    Returns {ok, batch, leaves, diffs, perm}; raises `DetSanFailure` on a
    diff unless `raise_on_diff=False`."""
    seeds = np.asarray(seeds, np.uint32).reshape(-1)
    B = seeds.shape[0]
    perm = detsan_perm(B) if perm is None else np.asarray(perm, np.int64)
    if sorted(perm.tolist()) != list(range(B)):
        raise ValueError(f"perm is not a permutation of range({B})")

    def _run(sds):
        init = apply_net_override(rt.init_batch(sds), net_override,
                                  cfg=rt.cfg)
        if time_limit_override:
            init = rt.set_time_limit(init, time_limit_override)
        if fused:
            return rt.run_fused(init, max_steps, chunk)
        s, _ = rt.run(init, max_steps, chunk=chunk)
        return s

    a = _run(seeds) if baseline_state is None else baseline_state
    b = _run(seeds[perm])
    diffs = diff_states(a, b, align=np.argsort(perm))
    if diffs and raise_on_diff:
        raise DetSanFailure(diffs, seeds, effective_config_hash(
            rt, net_override, time_limit_override))
    return dict(ok=not diffs, batch=int(B), leaves=len(state_leaves(a)),
                diffs=diffs, perm=perm.tolist())


def run_seeds(rt: Runtime, seeds, max_steps: int, chunk: int = 512,
              net_override=None, time_limit_override=None,
              detsan: bool = False):
    """Run a seed batch; raise SimFailure naming the first crashed seed
    (lowest index), or the first lane whose event table overflowed.
    Returns the final batched state.

    detsan=True (or MADSIM_TEST_DETSAN=1) also replays the batch under a
    permuted lane placement and diffs the final states (`detsan_check`);
    DetSanFailure outranks SimFailure, because a crash report from a
    nondeterministic run is not a repro. With MADSIM_TEST_MINIMIZE=1 a
    crash report carries the minimal chaos script that still crashes the
    seed (`harness.minimize.minimize_scenario`)."""
    seeds = np.asarray(seeds, np.uint32)
    init = apply_net_override(rt.init_batch(seeds), net_override,
                              cfg=rt.cfg)
    if time_limit_override:
        init = rt.set_time_limit(init, time_limit_override)
    cfg_hash = effective_config_hash(rt, net_override, time_limit_override)
    state, _ = rt.run(init, max_steps, chunk=chunk)
    if detsan or os.environ.get("MADSIM_TEST_DETSAN"):
        detsan_check(rt, seeds, max_steps, chunk,
                     net_override=net_override,
                     time_limit_override=time_limit_override,
                     fused=False, baseline_state=state)
    crashed = state.crashed.cpu().numpy()
    if crashed.any():
        i = int(np.argmax(crashed))
        msg = f"({int(crashed.sum())}/{len(seeds)} seeds crashed)"
        if os.environ.get("MADSIM_TEST_MINIMIZE"):
            # overrides are not threaded into the minimizer's replays, so
            # under MADSIM_TEST_CONFIG the crash may not reproduce: report
            # that rather than fail the report
            try:
                from .minimize import minimize_scenario
                minimal, info = minimize_scenario(rt, int(seeds[i]),
                                                  max_steps, chunk)
                msg += (f"\nminimal chaos script ({info['kept']} of "
                        f"{info['kept'] + info['dropped']} rows, "
                        f"{info['runs']} runs):\n{minimal.describe()}")
            except Exception as e:  # noqa: BLE001 - repro line still stands
                msg += f"\n(minimization unavailable: {e})"
        raise SimFailure(
            seeds[i], state.crash_code[i].item(), state.crash_node[i].item(),
            cfg_hash, msg=msg)
    oops = state.oops.cpu().numpy()
    if (oops != 0).any():
        i = int(np.argmax(oops != 0))
        raise SimFailure(
            seeds[i], 0, -1, cfg_hash,
            msg=f"capacity overflow (oops bits {int(oops[i])}) — raise "
                f"event_capacity")
    return state


def simtest(num_seeds: int = 16, max_steps: int = 20_000,
            seed: int | None = None, check_determinism: bool = False,
            chunk: int = 512, detsan: bool = False):
    """Decorator: the wrapped function builds and returns a Runtime (or
    (Runtime, check_fn) where check_fn(final_state) does extra asserts);
    the wrapper runs the seed batch and raises SimFailure on a crash
    (DetSanFailure first, with detsan=True or MADSIM_TEST_DETSAN)."""

    def deco(fn: Callable):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            if seed is not None:
                default_seed = seed
            else:  # stable across interpreter runs (hash() is randomized)
                digest = hashlib.sha256(fn.__qualname__.encode()).hexdigest()
                default_seed = int(digest[:8], 16) % (2**31)
            base = _env_int("MADSIM_TEST_SEED", default_seed)
            n = _env_int("MADSIM_TEST_NUM", num_seeds)
            limit_s = _env_int("MADSIM_TEST_TIME_LIMIT", 0)
            out = fn(*args, **kwargs)
            rt, check_fn = out if isinstance(out, tuple) else (out, None)
            seeds = np.arange(base, base + n, dtype=np.uint32)
            override = env_net_override()
            state = run_seeds(rt, seeds, max_steps, chunk,
                              net_override=override,
                              time_limit_override=(T.sec(limit_s)
                                                   if limit_s else None),
                              detsan=detsan)
            if check_fn is not None:
                check_fn(state)
            if check_determinism or os.environ.get(
                    "MADSIM_TEST_CHECK_DETERMINISM"):
                assert rt.check_determinism(base, max_steps,
                                            net_override=override), (
                    f"nondeterminism detected for seed {base} "
                    f"(MADSIM_CONFIG_HASH="
                    f"{effective_config_hash(rt, override)})")
            return state
        return wrapper
    return deco
