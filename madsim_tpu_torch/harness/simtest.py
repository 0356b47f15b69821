"""Chaos-test harness: the `#[madsim::test]` analog.

The seed loop is the batch axis: MADSIM_TEST_NUM seeds run as one batch,
and a failure names the first crashed seed in a `MADSIM_TEST_SEED=<n>`
repro line with the config hash, as `madsim_tpu.harness.simtest` does.
Env knobs: MADSIM_TEST_SEED, MADSIM_TEST_NUM, MADSIM_TEST_TIME_LIMIT
(seconds), MADSIM_TEST_CHECK_DETERMINISM, MADSIM_TEST_CONFIG (a TOML
network config).
"""

from __future__ import annotations

import functools
import hashlib
import os
from typing import Callable

import numpy as np
import torch

from ..core import types as T
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


def run_seeds(rt: Runtime, seeds, max_steps: int, chunk: int = 512,
              net_override=None, time_limit_override=None):
    """Run a seed batch; raise SimFailure naming the first crashed seed
    (lowest index), or the first lane whose event table overflowed.
    Returns the final batched state."""
    seeds = np.asarray(seeds, np.uint32)
    init = apply_net_override(rt.init_batch(seeds), net_override,
                              cfg=rt.cfg)
    if time_limit_override:
        init = rt.set_time_limit(init, time_limit_override)
    cfg_hash = effective_config_hash(rt, net_override, time_limit_override)
    state, _ = rt.run(init, max_steps, chunk=chunk)
    crashed = state.crashed.cpu().numpy()
    if crashed.any():
        i = int(np.argmax(crashed))
        raise SimFailure(
            seeds[i], state.crash_code[i].item(), state.crash_node[i].item(),
            cfg_hash,
            msg=f"({int(crashed.sum())}/{len(seeds)} seeds crashed)")
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
            chunk: int = 512):
    """Decorator: the wrapped function builds and returns a Runtime (or
    (Runtime, check_fn) where check_fn(final_state) does extra asserts);
    the wrapper runs the seed batch and raises SimFailure on a crash."""

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
                                                   if limit_s else None))
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
