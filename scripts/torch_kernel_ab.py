#!/usr/bin/env python3
"""Compare two checkouts of the PyTorch/CUDA port on one GPU, in turns.

    python3 scripts/torch_kernel_ab.py OLD_DIR NEW_DIR [--pairs 2]

Each measurement runs in a fresh process that imports `madsim_tpu_torch`
from the checkout it names and builds that checkout's kernels from its own
csrc/, so the two trees share no module and no library. The order
alternates (old, new, new, old, ...), so a drift of the card or of the
host falls on both sides. A measurement holds:

  sched_pick_ms   the event select as a CUDA-graph replay (50 launches) on
                  the operands of step 512 of bench.py's flagship at
                  B=100,000 (eager runner, recorder off)
  apply_knobs_ms  the knob write as a CUDA-graph replay (20 launches) of
                  the flagship plan's base knobs into a fresh init batch
                  of B=100,000 lanes
  put_rows_ms     the node scatter (the step's largest put_rows_ call: 16
                  node-state leaves, in place) as a CUDA-graph replay (50
                  launches) on the operands of the same step 512
  node_gather_ms  the node slice (the step's node_gather call: 16 leaves)
                  as a CUDA-graph replay (50 launches) on the operands of
                  the same step 512
  k1_keys_ms      all of the step's K1 key launches (the tree's own: every
                  threefry_keys split and fold_in of the step, and its
                  step_keys launch where it has one) replayed together as
                  a CUDA graph (50 steps' worth) on the operands of the
                  same step 512, a step's worth; `k1_key_launches` names
                  them
  raft_invariant_ms, raft_invariant_pairwise_ms
                  the Raft safety check as a CUDA-graph replay (50
                  launches) on the operands of the same step 512, in the
                  flagship's adjacent form and in the pairwise one
  run_fused_ms_per_step
                  the traced flagship (trace_cap=64) through run_fused:
                  512 steps to warm and capture, then 1536 steps timed on
                  the host clock to a synchronise

It prints one JSON line per measurement, then one line with each
metric's values by side, and exits nonzero without a CUDA GPU.
"""

import argparse
import json
import os
import subprocess
import sys
import time

B = 100_000


def graph_ms(fn, n):
    """Device time of one fn() call: n calls captured as one CUDA graph
    and replayed between CUDA events."""
    import torch
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    graph.replay()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / n


def clone(x):
    import torch
    if isinstance(x, torch.Tensor):
        return x.clone()
    if isinstance(x, dict):
        return {k: clone(v) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return type(x)(clone(v) for v in x)
    return x


# the K1 key launches of a step and the node slice: (wrapper, method);
# a tree without a wrapper or method has no such launch
KEY_METHODS = (("step_keys", "run"), ("threefry_keys", "split"),
               ("threefry_keys", "fold_in"))


def step_calls(rt, state):
    """(the largest put_rows_ call, the raft_invariant_check call, the
    node_gather call, [(wrapper, method, args, kwargs)] of the step's K1
    key launches) of the next step of `state`, run on a copy with the
    wrappers recorded: each call's operands, cloned before the call."""
    import torch
    import madsim_tpu_torch.models.raft as raft_mod
    from madsim_tpu_torch.core.state import map_state
    from madsim_tpu_torch.ops import kernels
    from madsim_tpu_torch.ops import node_rows as nr
    puts, checks, keys, gathers = [], [], [], []
    real_put, real_check = nr.put_rows_, raft_mod.raft_invariant_check
    wrappers = kernels.wrappers()

    def put_spy(writes):
        puts.append(clone(list(writes)))
        return real_put(writes)

    def check_spy(*args):
        checks.append(clone(args))
        return real_check(*args)

    spied = []
    for name, meth in KEY_METHODS + (("node_gather", "run"),):
        w = wrappers.get(name)
        if w is None or not hasattr(w, meth):
            continue
        real = getattr(w, meth)

        def spy(*args, _real=real, _w=w, _m=meth, **kw):
            (gathers if _m == "run" and _w is wrappers["node_gather"]
             else keys).append((_w, _m, clone(args), clone(kw)))
            return _real(*args, **kw)
        setattr(w, meth, spy)          # shadows the method
        spied.append((w, meth))
    nr.put_rows_, raft_mod.raft_invariant_check = put_spy, check_spy
    try:
        rt._step(map_state(torch.clone, state))
    finally:
        nr.put_rows_, raft_mod.raft_invariant_check = real_put, real_check
        for w, meth in spied:
            delattr(w, meth)
    return max(puts, key=len), checks[0], gathers[0], keys


def measure(tree: str) -> dict:
    """One measurement of the checkout at `tree` (run in a worker)."""
    sys.path.insert(0, os.path.abspath(tree))
    import numpy as np
    import torch
    from madsim_tpu_torch import interop, workloads
    from madsim_tpu_torch.core import prng
    from madsim_tpu_torch.ops import kernels
    from madsim_tpu_torch.ops.apply_knobs import apply_knobs
    from madsim_tpu_torch.ops.node_rows import put_rows_
    from madsim_tpu_torch.ops.raft_invariant import raft_invariant_check
    from madsim_tpu_torch.ops.sched_pick import sched_pick
    from madsim_tpu_torch.search import KnobPlan
    dev = torch.device("cuda")
    kernels.build_all(force=True)
    seeds = np.arange(B, dtype=np.uint32)

    rt = workloads.flagship_runtime(device=dev)
    s, _ = rt.run(rt.init_batch(seeds), 512, chunk=512)
    scatter, raft_args, gather, key_calls = step_calls(rt, s)
    pr = min(graph_ms(lambda: put_rows_(scatter), 50) for _ in range(2))
    gw, _, gargs, _ = gather
    ng = min(graph_ms(lambda: gw.run(*gargs), 50) for _ in range(2))

    def step_keys():
        for w, meth, args, kw in key_calls:
            getattr(w, meth)(*args, **kw)
    k1 = min(graph_ms(step_keys, 50) for _ in range(2))
    k1_names = [f"{w.symbol}.{meth}" for w, meth, _, _ in key_calls]
    del gather, gargs, key_calls
    ri = min(graph_ms(lambda: raft_invariant_check(*raft_args), 50)
             for _ in range(2))
    pairwise = raft_args[:-1] + (True,)
    rp = min(graph_ms(lambda: raft_invariant_check(*pairwise), 50)
             for _ in range(2))
    del scatter, raft_args, pairwise
    k_sched = prng.split(s.key, 5)[:, 1].contiguous()
    sel = tuple(x.clone() for x in (
        s.t_kind, s.t_node, s.t_deadline, s.t_tag, s.t_src, s.alive,
        s.paused, s.prio_nudge, s.halted, k_sched, s.sched_hash))
    del s
    sp = min(graph_ms(lambda: sched_pick(*sel), 50) for _ in range(2))
    del sel

    plan = KnobPlan.from_runtime(rt)
    guards, base = plan._device_tables(dev)
    kb = interop.knobs_to_torch(plan.base_batch(B), dev)
    st = rt.init_batch(seeds)
    cols = {n: getattr(st, n) for n in ("t_deadline", "t_kind", "t_node",
                                        "t_src", "t_tag", "t_payload")}
    args = (cols, st.tlimit, st.jitter, kb, base, guards, plan.n_init,
            plan.jitter_gate)
    ak = min(graph_ms(lambda: apply_knobs(*args), 20) for _ in range(2))
    del st, cols, args, rt

    rt = workloads.flagship_runtime(device=dev, trace_cap=64)
    s = rt.run_fused(rt.init_batch(seeds), 512, chunk=512)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    s = rt.run_fused(s, 1536, chunk=512)
    torch.cuda.synchronize()
    fused = (time.perf_counter() - t0) / 1536 * 1e3
    check = not bool(s.crashed.any())
    return dict(sched_pick_ms=sp, apply_knobs_ms=ak, put_rows_ms=pr,
                node_gather_ms=ng, k1_keys_ms=k1, k1_key_launches=k1_names,
                raft_invariant_ms=ri, raft_invariant_pairwise_ms=rp,
                run_fused_ms_per_step=fused, no_crash=check)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("old")
    ap.add_argument("new")
    ap.add_argument("--pairs", type=int, default=2)
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    a = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_kernel_ab: no CUDA device is available",
              file=sys.stderr)
        return 2
    if a.worker:
        print(json.dumps(measure(a.worker)), flush=True)
        return 0
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi.splitlines()[0], flush=True)
    order = []
    for p in range(a.pairs):
        order += [("old", a.old), ("new", a.new)] if p % 2 == 0 else \
            [("new", a.new), ("old", a.old)]
    by_side: dict = {"old": [], "new": []}
    for side, tree in order:
        out = subprocess.run(
            [sys.executable, os.path.abspath(__file__), a.old, a.new,
             "--worker", tree], capture_output=True, text=True)
        if out.returncode != 0:
            print(out.stdout, out.stderr, file=sys.stderr)
            return 1
        m = json.loads(out.stdout.strip().splitlines()[-1])
        by_side[side].append(m)
        print(json.dumps(dict(side=side, tree=tree, **m)), flush=True)
    print(json.dumps({side: {k: [m[k] for m in ms] for k in ms[0]}
                      for side, ms in by_side.items()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
