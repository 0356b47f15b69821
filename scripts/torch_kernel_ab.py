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
  emit_write_ms   the emission write (in place) on the operands of the
                  same step 512: a CUDA graph of 20 restore-then-write
                  calls less one of the 20 restores alone (chip_smoke's
                  way), the least of two
  emit_write_traced_ms
                  the same on the operands of step 512 of the traced
                  flagship (trace_cap=64, through run_fused): the write
                  with its ring epilogue, chip_smoke's plane-off K5 row
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
  k1_ms           all of the step's K1 launches (keys and draws: the
                  tree's step_keys, dup_draws, split_randint,
                  threefry_keys and threefry_draw calls of the step)
                  replayed together the same way; `k1_launches` names them
  apply_super_ms  the supervisor op as a CUDA-graph replay of 20 calls,
                  each on its own copy of the leaves it writes (chip_smoke
                  `super_apply_ms`), at the operands of the same step 512
                  with no op lane (`no_op_lanes`), as they are
                  (`step_512`) and with every lane a RESTART
                  (`every_lane_restart`)
  apply_super_conn_ms
                  the same on the supervisor op's operands at step 512 of
                  the connfault mix workload (minipg over conn + stream,
                  B=16,384; `workloads.connfault_runtime("mix")`), as
                  they are and with every lane a RESET_PEER of node
                  lane % 3: the call with everything the tree runs for
                  it (a kernel with the reset-peer tear inside it, or a
                  kernel and the plain tear after it). The new tree
                  saves the operands as numpy (state, op lanes, the
                  schema's defaults and persist mask) and each tree
                  builds its own plan from them; a tree without
                  `workloads.connfault_runtime` is measured on them all
                  the same
  dup_section_ms  the device ms a step of the eager step's dup section
                  (its `live_step.dup` profiler range, split as chip_smoke
                  `section_split` splits it) over 16 profiled steps from
                  the same step 512; `sections_ms` holds every section
  raft_invariant_ms, raft_invariant_pairwise_ms
                  the Raft safety check as a CUDA-graph replay (50
                  launches) on the operands of the same step 512, in the
                  flagship's adjacent form and in the pairwise one
  run_fused_ms_per_step
                  the traced flagship (trace_cap=64) through run_fused:
                  512 steps to warm and capture, then 1536 steps timed on
                  the host clock to a synchronise
  fingerprint_ms  the state fingerprint as a CUDA-graph replay (20
                  launches) on that traced flagship's state at step 2048
                  (its fingerprinted leaves are the untraced flagship's:
                  49 leaves, 6,895 bytes a lane)
  mutate_ms       the havoc mutation as a CUDA-graph replay (20 launches)
                  on the operands of the flagship fuzzer's first mutated
                  round at B=100,000, havoc 3 (chip_smoke's
                  `flagship_round_2`: its parents, key and guards), which
                  one run of the new tree's fuzzer captures before the
                  measurements and every measurement loads

It prints one JSON line per measurement, then one line with each
metric's values by side, and exits nonzero without a CUDA GPU.
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
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
    from madsim_tpu_torch.core.state import SimState, map_state
    if isinstance(x, SimState):
        return map_state(torch.clone, x)
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
# the step's K1 draws beside its keys
DRAW_METHODS = (("dup_draws", "run"), ("split_randint", "run"),
                ("threefry_draw", "randint"), ("threefry_draw", "uniform"),
                ("threefry_draw", "bernoulli"))


def smoke():
    """This checkout's chip_smoke.py as a module (its timing and section
    helpers import nothing of the port at load time)."""
    import importlib.util
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_here", os.path.join(here, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def step_calls(rt, state):
    """(the largest put_rows_ call, the raft_invariant_check call, the
    node_gather call, [(wrapper, method, args, kwargs)] of the step's K1
    key launches, the same of its K1 draws, the apply_super call) of the
    next step of `state`, run on a copy with the wrappers recorded: each
    call's operands, cloned before the call."""
    import torch
    import madsim_tpu_torch.core.step as step_mod
    import madsim_tpu_torch.models.raft as raft_mod
    from madsim_tpu_torch.core.state import map_state
    from madsim_tpu_torch.ops import kernels
    from madsim_tpu_torch.ops import node_rows as nr
    puts, checks, keys, draws, gathers, supers = [], [], [], [], [], []
    real_put, real_check = nr.put_rows_, raft_mod.raft_invariant_check
    real_super = step_mod.apply_super
    wrappers = kernels.wrappers()

    def put_spy(writes):
        puts.append(clone(list(writes)))
        return real_put(writes)

    def check_spy(*args):
        checks.append(clone(args))
        return real_check(*args)

    def super_spy(*args):
        supers.append(clone(args))
        return real_super(*args)

    spied = []
    for name, meth in KEY_METHODS + DRAW_METHODS + (("node_gather", "run"),):
        w = wrappers.get(name)
        if w is None or not hasattr(w, meth):
            continue
        real = getattr(w, meth)
        into = (gathers if name == "node_gather" else
                keys if (name, meth) in KEY_METHODS else draws)

        def spy(*args, _real=real, _w=w, _m=meth, _into=into, **kw):
            _into.append((_w, _m, clone(args), clone(kw)))
            return _real(*args, **kw)
        setattr(w, meth, spy)          # shadows the method
        spied.append((w, meth))
    nr.put_rows_, raft_mod.raft_invariant_check = put_spy, check_spy
    step_mod.apply_super = super_spy
    try:
        rt._step(map_state(torch.clone, state))
    finally:
        nr.put_rows_, raft_mod.raft_invariant_check = real_put, real_check
        step_mod.apply_super = real_super
        for w, meth in spied:
            delattr(w, meth)
    return (max(puts, key=len), checks[0], gathers[0], keys, draws,
            supers[0])


def emit_ms(args):
    """Device ms of one emit_write call on `args` (it writes its tables
    in place: each call restores them first, and the restores alone are
    subtracted)."""
    from madsim_tpu_torch.ops.emit_write import emit_write
    live = clone(args)
    pairs = [(live[0][k], args[0][k]) for k in args[0]]
    if args[3] is not None:
        pairs += [(live[3]["cols"][k], args[3]["cols"][k])
                  for k in args[3]["cols"]]

    def restore():
        for dst, src in pairs:
            dst.copy_(src)
    return min(graph_ms(lambda: (restore(), emit_write(*live)), 20)
               - graph_ms(restore, 20) for _ in range(2))


def super_ms(args):
    """{operands: ms} of the tree's supervisor op at `args` (the step's
    call) with no op lane, as it is, and with every lane a RESTART: each
    timed as chip_smoke `super_apply_ms` times it (20 calls in a graph,
    each on its own copy of the leaves the op writes)."""
    import torch
    from madsim_tpu_torch.core.step import apply_super
    cs = smoke()
    plan, s, op, node = args[:4]
    n = plan.cfg.n_nodes
    lanes = torch.arange(op.shape[0], device=op.device, dtype=op.dtype)
    out = {}
    for name, o, nd in (
            ("no_op_lanes", torch.zeros_like(op), node.clamp(0, n - 1)),
            ("step_512", op, node),
            ("every_lane_restart", torch.full_like(op, 3), lanes % n)):
        out[name] = cs.super_apply_ms(apply_super,
                                      (plan, s, o, nd) + tuple(args[4:]))[0]
    return out


def sections_ms(rt, state):
    """{section: device ms a step} of 16 eager steps of `state` (on a
    copy) under torch.profiler, split as this checkout's chip_smoke
    `section_split` splits them; None where the trace holds no section."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from madsim_tpu_torch.core.state import map_state
    cs = smoke()
    s = map_state(torch.clone, state)
    s, _ = rt.run(s, 16, chunk=16)        # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        s, _ = rt.run(s, 16, chunk=16)
        torch.cuda.synchronize()
    return cs.section_split(prof, 16)[0]


class _Captured(Exception):
    """Ends the fuzzer once its first mutation's operands are taken."""


CONN_B = 16_384


def prepare_conn(path: str) -> None:
    """Save the supervisor op's operands at step 512 of the connfault mix
    workload (this checkout's) to `path`, as numpy: the state's leaves,
    the op lanes, the schema's defaults and persist mask and the config's
    sizes."""
    import pickle
    import numpy as np
    import torch
    from madsim_tpu_torch import interop, workloads
    rt = workloads.connfault_runtime("mix", device=torch.device("cuda"))
    s = rt.run_fused(rt.init_batch(np.arange(CONN_B, dtype=np.uint32)),
                     512, chunk=256)
    plan, st, op, node, src, payload, key = smoke().super_operands(rt, s)
    with open(path, "wb") as f:
        pickle.dump(dict(
            leaves=interop.state_to_numpy(st),
            lanes=[t.cpu().numpy() for t in (op, node, src, payload, key)],
            spec={k: v.cpu().numpy() for k, v in plan.spec_default.items()},
            persist=dict(plan.persist_mask),
            sizes=(rt.cfg.n_nodes, rt.cfg.event_capacity,
                   rt.cfg.payload_words)), f)


def super_conn_ms(path: str) -> dict:
    """{operands: ms} of this tree's supervisor op on the saved connfault
    operands (prepare_conn), as they are and with every lane a
    RESET_PEER, timed as `super_ms` times the flagship's."""
    import pickle
    import torch
    from madsim_tpu_torch import SimConfig, interop
    from madsim_tpu_torch.core.step import apply_super
    from madsim_tpu_torch.ops.apply_super import SuperPlan
    dev = torch.device("cuda")
    with open(path, "rb") as f:
        d = pickle.load(f)
    n, c, p = d["sizes"]
    cfg = SimConfig(n_nodes=n, event_capacity=c, payload_words=p)
    plan = SuperPlan(cfg, {k: torch.as_tensor(v, device=dev)
                           for k, v in d["spec"].items()}, d["persist"])
    s = interop.state_from_numpy(d["leaves"], dev)
    op, node, src, payload, key = (torch.as_tensor(x, device=dev)
                                   for x in d["lanes"])
    lanes = torch.arange(op.shape[0], device=dev, dtype=op.dtype)
    cs = smoke()
    out = {}
    for name, o, nd in (
            ("step_512", op, node),
            ("every_lane_reset_peer", torch.full_like(op, 18), lanes % n)):
        out[name] = cs.super_apply_ms(
            apply_super, (plan, s, o, nd, src, payload, key))[0]
    return out


def prepare(tree: str, path: str) -> None:
    """Run the fuzzer of the checkout at `tree` on the flagship as
    chip_smoke's fuzz_flagship runs it, up to its first mutation, and save
    that call's operands (on the CPU) to `path`; and the connfault
    operands (prepare_conn) to `path`.conn."""
    sys.path.insert(0, os.path.abspath(tree))
    import torch
    from madsim_tpu_torch import workloads
    from madsim_tpu_torch.search import fuzz
    from madsim_tpu_torch.search import mutate as mutate_mod
    cs = smoke()
    real = mutate_mod.mutate_batch

    def spy(knobs, key, guards, havoc, mask=None):
        torch.save(to_cpu((knobs, key, guards, havoc, mask)), path)
        raise _Captured

    rt = workloads.flagship_runtime(device=torch.device("cuda"))
    mutate_mod.mutate_batch = spy
    try:
        fuzz(rt, max_steps=cs.FUZZ_STEPS, batch=B, max_rounds=cs.FUZZ_ROUNDS,
             havoc=cs.FUZZ_HAVOC, chunk=cs.FLAG_CHUNK, fused=True)
    except _Captured:
        pass
    finally:
        mutate_mod.mutate_batch = real
    if not os.path.exists(path):
        raise RuntimeError("prepare: the fuzzer never mutated")
    prepare_conn(path + ".conn")


def to_device(x, dev):
    """A tree of tensors copied to `dev`."""
    import torch
    if isinstance(x, torch.Tensor):
        return x.to(dev, copy=True)
    if isinstance(x, dict):
        return {k: to_device(v, dev) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return type(x)(to_device(v, dev) for v in x)
    return x


def to_cpu(x):
    return to_device(x, "cpu")


def measure(tree: str, operands: str) -> dict:
    """One measurement of the checkout at `tree` (run in a worker);
    `operands` holds the fuzzer's first mutation's operands."""
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
    from madsim_tpu_torch.search import mutate as mutate_mod
    from madsim_tpu_torch.utils.hashing import fingerprint
    dev = torch.device("cuda")
    kernels.build_all(force=True)
    seeds = np.arange(B, dtype=np.uint32)

    rt = workloads.flagship_runtime(device=dev)
    s, _ = rt.run(rt.init_batch(seeds), 512, chunk=512)
    scatter, raft_args, gather, key_calls, draw_calls, super_args = \
        step_calls(rt, s)
    import madsim_tpu_torch.core.step as step_mod
    ew = emit_ms(smoke().step_operands(rt, s, step_mod, "emit_write"))
    pr = min(graph_ms(lambda: put_rows_(scatter), 50) for _ in range(2))
    gw, _, gargs, _ = gather
    ng = min(graph_ms(lambda: gw.run(*gargs), 50) for _ in range(2))

    def step_keys():
        for w, meth, args, kw in key_calls:
            getattr(w, meth)(*args, **kw)
    k1 = min(graph_ms(step_keys, 50) for _ in range(2))
    k1_names = [f"{w.symbol}.{meth}" for w, meth, _, _ in key_calls]

    def step_k1():
        for w, meth, args, kw in key_calls + draw_calls:
            getattr(w, meth)(*args, **kw)
    k1_all = min(graph_ms(step_k1, 50) for _ in range(2))
    k1_all_names = k1_names + [f"{w.symbol}.{meth}"
                               for w, meth, _, _ in draw_calls]
    del gather, gargs, key_calls, draw_calls
    asup = super_ms(super_args)
    del super_args
    sections = sections_ms(rt, s)
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
    ew_tr = emit_ms(smoke().step_operands(rt, s, step_mod, "emit_write"))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    s = rt.run_fused(s, 1536, chunk=512)
    torch.cuda.synchronize()
    fused = (time.perf_counter() - t0) / 1536 * 1e3
    check = not bool(s.crashed.any())
    fp = min(graph_ms(lambda: fingerprint(s), 20) for _ in range(2))
    del s, rt

    margs = to_device(torch.load(operands), dev)
    mut = min(graph_ms(lambda: mutate_mod.mutate_batch(*margs), 20)
              for _ in range(2))
    asup_conn = super_conn_ms(operands + ".conn")
    return dict(sched_pick_ms=sp, emit_write_ms=ew,
                emit_write_traced_ms=ew_tr, apply_knobs_ms=ak,
                put_rows_ms=pr,
                node_gather_ms=ng, k1_keys_ms=k1, k1_key_launches=k1_names,
                k1_ms=k1_all, k1_launches=k1_all_names,
                apply_super_ms=asup, apply_super_conn_ms=asup_conn,
                dup_section_ms=sections["dup"] if sections else None,
                sections_ms=sections,
                raft_invariant_ms=ri, raft_invariant_pairwise_ms=rp,
                run_fused_ms_per_step=fused, no_crash=check,
                fingerprint_ms=fp, mutate_ms=mut,
                mutate_lanes=int(margs[0]["row_time"].shape[0]),
                mutate_havoc=int(margs[3]))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("old")
    ap.add_argument("new")
    ap.add_argument("--pairs", type=int, default=2)
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    ap.add_argument("--prepare", help=argparse.SUPPRESS)
    ap.add_argument("--operands", help=argparse.SUPPRESS)
    a = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_kernel_ab: no CUDA device is available",
              file=sys.stderr)
        return 2
    if a.prepare:
        prepare(a.prepare, a.operands)
        return 0
    if a.worker:
        print(json.dumps(measure(a.worker, a.operands)), flush=True)
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
    with tempfile.TemporaryDirectory() as tmp:
        operands = os.path.join(tmp, "mutate_operands.pt")
        me = [sys.executable, os.path.abspath(__file__), a.old, a.new,
              "--operands", operands]
        out = subprocess.run(me + ["--prepare", a.new], capture_output=True,
                             text=True)
        if out.returncode != 0:
            print(out.stdout, out.stderr, file=sys.stderr)
            return 1
        for side, tree in order:
            out = subprocess.run(me + ["--worker", tree],
                                 capture_output=True, text=True)
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
