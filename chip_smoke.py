#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (madsim_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA GPU and nvcc.
It builds the port's CUDA kernels from csrc/, then drives the port's main
paths — the golden workloads and the batched 5-node Raft chaos sweep at
B=100,000 lanes, through the eager chunked runner `Runtime.run` and the
CUDA-graph runner `Runtime.run_fused`, and the schedule search entry
points `fuzz`, `explore` and `pct_sweep` on the same sweep — and holds
every kernel against its plain PyTorch version and the engine against
the frozen golden digests. One JSON object per line, in phases:

  device       torch / CUDA versions, the card's name and power limit
  build        nvcc of every kernel source, in parallel, with ptxas stats
               (each kernel's registers, static shared memory and spills)
  golden       the frozen golden workloads (pingpong with the flight
               recorder, trace_cap=64: 64 seeds, 4000 steps, chunk 256;
               wal_kv: 32 seeds, 30,000 steps, chunk 512), each through
               Runtime.run and Runtime.run_fused from one initial state:
               all 342 leaf digests must equal
               tests/data/golden_r22_leaves.json, and the initial state's
               digests must be the same after both runs as before (the
               step writes its input in place; the runners step a copy)
  flagship     bench.py's Raft chaos config at B=100,000 for 2048 steps
               (chunk 512) through Runtime.run: no crash, no overflow,
               >90% of lanes live; seed-events/s, ms/step, peak memory
  no_plain_draws  one eager flagship step on the card at step 512 with
               every function of core/prng.py (wherever the port binds
               it) and select.put_row wrapped: no plain threefry call and
               no one-hot put_row on node_state, t_kind or t_deadline (the
               fused phase checks the same on the traced step)
  fused        the same config with the flight recorder on every lane
               (trace_cap=64), B=100,000, 2048 steps, through run_fused:
               no crash or overflow, >90% live, fingerprints equal to the
               flagship phase's (the recorder changes no other leaf), lane
               0's ring non-empty with increasing steps; ms/step beside
               the eager runner's; the K1/K4 launches a step the graph
               captured, equal to the eager step's
  step_bound   the bytes one traced flagship step must move at step 512
               (B=100,000): every state leaf the step reads, read once,
               and every leaf it changes, written once; its bound at the
               card's memory rate (the K7 row of PERF.md); and K4's (the
               node-state row slice and scatter and the payload row)
  fused_wal_kv the wal_kv golden config at B=100,000 through run_fused:
               no crash, every lane halted, lanes 0..31 reproduce the 91
               frozen run_fused digests; the step kernels' operands are
               taken at step 40 of this batch for the kernel phase
  fuzz_flagship  the coverage-guided fuzzer on the flagship at B=100,000:
               3 rounds of 1024 steps, havoc 3, through run_fused; per
               round its wall seconds, the host wall seconds of its
               run_fused call (to a synchronise) and its host (corpus)
               seconds; seed-events/s count no warm-up step;
               apply_knobs launched once per round, mutate once per round
               launched on a non-empty corpus (the reference's pipeline
               launches round 1 before it reads round 0), the step kernels
               once per step
  explore_flagship  blind sweeps at B=100,000, 2 rounds of 1024 steps:
               coverage_digest launched once per round, each digest equal
               to np.unique of the round's schedule hashes
  pct_flagship  seed 0 under 100,000 distinct nonzero PCT nudges, 512 steps
               (the select kernel's nudged path at full width)
  search_same_on_both  one fixed-seed campaign on the saturating runtime
               (bench.py's search A/B shape: 6 rounds of 128 lanes, 1500
               steps) on the card and on the CPU: equal results and equal
               corpora; the fuzzer finds more schedules than blind explore
               on the same budget
  flagship_same_on_both  the traced flagship (trace_cap=64) at B=203,
               256 steps, through run and run_fused on the card and run
               on the CPU: every leaf equal; the card's eager run launches
               each step kernel its count a step, the CPU run none
  kernel       each kernel against its plain version, exactly equal
               (the kernel's time is device time: launches captured in a
               CUDA graph and replayed between events):
               sched_pick on edge-case tables (B=100,000; B=1;
               B=100,003; C=33 and C=256 with N=32; warp tiles that mix
               nudged, halted, tied, one-candidate, empty and parked
               lanes; every lane halted; tables not 16-byte aligned, which
               the kernel copies 4 bytes at a time) and on tables captured
               from the flagship at steps 0, 512, 2048, from wal_kv at
               B=100,000, C=256, step 40 and from PCT's nudged run, with
               its registers a thread and resident blocks an SM (the
               occupancy API) beside its time as a graph replay and inside
               the profiled flagship graph; emit_write on edge-case
               operands at C=96 and C=256 (full tables, masked
               emissions, clogged links, loss 0 and 1, jitter, skew, disk
               delay, a wrapping ring) and on operands captured from the
               traced flagship at steps 0 and 512 and from wal_kv at
               step 40 (32 golden lanes, and B=100,000), kernel and plain
               version each writing a copy of the same operands in place:
               every table and ring leaf equal, and no row written that
               an emission did not take; kernel and plain times, each a
               CUDA graph (plain: eager calls) of restore-then-write less
               the restore alone, the kernel's own time inside the
               profiled flagship graph, and the bound from the bytes the
               write needs;
               mutate, apply_knobs and coverage_digest on the flagship's
               own operands at B=100,000 (the first mutated fuzz round's
               parents and key, the last round's init state and knobs,
               explore's first schedule hashes; mutate also on that
               round's operands cut to its tile + 1 and to 4099 lanes,
               masked, and with row_time one element off a 16-byte
               boundary, which turns its 16-byte copies off; its tile and
               dynamic shared memory beside its time) and on edge cases
               (havoc 0,
               1 and 6, masked; a plan with value, direction, torn, pool
               and dup rows; foreign knobs out of every bound; hashes with
               the top bit set, all equal, all distinct, one lane, B=1,
               a tile and one key either side of it, random B=100,000),
               with kernel, plain and (coverage_digest: torch.unique)
               library times and bounds, and coverage_digest's kernel
               launches and memsets per call; apply_knobs writes in
               place, so kernel and plain version each write a copy of a
               case's columns (one case per plan with random garbage in
               every row, one with a payload not 16-byte aligned, which
               the kernel writes a word at a time): every column equal,
               the returned columns the ones handed in, no row outside
               [n_init, n_init + R + D) changed; being idempotent, it is
               timed by replaying it on the same operands;
               raft_invariant on the flagship's operands at steps 0, 512
               and 2048 (B=100,000) in both static forms and on edge
               cases (words over the whole int32 range, equal logs, ties
               in the effective commit, one entry that differs at the
               common commit point, a commit past the log, two leaders
               of one term, window points that wrap, snapshots, a peer
               mask; L=8 and 32, N=3, 5, 8, 16 and 32, one to eight
               field columns, B=1, 37, 4096, 4101 and 100,003; every
               operand one element off a 16-byte boundary (the log rows
               then read 4 bytes an access) or one lane off);
               apply_super on the flagship's operands at steps 0 and 512,
               wal_kv's at step 40 (B=100,000: its fs flush runs beside
               the kernel), the step-512 operands with no op lane and with
               every lane a RESTART, and edge cases (every opcode 0-19 and
               an unknown one, NODE_RANDOM with and without a pool and
               with an empty one, src out of range, RESTARTs of torn, live
               nodes; the Raft schema at B=4096, 1003 and 1, the fs +
               conn/stream schema at B=100,000, int32, bool and zero-size
               leaves with N=7 and N=32, C=100 and C=33), kernel and
               plain version
               each on a copy: every leaf and return value equal, the
               state written in place, no node row but the target's and no
               table row but the target's written; timed as a CUDA graph
               of 20 calls, each on its own copy of the leaves the op
               writes, restored outside the timed replay, at the three
               step-512 operands (no op lane, as they are, every lane a
               RESTART: its time against its op count);
               fingerprint on the flagship's state at step 2048 (also
               with its payload one element and its halted leaf one byte
               off a 16-byte boundary, and cut to one lane and to its
               tile + 1 lanes), the golden pingpong (traced) and wal_kv
               states and wal_kv's with zero-size leaves added, with its
               tile and dynamic shared memory beside its time;
               step_keys, dup_draws, split_randint, threefry_keys,
               threefry_draw, node_gather and put_rows_ on every call of
               the flagship's step 512, the torn-write flush's calls of
               wal_kv's step 40, and on edge operands (keys (0, 0) and all
               ones; the dup section with dup rates 0 and at the cap,
               equal and inverted latency bounds, invalid lanes,
               non-message kinds, now past the time limit, keys off an
               8-byte boundary, strided lanes, B=1 and B=100,003; the
               handlers' split and draw with equal, inverted and extreme
               bounds, strided keys and keys off an 8-byte boundary, one
               key and B=100,003; the step's fused
               keys at extension widths 2-5 and 9, with halted lanes,
               keys off an 8-byte boundary or strided, extreme dup
               words, B=1 and B=100,003; split into 1, 2, 5, 8, 9 and 16,
               one key, B=100,003, a strided slice; fold_in words 0,
               2^32-1, two a key, one a key; randint bounds with maxval
               <= minval, the whole int32 range, per key, broadcast,
               inclusive INT32_MAX, a vector draw; bernoulli p 0, 1,
               subnormal, per key; every row index and out of range,
               masked-off lanes, fifty leaves of five element types, the
               node slice with every leaf one element or one lane off a
               16-byte boundary, at B=1 and B=4099, at the int32
               extremes, longer rows of every element size, twenty
               writes; the node scatter with destinations or sources one
               element or one lane off a 16-byte boundary, broadcast
               sources, at B=1 and B=4099, under three (idx, mask) pairs,
               an all-false mask and every index out of range), the
               in-place put_rows_ on its own copy against the plain
               version's: equal, and no row touched it must not touch;
               timed on the step's own calls (the fused keys, the dup
               section, the handlers' first split and draw, the node
               slice, the node scatter; wal_kv's flush split and draw),
               and a flagship step's K1 launches (step_keys, dup_draws
               and the handlers' two split_randint) timed together
  determinism  lanes 0..4095 alone, twice through run (512 steps) and
               twice through run_fused (2048 steps): fingerprints equal
               to each other and to lanes 0..4095 of the B=100,000 eager
               run at the same step (each Runtime.fingerprints call
               launches the fingerprint kernel once)
  profile      torch.profiler over 16 flagship steps at B=100,000, for
               each runner: device kernels per step, device busy share,
               top kernels, each step kernel's ms a step; each kernel's
               device events in the trace must number its launches
               (replays counted on the card); no int32 scan kernel left
               in the step; for the eager runner, the device time of each
               section of the step, which must add up to the device busy
               time within 2% (a hand-written kernel counted in the
               section whose device-side annotation spans its start),
               also with the threefry draws and the node rows as plain
               PyTorch, and with the supervisor op and the Raft check as
               plain PyTorch (the paths before each pair of kernels)
  handler_split  the handlers section's ranges (the slice, each program's
               init / on_message / on_timer, the merge), kernels and
               plain K1/K4 paths, outside the 2% sum
  kernels      one line naming every kernel with its numbers

Each main path runs with every kernel's launch count set to 0 just before
and read just after; a kernel of the path that was not launched once per
step fails the run (raft_invariant runs on the Raft paths only: on the
pingpong and wal_kv paths it must not launch at all), and so does a
K1/K4 kernel not launched exactly its count a step (one eager step of the
path's runtime, counted beforehand; step_keys and dup_draws once,
node_gather and put_rows_ at least once; a flagship step launches
split_randint twice and neither threefry_keys nor threefry_draw, which
run on wal_kv's step, and every K1/K4 kernel must run on some path). A
CUDA-graph replay
launches the kernels it captured without calling their wrappers, so
run_fused's launches are the wrappers' own counts (the warm-up step
before a capture) plus the launches captured per block times the
replays; the profile phase counts the replayed launches on the card too.
Any failed check raises: the script exits nonzero and prints no result.
Its last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
It needs no network and imports no JAX.
"""

import json
import os
import subprocess
import sys
import time

FLAG_B = 100_000
FLAG_STEPS = 2048
FLAG_CHUNK = 512
FUZZ_STEPS = 1024           # fuzz_flagship and explore_flagship rounds
FUZZ_ROUNDS = 3
FUZZ_HAVOC = 3
EXPLORE_ROUNDS = 2
PCT_STEPS = 512
SAME_B, SAME_STEPS = 203, 256   # flagship_same_on_both
# the saturating campaign run on the card and on the CPU (bench.py's
# search A/B shape); dry_rounds past max_rounds: every round runs
SAT = dict(max_steps=1500, batch=128, max_rounds=6, chunk=256, rng_seed=7)
EDGE_B = 4096
STEP_KERNELS = ("emit_write", "sched_pick", "raft_invariant", "apply_super")
DET_B = 4096
DET_EAGER_STEPS = FLAG_CHUNK   # the eager determinism passes (host-bound)
PROF_STEPS = 16
PROF_WINDOWS = 3     # traced windows at most, when records go missing
HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory (data sheet)
# H100 SXM float32 peak outside the tensor cores (data sheet), taken as
# the rate of the kernels' 32-bit integer operations: the card's int32
# rate is no higher, so the bound it gives is a true lower bound
INT32_OPS_PER_S = 67e12


def emit(**obj):
    print(json.dumps(obj), flush=True)


def check(cond, what):
    if not cond:
        raise AssertionError(what)


def cuda_ms(fn, n):
    """Mean device time of `fn` over n calls (after one warm-up call)."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(n):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / n


def graph_ms(fn, n):
    """Device time of one `fn()` call: n calls captured as one CUDA graph
    and replayed between CUDA events, so no host time falls between the
    launches (a small kernel launched from Python is otherwise timed at
    the host's issue rate)."""
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
    del graph
    return t0.elapsed_time(t1) / n


def select_inputs(state):
    """The sched_pick operands the next step of `state` would launch with
    (k_sched is the second of the step's five key splits)."""
    from madsim_tpu_torch.core import prng
    k_sched = prng.split(state.key, 5)[:, 1].contiguous()
    return tuple(x.clone() for x in (
        state.t_kind, state.t_node, state.t_deadline, state.t_tag,
        state.t_src, state.alive, state.paused, state.prio_nudge,
        state.halted, k_sched, state.sched_hash))


def bound_bytes(t_kind, t_node, t_deadline, t_tag, t_src, alive, paused,
                prio_nudge, halted, k_sched, sched_hash) -> int:
    """The bytes the select must move for these inputs, each read or
    written once: every lane's t_kind and t_deadline rows; its t_node row
    only where a node of the lane is alive and paused (else no row can be
    parked); the picked row of t_node, t_tag and t_src, and for a nudged
    lane the t_tag and t_node of every tied row; the per-lane inputs; and
    the outputs (idx, dmin, valid, any_ev, hash, the picked row's four
    fields)."""
    import torch
    from madsim_tpu_torch.ops.sched_pick import eligible_min, sched_pick_plain
    B, C = t_kind.shape
    N = alive.shape[1]
    _, at_min, _ = eligible_min(t_kind, t_node, t_deadline, alive, paused)
    idx = sched_pick_plain(t_kind, t_node, t_deadline, t_tag, t_src, alive,
                           paused, prio_nudge, halted, k_sched,
                           sched_hash)[0]
    # rows each lane needs of t_tag (and of t_node, unless it reads the row)
    picked_tied = at_min.gather(1, idx[:, None].long())[:, 0]
    tied = at_min.sum(1) + (~picked_tied).long()
    rows = torch.where(prio_nudge != 0, tied, 1)
    node_rows = torch.where((alive & paused).any(1), C, rows)
    per_lane = 2 * C * 4 + 2 * N + 4 + 1 + 2 * 4 + 2 * 4 + 4
    outputs = 4 + 4 + 1 + 1 + 2 * 4 + 4 * 4
    return B * (per_lane + outputs) + 4 * int((rows + node_rows).sum())


def edge_inputs(dev, B, C, N, seed=0):
    """Random tables with the lanes the select must get right: nothing
    eligible, one candidate, all C rows tied, nudged lanes, halted lanes,
    paused nodes and T_INF deadlines."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    kind = rng.integers(0, 4, (B, C)).astype(np.int32)
    kind[rng.random((B, C)) < 0.4] = 0
    node = rng.integers(-1, N + 1, (B, C)).astype(np.int32)
    dl = rng.integers(0, 40, (B, C)).astype(np.int32)
    dl[rng.random((B, C)) < 0.05] = 2 ** 31 - 1
    tag = rng.integers(-2 ** 31, 2 ** 31 - 1, (B, C)).astype(np.int32)
    src = rng.integers(0, N, (B, C)).astype(np.int32)
    alive = rng.random((B, N)) < 0.8
    paused = rng.random((B, N)) < 0.3
    nudge = np.where(rng.random(B) < 0.2,
                     rng.integers(-2 ** 31, 2 ** 31 - 1, B), 0).astype(
                         np.int32)
    halted = rng.random(B) < 0.05
    keys = rng.integers(-2 ** 31, 2 ** 31 - 1, (B, 2)).astype(np.int32)
    hashes = rng.integers(-2 ** 31, 2 ** 31 - 1, (B, 2)).astype(np.int32)
    kind[0::97] = 0                              # nothing eligible
    kind[1::97] = 0
    kind[1::97, C // 2] = 1                      # one candidate
    kind[2::97] = 2                              # all C rows tied
    dl[2::97] = 11
    alive[2::97], paused[2::97] = True, False
    kind[3::97] = 2                              # tied and nudged
    dl[3::97] = 11
    nudge[3::97] = 77
    return tuple(torch.as_tensor(a, device=dev) for a in (
        kind, node, dl, tag, src, alive, paused, nudge, halted, keys,
        hashes))


def mixed_tile_inputs(dev, B, C, N, seed):
    """edge_inputs whose lanes take seven kinds in turn, so that every
    warp tile of the kernel mixes them: nudged, halted, all C rows tied,
    one candidate, nothing eligible, every node alive and paused (only
    supervisor rows eligible), tied and nudged."""
    import torch
    (kind, node, dl, tag, src, alive, paused, nudge, halted, keys,
     hashes) = edge_inputs(dev, B, C, N, seed)
    turn = torch.arange(B, device=dev) % 7
    nudge = torch.where((turn == 0) | (turn == 6),
                        torch.where(nudge != 0, nudge, 12345), 0)
    halted = turn == 1
    tied = (turn == 2) | (turn == 6)
    kind[tied], dl[tied] = 2, 11
    alive[tied], paused[tied] = True, False
    kind[(turn == 3) | (turn == 4)] = 0
    kind[turn == 3, C // 2], dl[turn == 3, C // 2] = 1, 5
    paused[turn == 3] = False
    alive[turn == 5], paused[turn == 5] = True, True
    return (kind, node, dl, tag, src, alive, paused, nudge.to(torch.int32),
            halted, keys, hashes)


def unaligned(t):
    """A contiguous copy of `t` whose data starts one element past an
    allocation's start (4 bytes past a 16-byte boundary for int32): the
    kernels' fallback paths for tables they cannot copy 16 bytes at a
    time."""
    import torch
    flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = flat[1:].view(t.shape)
    out.copy_(t)
    return out


def lane_in(t):
    """A contiguous copy of `t` whose data starts one lane (t[0]'s
    elements) past an allocation's start: the offset a view of a batch
    without its first lane has."""
    import torch
    lane = t[0].numel() if t.shape[0] else 0
    flat = torch.empty(t.numel() + lane, dtype=t.dtype, device=t.device)
    out = flat[lane:].view(t.shape)
    out.copy_(t)
    return out


def clone_layout(x):
    """clone_tree that keeps each tensor's storage offset and strides (a
    fresh allocation laid out as the original is), so a copy of an
    operand that starts off a 16-byte boundary does too."""
    import torch
    if isinstance(x, (tuple, list)):
        return type(x)(clone_layout(v) for v in x)
    if not isinstance(x, torch.Tensor) or not x.numel() \
            or not x.storage_offset():
        return clone_tree(x)
    size = x.storage_offset() + 1 + sum(
        (n - 1) * st for n, st in zip(x.shape, x.stride()))
    out = torch.empty(size, dtype=x.dtype, device=x.device).as_strided(
        x.shape, x.stride(), x.storage_offset())
    out.copy_(x)
    return out


def lanes_of(args, lanes):
    """The select operands of the given lanes only (contiguous copies)."""
    return tuple(a[lanes].contiguous() for a in args)


def clone_tree(x):
    """A deep copy of nested dicts / tuples / lists of tensors and
    SimStates."""
    import torch
    from madsim_tpu_torch.core.state import SimState, map_state
    if isinstance(x, SimState):
        return map_state(torch.clone, x)
    if isinstance(x, dict):
        return {k: clone_tree(v) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return type(x)(clone_tree(v) for v in x)
    return x.clone() if isinstance(x, torch.Tensor) else x


def flat_tree(x, prefix=""):
    """{path: tensor} over nested dicts / tuples of tensors (None skipped)."""
    out = {}
    if isinstance(x, dict):
        for k, v in x.items():
            out.update(flat_tree(v, f"{prefix}.{k}"))
    elif isinstance(x, (tuple, list)):
        for i, v in enumerate(x):
            out.update(flat_tree(v, f"{prefix}[{i}]"))
    elif x is not None:
        out[prefix] = x
    return out


def step_operands(rt, state, owner, name):
    """The operands the next step of `state` hands the kernel wrapper
    `owner.name`: the step runs once, on a copy of `state` (it writes its
    input in place), with a recording proxy in place of the wrapper (its
    launch is not on a counted path). Returns the arguments, cloned
    before the call."""
    import torch
    from madsim_tpu_torch.core.state import map_state
    seen = []
    real = getattr(owner, name)

    def spy(*args):
        seen.append(clone_tree(args))
        return real(*args)

    setattr(owner, name, spy)
    try:
        rt._step(map_state(torch.clone, state))
    finally:
        setattr(owner, name, real)
    check(len(seen) == 1, f"step_operands: the step did not call {name}")
    return seen[0]


def emit_operands(rt, state):
    """The emit_write operands of the next step of `state`: (tables, em,
    lane, ring, n_sends, use_jitter)."""
    import madsim_tpu_torch.core.step as step_mod
    return step_operands(rt, state, step_mod, "emit_write")


def raft_operands(rt, state):
    """The raft_invariant_check operands of the next step of `state`."""
    import madsim_tpu_torch.models.raft as raft_mod
    return step_operands(rt, state, raft_mod, "raft_invariant_check")


def super_operands(rt, state):
    """The apply_super operands of the next step of `state`: (plan, the
    state as the op finds it, op, node, src, payload, key)."""
    import madsim_tpu_torch.core.step as step_mod
    return step_operands(rt, state, step_mod, "apply_super")


def step_bytes(rt, state):
    """(read, written, changed leaves) of one step of `state`, in bytes:
    every state leaf the step reads — all but the eight ring columns,
    which it only writes — read once, and every leaf whose value the step
    changes written once, each at its full size. The step runs on a copy
    of `state`."""
    import torch
    from madsim_tpu_torch import interop
    from madsim_tpu_torch.core.state import map_state
    from madsim_tpu_torch.ops.emit_write import RING_COLS
    before = interop.state_leaves(state)
    out, _ = rt._step(map_state(torch.clone, state))
    after = interop.state_leaves(out)
    ring = {"." + k for k in RING_COLS}

    def size(t):
        return t.numel() * t.element_size()

    changed = [k for k, t in before.items()
               if t.numel() and not torch.equal(t, after[k])]
    read = sum(size(t) for k, t in before.items() if k not in ring)
    return read, sum(size(after[k]) for k in changed), changed


def emit_edge_operands(dev, B, C, N, P, E, n_sends, jitter, ring, prov,
                       seed):
    """Random emit_write operands with the lanes the kernel must get
    right: full tables (overflow), a few free rows, masked-off emissions,
    clogged nodes and links, loss 0 and 1, jitter, clock skew and disk
    delay, unsampled and idle lanes, and a ring that wraps."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    i32 = np.int32

    def ints(lo, hi, shape):
        return rng.integers(lo, hi, shape).astype(i32)

    kind = ints(0, 4, (B, C))
    kind[rng.random((B, C)) < 0.5] = 0
    kind[0::31] = 1                                   # full: overflow
    kind[1::31] = 2
    kind[1::31, :max(E // 2, 1)] = 0                  # too few free rows
    tables = dict(
        t_deadline=ints(0, 2 ** 31 - 1, (B, C)), t_kind=kind,
        t_node=ints(-1, N + 1, (B, C)), t_src=ints(0, N, (B, C)),
        t_tag=ints(-2 ** 31, 2 ** 31 - 1, (B, C)),
        t_payload=ints(-2 ** 31, 2 ** 31 - 1, (B, C, P)),
        ev_prov=ints(-1, 10 ** 6, (B, C if prov else 0, 2)))
    m = rng.random((B, E)) < 0.7
    m[2::31] = False                                  # nothing staged
    a = np.concatenate([ints(-2, N + 2, (B, n_sends)),       # dst
                        ints(0, 2 ** 24, (B, E - n_sends))], 1)  # delay
    em = dict(m=m, a=a, tag=ints(-2 ** 31, 2 ** 31 - 1, (B, E)),
              payload=ints(-2 ** 31, 2 ** 31 - 1, (B, E, P)))
    loss = rng.random(B).astype(np.float32)
    loss[3::31], loss[4::31] = 0.0, 1.0
    lat_lo = ints(0, 5000, B)
    lane = dict(
        now=ints(0, 2 ** 30, B), h_node=ints(0, N, B),
        sk_h=np.where(rng.random(B) < 0.5, ints(-512, 513, B), 0).astype(i32),
        dlat_h=np.where(rng.random(B) < 0.5, ints(0, 10 ** 7, B),
                        0).astype(i32),
        loss=loss, lat_lo=lat_lo, lat_hi=lat_lo + ints(0, 5000, B),
        jitter=ints(0, 300, B), k_net=ints(-2 ** 31, 2 ** 31 - 1, (B, 2)),
        clog_node=rng.random((B, N)) < 0.1,
        clog_link=rng.random((B, N, N)) < 0.2,
        disp_idx=ints(0, 10 ** 6, B), ev_lamport=ints(1, 10 ** 6, B))
    rg = None
    if ring:
        TC = 64
        cap = ints(1, TC + 1, B)
        cap[5::31] = TC
        rg = dict(fired=rng.random(B) < 0.8, trace_on=rng.random(B) < 0.8,
                  trace_pos=ints(0, 10 ** 5, B), trace_cap=cap,
                  kind=ints(0, 4, B), node=ints(0, N, B), src=ints(0, N, B),
                  tag=ints(-2 ** 31, 2 ** 31 - 1, B),
                  parent=ints(-1, 10 ** 6, B),
                  cols={k: ints(-2 ** 31, 2 ** 31 - 1, (B, TC)) for k in (
                      "tr_now", "tr_step", "tr_kind", "tr_node", "tr_src",
                      "tr_tag", "tr_parent", "tr_lamport")})

    def dev_tree(x):
        if isinstance(x, dict):
            return {k: dev_tree(v) for k, v in x.items()}
        return torch.as_tensor(x, device=dev)

    return (dev_tree(tables), dev_tree(em), dev_tree(lane),
            None if rg is None else dev_tree(rg), n_sends, jitter)


def emit_bound(tables, em, lane, ring, n_sends, use_jitter):
    """(bytes, operations) of the emission write for these operands.
    bytes: what the write needs, each input byte read once and each byte
    it changes written once, counted for this data:
    - with emissions: every lane's t_kind row (the free-row ranking and
      high_water), its mask vector, its lane scalars (now, h_node, sk_h,
      dlat_h, loss, lat_lo, lat_hi, jitter, k_net; disp_idx and
      ev_lamport with the lineage plane) and its four statistics; each
      masked emission's operand and tag, each masked send's three clog
      flags; each written emission's payload read and its whole table
      row written (five columns, P payload words, the provenance pair);
    - with the ring: every lane's fired, trace_on, trace_pos, trace_cap
      and new trace_pos; for each recording lane its record operands
      (and now, disp_idx, ev_lamport where not counted above) and its
      eight-word ring row.
    Operations: 80 integer operations per threefry block (20 rounds of
    add, rotate, xor plus the key schedule) for the draws masked
    emissions need: a send's loss (3 blocks) and latency (6), and each
    emission's jitter (6) with jitter on."""
    from madsim_tpu_torch.ops.emit_write import emit_write_plain
    t_kind = tables["t_kind"]
    B, C = t_kind.shape
    P = tables["t_payload"].shape[2]
    E = em["m"].shape[1]
    prov = tables["ev_prov"].shape[1] > 0
    row_bytes = 4 * 5 + 4 * P + (8 if prov else 0)
    nbytes = ops = 0
    if E > 0:
        _, stats, _ = emit_write_plain(clone_tree(tables), em, lane, None,
                                       n_sends, use_jitter)
        written = int(stats["high_water"].sum()
                      - (t_kind != 0).sum())          # rows emissions took
        masked = int(em["m"].sum())
        masked_sends = int(em["m"][:, :n_sends].sum())
        lane_words = 10 + (2 if prov else 0)
        nbytes += B * C * 4                           # t_kind
        nbytes += B * (E + 4 * lane_words + 13)       # masks, scalars, stats
        nbytes += masked * 8 + masked_sends * 3
        nbytes += written * (4 * P + row_bytes)       # payload in, row out
        blocks = masked_sends * 9 + (masked * 6 if use_jitter else 0)
        ops = 80 * blocks
    if ring is not None:
        rec = int((ring["fired"] & ring["trace_on"]).sum())
        extra = 0 if (E > 0 and prov) else 8 if E > 0 else 12
        nbytes += B * (2 + 4 * 3) + rec * (4 * 5 + extra + 8 * 4)
    return nbytes, ops


def check_rows_written(name, before, after):
    """The emission write changed no table row but those emissions took
    (free before, occupied after), and no more than one row of each
    lane's ring: `before` and `after` are its operands before and after
    an in-place write."""
    from madsim_tpu_torch.ops.emit_write import RING_COLS, TABLE_COLS
    kind0 = before[0]["t_kind"]
    taken = (kind0 == 0) & (after[0]["t_kind"] != 0)
    for k in TABLE_COLS:
        old, new = before[0][k], after[0][k]
        if old.numel():
            rows = (old != new).reshape(*kind0.shape, -1).any(-1)
            check(not bool((rows & ~taken).any()),
                  f"{name}: {k} changed in a row no emission took")
    if before[3] is not None:
        for k in RING_COLS:
            moved = (before[3]["cols"][k] != after[3]["cols"][k]).sum(1)
            check(bool((moved <= 1).all()),
                  f"{name}: {k} changed in more than one row of a lane")


def check_equal(name, a, b):
    """Exact equality of two result trees; returns the max |difference|."""
    import torch
    fa, fb = flat_tree(a), flat_tree(b)
    check(sorted(fa) == sorted(fb), f"{name}: outputs differ in structure")
    err = 0
    for k in fa:
        x, y = fa[k], fb[k]
        check(x.shape == y.shape and x.dtype == y.dtype,
              f"{name}: {k} {tuple(x.shape)} {x.dtype} vs "
              f"{tuple(y.shape)} {y.dtype}")
        if x.numel():
            err = max(err, int((x.to(torch.int64) - y.to(torch.int64))
                               .abs().max()))
        check(torch.equal(x, y), f"{name}: {k} differs")
    return err


def slice_lanes(state, n):
    from madsim_tpu_torch.core.state import map_state
    return map_state(lambda t: t[:n], state)


def fused_launches(rt, counts, names):
    """A run_fused call's kernel launches: the wrappers' own counts plus
    the launches captured per block times the replays."""
    st = rt.fused_stats
    return {k: counts[k] + st["captured"][k] * st["replays"] for k in names}


def check_once_per_step(what, launches, steps, names, per_step):
    """Each step kernel of `names` launched once a step, every other step
    kernel (the Raft check, on a workload with no Raft) never; each K1/K4
    kernel `per_step[k]` times a step (`step_launches`): those of
    ON_EVERY_STEP at least once, the rest where the path's step draws
    with them. Returns the K1/K4 kernels the path ran."""
    for k in STEP_KERNELS:
        want = steps if k in names else 0
        check(launches[k] == want,
              f"{what}: {k} launched {launches[k]} times in {steps} steps")
    for k in ("step_keys", "dup_draws"):
        check(per_step[k] == 1, f"{what}: {k} launched {per_step[k]} "
              f"times a step, not 1")
    for k in ON_EVERY_STEP:
        check(per_step[k] >= 1, f"{what}: {k} is not on the step's path")
    for k in K1K4:
        check(launches[k] == steps * per_step[k],
              f"{what}: {k} launched {launches[k]} times in {steps} steps "
              f"({per_step[k]} a step)")
    return {k for k in K1K4 if per_step[k] and steps}


def fingerprints_once(rt, state, what):
    """rt.fingerprints(state), which must launch the fingerprint kernel
    exactly once."""
    from madsim_tpu_torch.utils.hashing import fingerprint
    before = fingerprint.launches
    out = rt.fingerprints(state)
    check(fingerprint.launches == before + 1,
          f"{what}: fingerprints launched the kernel "
          f"{fingerprint.launches - before} times")
    return out


def profile_steps(run, state, batch, expect):
    """Trace PROF_STEPS steps of `run(state, n)` with torch.profiler:
    device kernels per step, their summed device time against the wall
    time (the device's busy share), the top kernels, the device events of
    each kernel of `expect` ({kernel: launches a step};
    `kernel_launches`: what ran on the card, graph replays included) and
    its device ms a step, and for the eager step the device time of each
    of its sections (`section_ms_per_step`) and of the handler ranges
    inside the handlers section (`handler_split`; a graph replay runs no
    host code, so it has neither). Device numbers are null when the
    profiler records no device activity.

    The profiler can lose a batch of device records in a window of some
    55,000 (seen on the card: several kernels of one window one event
    short, in no pattern). A window in which a kernel of `expect` has
    fewer events than it launched is traced again, up to PROF_WINDOWS
    times; `short_windows` keeps the counts of the windows set aside.
    More events than launches is never set aside: it fails the run."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    state = run(state, PROF_STEPS)                # warm
    short = []
    for _ in range(PROF_WINDOWS):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            state = run(state, PROF_STEPS)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        dev_events = [e for e in prof.events()
                      if e.device_type == torch.autograd.DeviceType.CUDA
                      and not is_range(e.name)]
        traced = {k: sum(k in e.name for e in dev_events) for k in expect}
        want = {k: PROF_STEPS * n for k, n in expect.items()}
        check(all(traced[k] <= want[k] for k in expect),
              f"profile: traced launches {traced} in {PROF_STEPS} steps")
        if not dev_events or traced == want:
            break
        short.append(traced)
    launches = [e for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CPU
                and "LaunchKernel" in e.name]
    if not dev_events:
        return dict(steps=PROF_STEPS, batch=batch,
                    wall_ms_per_step=wall_us / PROF_STEPS / 1e3,
                    device_busy_share=None, device_kernels_per_step=None,
                    host_launches_per_step=len(launches) / PROF_STEPS,
                    kernel_launches=None)
    by_name: dict = {}
    for e in dev_events:     # a device event's span is its kernel time
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    busy_us = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]

    def kernel_ms(tag):
        return sum(t for n, t in by_name.items() if tag in n) \
            / PROF_STEPS / 1e3

    # the eager step's ranges (a graph replay has none: the ranges are
    # host-side and a replay runs no host code)
    sections, handler_split, outside = section_split(prof, PROF_STEPS)
    return dict(
        steps=PROF_STEPS, batch=batch, short_windows=short,
        wall_ms_per_step=wall_us / PROF_STEPS / 1e3,
        device_busy_ms_per_step=busy_us / PROF_STEPS / 1e3,
        device_busy_share=busy_us / wall_us,
        device_kernels_per_step=len(dev_events) / PROF_STEPS,
        host_launches_per_step=len(launches) / PROF_STEPS,
        sched_pick_ms_per_step=kernel_ms("sched_pick"),
        emit_write_ms_per_step=kernel_ms("emit_write"),
        raft_invariant_ms_per_step=kernel_ms("raft_invariant"),
        apply_super_ms_per_step=kernel_ms("apply_super"),
        int32_scan_ms_per_step=kernel_ms("tensor_kernel_scan"),
        kernel_ms_per_step={k: kernel_ms(k) for k in expect},
        section_ms_per_step=sections,
        sections_ms_per_step=sum(sections.values()) if sections else None,
        handler_split=handler_split,
        handler_split_ms_per_step=(sum(handler_split.values())
                                   if handler_split else None),
        own_kernels_outside_annotations=outside,
        kernel_launches=traced,
        top_kernels_ms_per_step=[[n[:80], t / PROF_STEPS / 1e3]
                                 for n, t in top])


def same_tree(a, b) -> bool:
    """Exact equality of result trees: dicts, lists, tuples, numpy arrays
    (dtype and shape too) and scalars (type too)."""
    import numpy as np
    if isinstance(a, dict):
        return (isinstance(b, dict) and sorted(a) == sorted(b)
                and all(same_tree(a[k], b[k]) for k in a))
    if isinstance(a, (list, tuple)):
        return (type(a) is type(b) and len(a) == len(b)
                and all(same_tree(x, y) for x, y in zip(a, b)))
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        return a.dtype == b.dtype and a.shape == b.shape and bool(
            (a == b).all())
    return type(a) is type(b) and a == b


class Spy:
    """Wrap `owner.name` (a module function, a class method or an instance
    method) while the `with` block runs: each call's seconds (after a
    device synchronise) go into `seconds`, and the cloned arguments of the
    calls numbered in `keep` into `kept` (the call itself runs on the
    caller's tensors)."""

    def __init__(self, owner, name, keep=(), after=None):
        self.owner, self.name, self.keep, self.after = owner, name, keep, after
        self.seconds, self.kept = [], {}

    def __enter__(self):
        import torch
        real = getattr(self.owner, self.name)
        self.real = real
        spy = self

        def wrapper(*args, **kw):
            i = len(spy.seconds)
            if i in spy.keep:
                spy.kept[i] = clone_tree((args, kw))
            t0 = time.perf_counter()
            out = real(*args, **kw)
            torch.cuda.synchronize()
            spy.seconds.append(time.perf_counter() - t0)
            if spy.after is not None:
                spy.after(out)
            return out

        setattr(self.owner, self.name, wrapper)
        return self

    def __exit__(self, *exc):
        if isinstance(self.owner, type) or not hasattr(
                type(self.owner), self.name):
            setattr(self.owner, self.name, self.real)
        else:
            delattr(self.owner, self.name)     # the instance's own wrapper
        return False


def distinct_nudges(n):
    """n distinct nonzero int32 nudges (odd multiples are a bijection of
    the nonzero words mod 2^32)."""
    import numpy as np
    k = np.arange(1, n + 1, dtype=np.uint64) * np.uint64(2654435761)
    return (k % (1 << 32)).astype(np.uint32).view(np.int32)


def edge_knobs(plan, B, seed, dev):
    """A knob batch of B lanes on `dev` for the search kernels' checks:
    base lanes, lanes through six havoc steps of the plain mutator, and
    foreign lanes at the bounds (row and dup times next to T_INF, targets
    outside [-1, N-1] and outside their pools, out-of-range values and
    flags, latency and jitter at and past their caps, losses outside
    [0, 0.99] on the float32 grid of the loss drift, extreme nudges)."""
    import numpy as np
    import torch
    from madsim_tpu_torch import interop
    from madsim_tpu_torch.ops.mutate import mutate_batch_plain
    rng = np.random.default_rng(seed)
    T_INF = 2 ** 31 - 1
    guards, _ = plan._device_tables(dev)
    kb = plan.base_batch(B)
    mut = interop.knobs_to_numpy(mutate_batch_plain(
        interop.knobs_to_torch(kb, dev),
        torch.tensor([seed, 1], dtype=torch.int32, device=dev), guards,
        6)[0])
    q = B // 4
    for k in kb:
        kb[k][q:2 * q] = mut[k][q:2 * q]
    f = slice(2 * q, B)
    n, R, D = B - 2 * q, plan.R, plan.D
    kb["row_time"][f] = rng.choice([-5, 0, 1, T_INF - 2, T_INF - 1,
                                    T_INF - 100], (n, R))
    kb["row_node"][f] = rng.integers(-5, plan.N + 4, (n, R))
    kb["row_val"][f] = rng.integers(-2 ** 31, 2 ** 31 - 1, (n, R))
    kb["row_flag"][f] = rng.integers(-3, 4, (n, R))
    kb["row_on"][f] = rng.random((n, R)) < 0.7
    kb["dup_src"][f] = rng.integers(-2, R + 2, (n, D))
    kb["dup_time"][f] = rng.choice([-3, 0, T_INF - 1, T_INF - 7], (n, D))
    kb["dup_on"][f] = rng.random((n, D)) < 0.5
    kb["lat_lo"][f] = rng.choice([-9, 0, 4_999, 30_000_000, 40_000_000], n)
    kb["lat_hi"][f] = rng.choice([-9, 0, 19_999, 30_000_000], n)
    kb["jitter"][f] = rng.choice([-1, 0, 1_000_000, 2_000_000, 4_999], n)
    kb["prio_nudge"][f] = rng.choice([0, 2 ** 31 - 1, -(2 ** 31)], n)
    kb["loss"][f] = rng.choice(np.float32([-0.5, 0.0, 0.05, 0.3, 0.9, 0.95,
                                           0.99, 1.5, 2.0 ** -20]), n)
    return interop.knobs_to_torch(kb, dev)


def mutate_bound(knobs, key, guards, havoc, mask=None):
    """(bytes, operations) of the havoc mutation for these operands. bytes:
    every lane's knob vector read and written once, its last_op, and the
    histogram. operations: 80 integer operations per threefry block, for
    the blocks the drawn operators need at least — the lane key (2), each
    step's key, operator subkey and operator draw (8), and per operator
    its cheaper branch: time nudge 21 (6 without a mutable row), target 12
    (6), toggle 6, dup 12 (0 without dup slots), latency 12, loss 3,
    priority 6, fault 6."""
    import torch
    from madsim_tpu_torch.core import prng
    B = knobs["row_time"].shape[0]
    lane_bytes = sum(v[0].numel() * v.element_size()
                     for v in knobs.values())
    nbytes = 2 * B * lane_bytes + B * 4 + 8 * 4
    if havoc == 0:
        return nbytes, 0
    D = knobs["dup_src"].shape[1]
    per_op = torch.tensor([
        21 if bool(guards["time_ok"].any()) else 6,
        12 if bool(guards["node_ok"].any()) else 6, 6,
        12 if D > 0 else 0, 12, 3, 6, 6], device=key.device)
    steps = prng.split(prng.split(key, B), havoc)
    blocks = 2 * B
    for h in range(havoc):
        op = prng.randint(prng.split(steps[:, h], 16)[:, 0], 0, 7)
        live = mask if mask is not None else torch.ones_like(op, dtype=bool)
        blocks += int(((8 + per_op[op.long()]) * live).sum())
    if mask is not None:
        blocks -= 2 * int((~mask).sum())
    return nbytes, 80 * blocks


def apply_bound(cols, tlimit, jitter, knobs, base, guards, n_init,
                jitter_gate):
    """The bytes of the knob write for these operands: every lane's knob
    vector, tlimit and jitter read once, its R + D written rows (five
    int32 columns and P payload words each) and its five scalars written
    once, the plan's base rows and guards once. The write is in place, so
    no other row moves."""
    B = cols["t_kind"].shape[0]
    R, P = base["payload"].shape
    D = knobs["dup_src"].shape[1]
    row = 4 * 5 + 4 * P
    lane_bytes = sum(v[0].numel() * v.element_size()
                     for v in knobs.values())
    plan_bytes = sum(v.numel() * v.element_size()
                     for v in list(base.values()) + list(guards.values()))
    return B * (lane_bytes + 8 + (R + D) * row + 5 * 4) + plan_bytes


def check_knob_rows_written(name, before, after):
    """The knob write changed no table row outside [n_init, n_init + R +
    D): `before` is its operands before an in-place write, `after` the
    columns it wrote."""
    cols0, _, _, knobs, base, _, n_init, _ = before
    lo = n_init + base["op"].shape[0] + knobs["dup_src"].shape[1]
    for k, old in cols0.items():
        rows = (old != after[k]).reshape(*old.shape[:2], -1).any(-1)
        rows[:, n_init:lo] = False
        check(not bool(rows.any()),
              f"{name}: {k} changed outside rows [{n_init}, {lo})")


def coverage_edge_hashes(dev):
    """Hash sets the coverage digest must get right: repeats with the top
    bit of either word set, all equal, all distinct, one lane, a tile and
    one key either side of it, two tiles and one key, random words at
    B=100,000, the extreme words."""
    import numpy as np
    import torch
    from madsim_tpu_torch.ops.coverage import TILE
    rng = np.random.default_rng(17)
    top = np.uint32(1 << 31)
    rep = rng.integers(0, 2 ** 32, (5000, 2), dtype=np.uint32)
    rep = rep[rng.integers(0, 5000, 100_000)]
    rep[::3, 0] |= top
    rep[1::3, 1] |= top
    distinct = np.stack([
        np.arange(100_000, dtype=np.uint64) * 2654435761 % 2 ** 32,
        np.arange(100_000, dtype=np.uint64) % 2 << 31], 1).astype(np.uint32)
    sets = {
        "repeats_top_bits": rep,
        "all_equal": np.full((100_000, 2), [top | 5, top | 9], np.uint32),
        "all_distinct": distinct,
        "one_lane": np.array([[top, 1]], np.uint32),
        "B_1": rng.integers(0, 2 ** 32, (1, 2), dtype=np.uint32),
        f"tile_minus_1_B{TILE - 1}": rep[:TILE - 1],
        f"tile_B{TILE}": rep[:TILE],
        f"tile_plus_1_B{TILE + 1}": rep[:TILE + 1],
        "tile_edge_1025": rep[:1025],
        "random_B100000": rng.integers(0, 2 ** 32, (100_000, 2),
                                       dtype=np.uint32),
        "extremes": np.array([[0, 0], [2 ** 32 - 1, 2 ** 32 - 1], [top, 0],
                              [top - 1, 2 ** 32 - 1], [0, top],
                              [2 ** 32 - 1, 0], [0, 0]], np.uint32)}
    return {k: torch.as_tensor(v.view(np.int32), device=dev)
            for k, v in sets.items()}


SECTIONS = ("select", "dup", "super", "handlers", "scatter", "emit",
            "stats", "invariant", "end")


STEP_RANGE, HANDLER_RANGE = "live_step.", "live_handler."


def is_range(name):
    """A step section's profiler range (core/step.py `_section`), or one
    of the handler ranges inside the handlers section (`_handler_range`).
    The profiler also records each range as an annotation on the device's
    timeline, spanning its kernels and the gaps between them: such an
    event is no kernel."""
    return name.startswith((STEP_RANGE, HANDLER_RANGE))


# the port's hand-written kernels, by a tag of their device names. The
# profiler links a kernel launched through ctypes to no host op (F16), so
# no range's device time holds it: each is counted in the range whose
# device-side annotation spans its start
OWN_KERNELS = ("sched_pick", "apply_super", "emit_write", "raft_invariant",
               "step_keys", "dup_draws", "split_randint", "threefry_keys",
               "threefry_draw", "node_gather", "put_rows")


def section_split(prof, steps):
    """(sections, handler split, outside): device ms a step of each
    section of the step (`live_step.<name>` profiler ranges, core/step.py)
    and of each handler range inside the handlers section
    (`live_handler.<name>`): the summed device time of the kernels the ops
    inside each range launched (the ranges' `device_time_total`), and of
    each hand-written kernel in the range whose device-side annotation,
    the innermost one, spans the kernel's start. A hand-written kernel
    that no annotation spans goes to the last annotation begun before it;
    `outside` counts those. None where the trace holds no range (a graph
    replay)."""
    import torch
    out = {k: 0.0 for k in SECTIONS}
    sub: dict = {}
    notes, own = [], []
    ranges = 0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CPU and is_range(
                e.name):
            dev_us = sum(k.duration for k in e.kernels
                         if not is_range(k.name)) + sum(
                ch.device_time_total for ch in e.cpu_children)
            if e.name.startswith(STEP_RANGE):
                ranges += 1
                out[e.name[len(STEP_RANGE):]] += dev_us
            else:
                name = e.name[len(HANDLER_RANGE):]
                sub[name] = sub.get(name, 0.0) + dev_us
        elif e.device_type == torch.autograd.DeviceType.CUDA:
            if is_range(e.name):
                notes.append((e.time_range.start, e.time_range.end, e.name))
            elif any(t in e.name for t in OWN_KERNELS):
                own.append((e.time_range.start, e.time_range.elapsed_us()))
    if not ranges:
        return None, None, None
    outside = 0
    for start, us in own:
        spans = [n for n in notes if n[0] <= start < n[1]]
        if spans:
            name = min(spans, key=lambda n: n[1] - n[0])[2]
        else:
            begun = [n for n in notes if n[0] <= start]
            check(begun, "section_split: a kernel before every annotation")
            name = max(begun)[2]
            outside += 1
        if name.startswith(HANDLER_RANGE):
            name = name[len(HANDLER_RANGE):]
            sub[name] = sub.get(name, 0.0) + us
            out["handlers"] += us
        else:
            out[name[len(STEP_RANGE):]] += us
    return ({k: v / steps / 1e3 for k, v in out.items()},
            {k: v / steps / 1e3 for k, v in sorted(sub.items())}, outside)


def raft_edge_operands(dev, B, N, L, F, seed, peer=None, snap=False):
    """raft_invariant_check operands (without window_slides) whose lanes
    take eight kinds in turn: random words over the whole int32 range;
    every log, digest and snapshot equal; equal logs with ties in the
    effective commit; equal logs but one entry that differs at the
    common commit point; a commit past the log; two leaders of one term;
    commits and snapshot lengths at the int32 extremes (the window point
    wraps); and equal logs behind a nonzero snapshot (with `snap`, every
    kind may carry one). `peer` is the peer mask (None: every node)."""
    import numpy as np
    import torch
    from madsim_tpu_torch.ops.raft_invariant import DIGEST_P_INV, _pow_table
    rng = np.random.default_rng(seed)

    def full(*shape):
        return rng.integers(-2 ** 31, 2 ** 31, shape).astype(np.int32)

    role = rng.integers(0, 3, (B, N)).astype(np.int32)
    term = rng.integers(0, 3, (B, N)).astype(np.int32)
    sl = np.where(snap & (rng.random((B, N)) < 0.5),
                  rng.integers(0, 6, (B, N)), 0).astype(np.int32)
    log_len = (sl + rng.integers(0, L + 1, (B, N))).astype(np.int32)
    commit = rng.integers(0, L + 6, (B, N)).astype(np.int32)
    dig = full(B, N)
    cols = [full(B, N, L) for _ in range(1 + F)]
    kind = np.arange(B) % 8
    same = np.isin(kind, (1, 2, 3, 7))
    for c in cols:
        c[same] = c[same][:, :1]
    dig[same] = dig[same][:, :1]
    sl[np.isin(kind, (1, 2, 3))] = 0
    sl[kind == 7] = rng.integers(1, 4, ((kind == 7).sum(), 1))
    dig[kind == 7] = dig[kind == 7][:, :1]
    log_len[same] = (sl[same] + rng.integers(L // 2, L + 1,
                                             (same.sum(), N))).astype(
                                                 np.int32)
    commit[same] = np.minimum(log_len[same],
                              rng.integers(0, L + 1, (same.sum(), N)))
    commit[kind == 2] = commit[kind == 2][:, :1]          # ties in ec
    commit[kind == 2] = np.minimum(commit[kind == 2], log_len[kind == 2])
    for b in np.nonzero(kind == 3)[0]:     # differ at the common point
        a = int(max(commit[b].min(), 1))
        n = rng.integers(0, N)
        cols[0][b, n, a - 1] ^= 1 << int(rng.integers(0, 31))
    over = kind == 4
    commit[over, 0] = log_len[over, 0] + rng.integers(1, 4, over.sum())
    two = np.nonzero(kind == 5)[0]
    role[two, 0], role[two, N - 1] = 2, 2
    term[two, N - 1] = term[two, 0]
    ext = kind == 6
    commit[ext] = rng.choice([2 ** 31 - 1, -2 ** 31, 0, L],
                             (ext.sum(), N))
    sl[ext] = rng.choice([-2 ** 31, 2 ** 31 - 1, 0, 1], (ext.sum(), N))
    peer = np.ones(N, bool) if peer is None else np.asarray(peer, bool)

    def t(a):
        return torch.as_tensor(a, device=dev)

    return (t(role), t(term), t(sl), t(log_len), t(commit), t(dig),
            t(cols[0]), tuple(t(c) for c in cols[1:]), t(peer),
            _pow_table(L).to(dev), _pow_table(L, DIGEST_P_INV).to(dev))


def raft_bound(role, term, snap_len, log_len, commit, snap_digest, log_term,
               log_fields, peer, powP, ipowP, window_slides):
    """(bytes, operations) of the safety check for these operands: every
    lane's six [N] vectors and (1 + F) [N, L] log columns read once, its
    verdict (a bool and a code) written once, the tables once. Operations:
    each log entry's hash (2 per field column), weight (1) and prefix sum
    (1), and the chain evaluations (3 each): N*N with window_slides, 2N
    without."""
    B, N = role.shape
    L = log_term.shape[-1]
    F = len(log_fields)
    nbytes = (B * (6 * N * 4 + (1 + F) * N * L * 4 + 5)
              + N + 2 * (L + 1) * 4)
    evals = N * N if window_slides else 2 * N
    return nbytes, B * (N * L * (2 * F + 2) + 3 * evals)


def fs_conn_runtime(dev):
    """A 5-node runtime (C=16, P=4) whose node state carries the fs and
    conn/stream leaves of tier-1 test_apply_super_matches_reference_on_
    every_opcode, with its SuperPlan: the schema in which the torn-write
    flush and the reset-peer tear run beside the kernel. Its programs
    never run (the state is made, not stepped)."""
    import numpy as np
    import torch
    from madsim_tpu_torch import Runtime, SimConfig
    from madsim_tpu_torch.models.pingpong import PingPong
    from madsim_tpu_torch.ops.apply_super import SuperPlan
    N, F, S, W = 5, 2, 6, 3
    shapes = dict(fs_mem=(F, S), fs_mlen=(F,), fs_disk=(F, S), fs_dlen=(F,),
                  cn_state=(N,), cn_epoch=(N,), sx_seq=(N,), sx_base=(N,),
                  sx_val=(N, W), sr_next=(N,), sr_val=(N, W),
                  sr_have=(N, W), st_epoch=(N,), x=())
    rng = np.random.default_rng(11)
    spec = {k: torch.as_tensor(
        rng.integers(0, 2, v).astype(bool) if k == "sr_have"
        else rng.integers(0, 9, v).astype(np.int32))
        for k, v in shapes.items()}
    persist = {k: k in ("fs_disk", "fs_dlen", "x") for k in shapes}
    cfg = SimConfig(n_nodes=N, event_capacity=16, payload_words=4)
    rt = Runtime(cfg, [PingPong(N)], spec, persist=persist, device=dev)
    plan = SuperPlan(cfg, {k: v.to(dev) for k, v in spec.items()}, persist)
    return rt, plan


def mixed_leaf_runtime(dev, N=7, C=100, P=3):
    """An N-node runtime (C event rows, P payload words) whose node state
    mixes int32 and bool leaves of several row lengths (one of 33
    elements), a zero-size leaf and a persistent one, with its SuperPlan:
    the kernel's boot reset over a flattened (leaf, element) space that no
    warp chunk divides evenly, and a kill's scan of a C that is no
    multiple of 32. Its programs never run (the state is made, not
    stepped)."""
    import numpy as np
    import torch
    from madsim_tpu_torch import Runtime, SimConfig
    from madsim_tpu_torch.models.pingpong import PingPong
    from madsim_tpu_torch.ops.apply_super import SuperPlan
    shapes = dict(a=(), flag=(), bits=(N, 3), vec=(5,), empty=(0,),
                  keep=(4,), mask=(33,), tail=(N,))
    rng = np.random.default_rng(17)
    spec = {k: torch.as_tensor(
        rng.integers(0, 2, v).astype(bool) if k in ("flag", "bits", "mask")
        else rng.integers(-9, 9, v).astype(np.int32))
        for k, v in shapes.items()}
    persist = {k: k == "keep" for k in shapes}
    cfg = SimConfig(n_nodes=N, event_capacity=C, payload_words=P)
    rt = Runtime(cfg, [PingPong(N)], spec, persist=persist, device=dev)
    plan = SuperPlan(cfg, {k: v.to(dev) for k, v in spec.items()}, persist)
    return rt, plan


def super_edge_operands(rt, B, seed, plan=None):
    """apply_super operands on a random state of runtime `rt`'s schema:
    every opcode 0-19 and an unknown one (20); NODE_RANDOM targets with
    and without a payload pool, and with a pool of no node (an empty
    pool); src out of range; random event tables, node vectors, links and
    node-state values; every seventh lane the RESTART of a live node in
    torn mode with an unsynced tail (where the schema has fs leaves);
    payload words over [0, 2^24), so loss values hit the
    quotients a multiply by the reciprocal of 1e6 would round
    differently. Returns (plan, state, op, node, src, payload, key)."""
    import torch
    from madsim_tpu_torch.core import types as T
    dev = rt.device
    s = rt.init_batch(list(range(B)))
    if plan is None:
        plan = super_operands(rt, s)[0]    # the runtime's own plan
    N, P = rt.cfg.n_nodes, rt.cfg.payload_words
    gen = torch.Generator(device=dev).manual_seed(seed)

    def ri(lo, hi, shape, dtype=torch.int32):
        return torch.randint(lo, hi, tuple(shape), generator=gen,
                             device=dev, dtype=dtype)

    def rb(p, shape):
        return torch.rand(tuple(shape), generator=gen, device=dev) < p

    ns = {}
    for k, v in s.node_state.items():
        if v.dtype == torch.bool:
            ns[k] = rb(0.5, v.shape)
        elif "len" in k:
            ns[k] = ri(0, (s.node_state.get("fs_mem", v).shape[-1]) + 1,
                       v.shape)
        else:
            ns[k] = ri(-50, 50, v.shape)
    if "fs_mlen" in ns:
        ns["fs_mlen"] = torch.maximum(ns["fs_mlen"], ns["fs_dlen"])
    lanes = torch.arange(B, device=dev)
    op = ri(0, 21, (B,))
    node = ri(-1, N, (B,))
    src = ri(-1, N + 1, (B,))
    payload = ri(0, 2 ** 24, (B, P))
    payload[0::3, 0] = 0                       # no pool: every node
    payload[1::11, 0] = 1 << 30                # a pool of no node
    key = ri(-2 ** 31, 2 ** 31 - 1, (B, 2))
    alive, torn = rb(0.5, (B, N)), rb(0.5, (B, N))
    r = lanes[0::7]                            # RESTART a torn, live node
    op[r] = T.OP_RESTART
    node[r] = (r % N).to(torch.int32)
    alive[r, r % N] = True
    torn[r, r % N] = True
    if "fs_mlen" in ns:
        ns["fs_dlen"][r, r % N] = 0
        ns["fs_mlen"][r, r % N] = ns["fs_mem"].shape[-1]
    s = s.replace(
        t_kind=ri(0, 4, s.t_kind.shape), t_node=ri(0, N, s.t_node.shape),
        t_deadline=ri(0, 2 ** 31 - 1, s.t_deadline.shape), alive=alive,
        paused=rb(0.5, (B, N)), clog_node=rb(0.5, (B, N)), torn=torn,
        clog_link=rb(0.3, (B, N, N)), skew=ri(-600, 600, (B, N)),
        disk_lat=ri(0, 10 ** 6, (B, N)), dup_rate=ri(0, 10 ** 6, (B, N)),
        node_state=ns)
    return plan, s, op, node, src, payload, key


def check_super_rows(name, before, after, op, target):
    """The supervisor op wrote no node row but its target's (HEAL's
    clog_node and the reset-peer tear's conn/stream leaves aside) and no
    event-table row but the target's: `before` is the state it was handed,
    `after` the state it returned."""
    import torch
    from madsim_tpu_torch.core import types as T
    from madsim_tpu_torch.ops.apply_super import CONN_LEAVES, STREAM_LEAVES
    B, N = before.alive.shape
    other = torch.arange(N, device=op.device) != target[:, None]
    for k in ("alive", "paused", "clog_node", "skew", "disk_lat", "torn",
              "dup_rate"):
        moved = getattr(before, k) != getattr(after, k)
        if k == "clog_node":
            moved &= (op != T.OP_HEAL)[:, None]
        check(not bool((moved & other).any()),
              f"{name}: {k} changed in a node other than the target")
    for k, v in before.node_state.items():
        moved = (v != after.node_state[k]).reshape(B, N, -1).any(-1)
        if k in CONN_LEAVES + STREAM_LEAVES:
            moved &= (op != T.OP_RESET_PEER)[:, None]
        check(not bool((moved & other).any()),
              f"{name}: node_state.{k} changed in a node other than the "
              f"target")
    moved = ((before.t_kind != after.t_kind)
             | (before.t_deadline != after.t_deadline))
    check(not bool((moved & (before.t_node != target[:, None])).any()),
          f"{name}: an event-table row of another node changed")


def super_bound(plan, s, op, node, src, payload, key):
    """(bytes, operations) of the supervisor op for these operands, each
    input byte read once and each changed byte written once, counted for
    this data: every lane's op, node and src and its four outputs; a
    NODE_RANDOM lane's key, pool vector and pool words; an effective op's
    own reads and writes (a kill's t_node and t_kind rows and the rows it
    clears, a boot's reset rows, a link op's matrix, a knob's payload
    word and target entry). Operations: 80 integer operations per
    threefry block, 6 blocks for each NODE_RANDOM lane's draw."""
    import torch
    from madsim_tpu_torch.core import types as T
    from madsim_tpu_torch.ops.apply_super import apply_super_plain
    B, C = s.t_kind.shape
    N = s.alive.shape[1]
    out, _, target, reset = apply_super_plain(
        plan.cfg, plan.spec_default, plan.persist_mask, clone_tree(s), op,
        node, src, payload, key)
    rnd = node == T.NODE_RANDOM
    n_rnd = int(rnd.sum())
    nbytes = B * (12 + 10) + n_rnd * (8 + N + 4)
    kill = reset & (op != T.OP_INIT)
    boot = reset & (op != T.OP_KILL)
    cleared = int(((s.t_kind != out.t_kind) & kill[:, None]).sum())
    nbytes += int(kill.sum()) * 8 * C + cleared * 8 + int(reset.sum()) * 2
    row = sum(d.numel() * d.element_size() for _, d in plan.leaves)
    nbytes += int(boot.sum()) * row
    link = ((op >= T.OP_CLOG_LINK) & (op <= T.OP_UNCLOG_LINK)) | (
        (op >= T.OP_HEAL) & (op <= T.OP_PARTITION_ONEWAY))
    nbytes += int(link.sum()) * N * N
    knob = (op == T.OP_SET_LOSS) | (op == T.OP_SET_LATENCY) | (
        (op >= T.OP_SET_SKEW) & (op <= T.OP_SET_DUP))
    nbytes += int(knob.sum()) * 16
    return nbytes, 80 * 6 * n_rnd


def super_sector_bytes(plan, s, op, node, src, payload, key):
    """The supervisor op's bytes counted in whole 32-byte sectors, the
    memory's unit of transfer, for this data: the lanes' op, node and src
    and the four outputs (coalesced), and the distinct sectors of a kill
    lane's t_node and t_kind rows, of the table cells it clears, of a
    boot's rows of every reset leaf, of the target's alive and paused
    bytes, and of a link op's matrix. A lane's target rows are scattered
    (row b * N + target), so its small writes each fill a sector of
    their own."""
    import torch
    from madsim_tpu_torch.core import types as T
    from madsim_tpu_torch.ops.apply_super import _get, apply_super_plain
    B, C = s.t_kind.shape
    N = s.alive.shape[1]
    out, _, target, reset = apply_super_plain(
        plan.cfg, plan.spec_default, plan.persist_mask, clone_tree(s), op,
        node, src, payload, key)
    lanes = torch.arange(B, device=op.device, dtype=torch.int64)
    t = target.to(torch.int64)

    def sectors(starts, nbytes):
        """Distinct sectors of the byte ranges [starts, starts + nbytes)."""
        if not starts.numel() or not nbytes:
            return 0
        first, last = starts // 32, (starts + nbytes - 1) // 32
        span = int((last - first).max()) + 1
        ids = first[:, None] + torch.arange(span, device=starts.device)
        return 32 * int(torch.unique(ids[ids <= last[:, None]]).numel())

    total = 32 * (-(-B * 12 // 32) + -(-B * 8 // 32) + -(-B * 2 // 32))
    kill = reset & (op != T.OP_INIT)
    boot = reset & (op != T.OP_KILL)
    kb = lanes[kill]
    for tab in (s.t_node, s.t_kind):
        total += sectors(tab.data_ptr() + kb * C * 4, C * 4)
    cleared = torch.nonzero((s.t_kind != out.t_kind).flatten()).flatten()
    for tab in (s.t_kind, s.t_deadline):
        total += sectors(tab.data_ptr() + cleared * 4, 4)
    bb = lanes[boot] * N + t[boot]
    for path, d in plan.leaves:
        leaf = _get(s.node_state, path)
        rb = d.numel() * leaf.element_size()
        total += sectors(leaf.data_ptr() + bb * rb, rb)
    rt_ = lanes[reset] * N + t[reset]
    for vec in (s.alive, s.paused):
        total += sectors(vec.data_ptr() + rt_, 1)
    link = ((op >= T.OP_HEAL) & (op <= T.OP_PARTITION_ONEWAY)) & (
        (out.clog_link != s.clog_link).flatten(1).any(1) | (op == T.OP_HEAL))
    total += sectors(s.clog_link.data_ptr() + lanes[link] * N * N, N * N)
    return total


SUPER_WRITES = ("t_kind", "t_deadline", "alive", "paused", "clog_node",
                "clog_link", "loss", "lat_lo", "lat_hi", "skew", "disk_lat",
                "torn", "dup_rate")


def super_apply_ms(apply, args, n=20, reps=3):
    """Device ms of one `apply(*args)` call (the in-place supervisor op):
    n calls captured as one CUDA graph, each on its own copy of the leaves
    the op writes (the rest shared), the copies restored from `args`
    outside the timed replay; the least of `reps` replays. Returns (ms,
    [each replay's ms])."""
    import torch
    plan, s = args[:2]
    src = [getattr(s, k) for k in SUPER_WRITES] + [
        s.node_state[p[0]] for p, _ in plan.leaves]
    copies = []
    for _ in range(n):
        own = s.replace(**{k: getattr(s, k).clone() for k in SUPER_WRITES})
        ns = dict(own.node_state)
        for p, _ in plan.leaves:
            ns[p[0]] = ns[p[0]].clone()
        own = own.replace(node_state=ns)
        dst = [getattr(own, k) for k in SUPER_WRITES] + [
            own.node_state[p[0]] for p, _ in plan.leaves]
        copies.append(((plan, own) + tuple(args[2:]), dst))

    def restore():
        for _, dst in copies:
            for d, x in zip(dst, src):
                d.copy_(x)
    apply(*copies[0][0])            # warm: build, allocate
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for a, _ in copies:
            apply(*a)
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(reps + 1):         # the first replay warms the graph
        restore()
        torch.cuda.synchronize()
        t0.record()
        graph.replay()
        t1.record()
        torch.cuda.synchronize()
        times.append(t0.elapsed_time(t1) / n)
    return min(times[1:]), times[1:]


def fp_bound(state):
    """The bytes of the fingerprint: every fingerprinted leaf read once,
    one word written a lane."""
    from madsim_tpu_torch.utils.hashing import _leaves
    return (sum(t.numel() * t.element_size() for t in _leaves(state))
            + 8 * state.now.shape[0])


# ---- K1 (threefry draws) and K4 (node rows) ---------------------------------
K1K4 = ("step_keys", "dup_draws", "split_randint", "threefry_keys",
        "threefry_draw", "node_gather", "put_rows_")
# the wrapper methods that launch them (ops/threefry.py, ops/node_rows.py)
K1K4_METHODS = (("step_keys", "run"), ("dup_draws", "run"),
                ("split_randint", "run"), ("threefry_keys", "split"),
                ("threefry_keys", "fold_in"),
                ("threefry_draw", "randint"), ("threefry_draw", "uniform"),
                ("threefry_draw", "bernoulli"), ("node_gather", "run"),
                ("put_rows_", "run"))
K1 = ("step_keys", "dup_draws", "split_randint", "threefry_keys",
      "threefry_draw")
# a flagship step's K1/K4 launches, eager and in the captured graph
FLAGSHIP_K1K4 = dict(step_keys=1, dup_draws=1, split_randint=2,
                     threefry_keys=0, threefry_draw=0, node_gather=1,
                     put_rows_=2)
# launched by every step of every path; the others where a path's step
# draws with them (threefry_keys and threefry_draw: wal_kv's torn-write
# flush; split_randint: a handler's Ctx.randint with int bounds)
ON_EVERY_STEP = ("step_keys", "dup_draws", "node_gather", "put_rows_")
DUP_WORDS = (0x44555031, 0x44555032)
# integer operations of one 20-round threefry2x32 block (mutate_bound's)
THREEFRY_BLOCK_OPS = 80


def step_launches(wrappers, rt, state):
    """Each K1/K4 kernel's launches in one eager step of `state` (on a
    copy). A step runs the same Python path whatever the data, so these
    are the runtime's launches a step."""
    import torch
    from madsim_tpu_torch.core.state import map_state
    before = {k: wrappers[k].launches for k in K1K4}
    rt._step(map_state(torch.clone, state))
    return {k: wrappers[k].launches - before[k] for k in K1K4}


def k1k4_operands(wrappers, rt, state):
    """{kernel: [(method, args, kwargs), ...]}: every K1/K4 launch of the
    next step of `state` (on a copy), its operands cloned before the call;
    the calls run as the step makes them."""
    import torch
    from madsim_tpu_torch.core.state import map_state
    seen = {k: [] for k in K1K4}
    for k, meth in K1K4_METHODS:
        real = getattr(wrappers[k], meth)

        def spy(*args, _real=real, _k=k, _m=meth, **kw):
            seen[_k].append((_m, clone_tree(args), clone_tree(kw)))
            return _real(*args, **kw)
        setattr(wrappers[k], meth, spy)     # shadows the method
    try:
        rt._step(map_state(torch.clone, state))
    finally:
        for k, meth in K1K4_METHODS:
            delattr(wrappers[k], meth)
    return seen


def k1_plain(kernel, method, args, kw):
    """The plain version (core/prng.py, or the composition of it the
    fused kernels replace) of one threefry kernel call."""
    from madsim_tpu_torch.core import prng
    from madsim_tpu_torch.ops.threefry import (dup_draws_plain,
                                               split_randint_plain,
                                               step_keys_plain)
    if kernel == "step_keys":
        return step_keys_plain(*args, **kw)
    if kernel == "dup_draws":
        return dup_draws_plain(*args)
    if kernel == "split_randint":
        return split_randint_plain(*args)
    key = args[0]
    if method == "split":
        return prng.split(key, *args[1:])
    if method == "fold_in":
        data = args[1]
        if hasattr(data, "dtype"):
            data = data.to(key.dtype)
        return prng.fold_in(key, data)
    if method == "randint":
        lo, hi = args[1], args[2]
        shape = args[3] if len(args) > 3 else kw.get("shape", ())
        if kw.get("inclusive", False):
            return prng.randint(key, lo, hi)
        return prng.randint_raw(key, lo, hi, shape)
    if method == "uniform":
        return prng.uniform(key)
    return prng.bernoulli(key, args[1])


DUP_CASES = ("mixed", "rate_zero", "rate_cap", "equal_latency_bounds",
             "inverted_latency_bounds", "invalid_lanes", "non_message_kinds",
             "past_time_limit")


def dup_edge_operands(case, n, seed=None, N=5):
    """The dup section's operands for `case` as numpy arrays over n lanes
    of N nodes: k_sched (uint32 keys, (0, 0) and all ones first), valid,
    ev_kind, ev_node (in range, as the step clamps it), dup_rate [n, N],
    now, dmin, lat_lo, lat_hi, tlimit. Every case mixes its extreme with
    ordinary lanes: rates over [0, 900000] (the OP_SET_DUP cap), mostly
    message kinds, latency bounds with INT32_MAX (hi + 1 wraps); then
    rates all 0 or all at the cap, lat_lo == lat_hi, lat_hi < lat_lo,
    mostly invalid lanes, mostly non-message kinds, or now past tlimit."""
    import numpy as np
    from madsim_tpu_torch.core import types as T
    rng = np.random.default_rng(len(case) if seed is None else seed)
    k_sched = rng.integers(0, 2 ** 32, (n, 2), dtype=np.uint64).astype(
        np.uint32)
    k_sched[:2] = np.array([[0, 0], [2 ** 32 - 1] * 2], np.uint32)[:n]
    valid = rng.random(n) < 0.85
    kind = np.where(rng.random(n) < 0.7, T.EV_MSG,
                    rng.integers(0, 4, n)).astype(np.int32)
    node = rng.integers(0, N, n).astype(np.int32)
    rate = rng.integers(0, 900_001, (n, N)).astype(np.int32)
    rate[::4] = 900_000
    rate[1::5] = 0
    now = rng.integers(0, 10 ** 6, n).astype(np.int32)
    dmin = (now + rng.integers(-5000, 5000, n)).astype(np.int32)
    lo = rng.integers(0, 10 ** 5, n).astype(np.int32)
    hi = (lo + rng.integers(0, 10 ** 5, n)).astype(np.int32)
    hi[0] = 2 ** 31 - 1
    hi[1:2] = lo[1:2]
    tlimit = (now + rng.integers(0, 10 ** 6, n)).astype(np.int32)
    if case == "rate_zero":
        rate[:] = 0
    elif case == "rate_cap":
        rate[:] = 900_000
    elif case == "equal_latency_bounds":
        hi = lo.copy()
    elif case == "inverted_latency_bounds":
        hi = (lo - rng.integers(1, 1000, n)).astype(np.int32)
    elif case == "invalid_lanes":
        valid = rng.random(n) < 0.2
    elif case == "non_message_kinds":
        kind = rng.integers(0, 4, n).astype(np.int32)
        kind[kind == T.EV_MSG] = T.EV_TIMER
        kind[::7] = T.EV_MSG
    elif case == "past_time_limit":
        tlimit = (np.maximum(now, dmin) - rng.integers(0, 3, n)).astype(
            np.int32)
    return k_sched, valid, kind, node, rate, now, dmin, lo, hi, tlimit


def dup_draws_args(ops, dev):
    """dup_draws' operands on `dev` from dup_edge_operands' arrays: the two
    dup keys folded off k_sched (plain), then the lane tensors."""
    import numpy as np
    import torch
    from madsim_tpu_torch.core import prng
    k_sched = torch.as_tensor(ops[0].view(np.int32), device=dev)
    return ([prng.fold_in(k_sched, w) for w in DUP_WORDS]
            + [torch.as_tensor(a, device=dev) for a in ops[1:]])


def k1_edge_cases(dev, B, seed=21):
    """[(case, kernel, method, args, kwargs)] of edge operands: keys (0, 0)
    and all ones among random ones; the step's fused keys (step_keys) at
    the extension width it unrolls and four it does not, with halted
    lanes, keys off an 8-byte boundary or strided, extreme dup words, one
    lane and B=100,003; split into 1, 2, 5, 8, 9 and 16 at B keys,
    one key, B=100,003 keys and a strided key slice; fold_in words 0 and
    2^32-1, the dup section's two words a key, a word a key; randint_raw
    with maxval <= minval, maxval = minval and the whole int32 range, per
    key and broadcast scalar bounds, an inclusive INT32_MAX, a vector
    draw and bounds wider than the keys; uniform; bernoulli with p 0, 1,
    subnormal, per key and a 0-d tensor; the dup section (dup_draws) in
    every case of dup_edge_operands, keys off an 8-byte boundary, lane
    operands strided, one lane and B=100,003; the handlers' split and
    draw (split_randint) with Raft's and pingpong's bounds, equal and
    inverted bounds, an inclusive INT32_MAX and the whole int32 range,
    strided keys, keys off an 8-byte boundary, one key and B=100,003."""
    import numpy as np
    import torch
    from madsim_tpu_torch.core import prng
    rng = np.random.default_rng(seed)
    i32 = torch.int32

    def keys(n):
        k = torch.as_tensor(rng.integers(-2 ** 31, 2 ** 31, (n, 2))
                            .astype(np.int32), device=dev)
        k[0] = 0
        if n > 1:
            k[1] = -1
        return k

    def words(n):       # int32 words, the extremes first
        w = rng.integers(-2 ** 31, 2 ** 31, n).astype(np.int32)
        w[:4] = [-2 ** 31, 2 ** 31 - 1, 0, -1]
        return torch.as_tensor(w, device=dev)

    K = keys(B)
    lo, hi = words(B), words(B)
    hi[4:8] = lo[4:8]                    # maxval == minval
    p = torch.as_tensor(rng.random(B).astype(np.float32), device=dev)
    p[:3] = torch.tensor([0.0, 1.0, float(np.float32(1e-40))])
    cases = [(f"split_n{n}", "threefry_keys", "split", (K, n), {})
             for n in (1, 2, 5, 8, 9, 16)]
    # the step's fused keys: the extension width it unrolls (2) and ones
    # it takes key by key (3, 4, 5, 9), halted lanes, all and none,
    # keys one word off an 8-byte boundary and strided (both copied by
    # the wrapper), extreme dup words, one lane and B=100,003
    dup = DUP_WORDS
    mixed = torch.as_tensor(rng.random(B) < 0.3, device=dev)
    mixed[:2] = torch.tensor([True, False])
    cases += [
        (f"step_keys_{name}", "step_keys", "run", args, {})
        for name, args in (
            ("flagship_shape", (K, mixed, dup, 2, 1)),
            ("both_ext_keys", (K, mixed, dup, 2, 2)),
            ("ext_3", (K, mixed, dup, 3, 3)),
            ("ext_4_one_read", (K, mixed, dup, 4, 1)),
            ("ext_5", (K, mixed, dup, 5, 5)),
            ("ext_9_by_key", (K, mixed, dup, 9, 9)),
            ("all_halted", (K, torch.ones_like(mixed), dup, 2, 1)),
            ("none_halted", (K, torch.zeros_like(mixed), dup, 2, 1)),
            ("keys_one_word_in", (unaligned(K), mixed, dup, 2, 1)),
            ("keys_strided", (prng.split(K, 5)[:, 3], mixed, dup, 2, 1)),
            ("extreme_words", (K, mixed, (0, 2 ** 32 - 1), 2, 1)),
            ("B1", (keys(1), mixed[:1], dup, 2, 1)),
            ("B100003", (keys(100_003), torch.as_tensor(
                rng.random(100_003) < 0.3, device=dev), dup, 2, 1)))]
    cases += [
        ("split_B1", "threefry_keys", "split", (keys(1), 5), {}),
        ("split_B100003", "threefry_keys", "split", (keys(100_003), 5), {}),
        ("split_strided", "threefry_keys", "split",
         (prng.split(K, 5)[:, 3], 2), {}),
        ("fold_word_0", "threefry_keys", "fold_in", (K, 0), {}),
        ("fold_word_max", "threefry_keys", "fold_in", (K, 2 ** 32 - 1), {}),
        ("fold_dup_words", "threefry_keys", "fold_in",
         (K[:, None, :], torch.tensor([0x44555031, 0x44555032], dtype=i32,
                                      device=dev)), {}),
        ("fold_word_per_key", "threefry_keys", "fold_in", (K, words(B)),
         {}),
        ("randint_empty_span", "threefry_draw", "randint", (K, 9, -4), {}),
        ("randint_equal_bounds", "threefry_draw", "randint", (K, 7, 7), {}),
        ("randint_whole_range", "threefry_draw", "randint",
         (K, -2 ** 31, 2 ** 31 - 1), {}),
        ("randint_inclusive_int32_max", "threefry_draw", "randint",
         (K, 0, 2 ** 31 - 1), dict(inclusive=True)),
        ("randint_per_key", "threefry_draw", "randint", (K, lo, hi), {}),
        ("randint_per_key_inclusive", "threefry_draw", "randint",
         (K, lo, hi), dict(inclusive=True)),
        ("randint_scalar_lo_per_key_hi", "threefry_draw", "randint",
         (K, 0, hi), {}),
        ("randint_vector_5", "threefry_draw", "randint",
         (K, 0, 2 ** 30, (5,)), {}),
        ("randint_wider_than_keys", "threefry_draw", "randint",
         (K[:, None, :], 0, torch.tensor([1, 50, 2 ** 20], dtype=i32,
                                         device=dev)), {}),
        ("uniform", "threefry_draw", "uniform", (K,), {}),
        ("bernoulli_p0", "threefry_draw", "bernoulli", (K, 0.0), {}),
        ("bernoulli_p1", "threefry_draw", "bernoulli", (K, 1.0), {}),
        ("bernoulli_subnormal", "threefry_draw", "bernoulli",
         (K, float(np.float32(1e-40))), {}),
        ("bernoulli_per_key", "threefry_draw", "bernoulli", (K, p), {}),
        ("bernoulli_0d", "threefry_draw", "bernoulli",
         (K, torch.tensor(0.3, device=dev)), {})]
    for case in DUP_CASES:
        cases.append((f"dup_{case}", "dup_draws", "run", tuple(
            dup_draws_args(dup_edge_operands(case, B), dev)), {}))
    mixed_dup = dup_draws_args(dup_edge_operands("mixed", B, seed=5), dev)
    cases += [
        ("dup_keys_one_word_in", "dup_draws", "run",
         tuple(unaligned(a) if i < 2 else a
               for i, a in enumerate(mixed_dup)), {}),
        ("dup_strided_lanes", "dup_draws", "run",
         tuple(torch.stack([a, a], -1)[..., 0] if a.ndim == 1 else a
               for a in mixed_dup), {}),
        ("dup_B1", "dup_draws", "run", tuple(
            dup_draws_args(dup_edge_operands("mixed", 1), dev)), {}),
        ("dup_B100003", "dup_draws", "run", tuple(
            dup_draws_args(dup_edge_operands("rate_cap", 100_003), dev)),
         {})]
    cases += [(f"split_randint_{name}", "split_randint", "run", args, {})
              for name, args in (
                  ("raft_election", (K, 150_000, 300_000)),
                  ("pingpong_retry", (K, 0, 1000)),
                  ("equal_bounds", (K, 7, 7)),
                  ("hi_below_lo", (K, 9, -4)),
                  ("inclusive_int32_max", (K, 0, 2 ** 31 - 1)),
                  ("whole_range", (K, -2 ** 31, 2 ** 31 - 1)),
                  ("strided_keys", (prng.split(K, 2)[:, 0], 0, 20_000)),
                  ("keys_one_word_in", (unaligned(K), 3, 40)),
                  ("one_key", (keys(1)[0], 3, 40)),
                  ("B100003", (keys(100_003), 0, 999)))]
    return cases


def k4_edge_cases(dev, node_state, seed=31):
    """[(case, kernel, args)] of edge operands: the node state at every
    row index and out of range (clamped by the gather, written nowhere by
    put_rows_); fifty leaves of five element types and a zero-size one
    (two gather launches); the gather with every leaf one element or one
    lane off a 16-byte boundary, at B=1 and B=4099, at the int32
    extremes, and longer rows of every element size; row, broadcast-row
    and scalar writes of every element size, under masks with masked-off
    lanes and without, twenty
    tensors (two put_rows launches); the dup pop's table columns; the
    node scatter with its bases or sources off a 16-byte boundary, with
    broadcast sources, at B=1 and B=4099, under three (idx, mask) pairs,
    under an all-false mask and every index out of range."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    B, N = next(iter(node_state.values())).shape[:2]
    every = torch.as_tensor(np.arange(B) % (N + 2) - 1, dtype=torch.int32,
                            device=dev)          # -1 .. N: out of range too
    types = (torch.int32, torch.bool, torch.int16, torch.int64,
             torch.float32)

    def leaf(i, R):
        shape = (B, R) + ((i % 3 + 1,) if i % 4 else ())
        if i == 3:
            shape = (B, R, 0)
        x = torch.as_tensor(rng.integers(-99, 99, shape), device=dev)
        return (x > 0) if types[i % 5] == torch.bool else x.to(types[i % 5])

    mixed = {f"l{i}": leaf(i, N) for i in range(50)}
    mask = torch.as_tensor(rng.random(B) < 0.6, device=dev)
    cases = [("gather_node_state_every_row", "node_gather",
              (node_state, every)),
             ("gather_50_mixed_leaves", "node_gather", (mixed, every))]
    # the gather's launch shapes: every leaf one element (4 bytes) or one
    # lane off a 16-byte boundary (the long rows then go 4 bytes an
    # access), B=1 and lane counts no multiple of a warp or a block,
    # indices at the int32 extremes, and longer rows of every element size
    # at every access width
    extreme = every.clone()
    extreme[::3] = -2 ** 31
    extreme[1::3] = 2 ** 31 - 1

    def rows(shape, dtype, off=0):
        x = torch.as_tensor(rng.integers(-99, 99, (B, N) + shape),
                            device=dev)
        x = (x > 0) if dtype == torch.bool else x.to(dtype)
        return unaligned(x) if off else x

    long_rows = {
        "bool_24": rows((24,), torch.bool), "bool_3": rows((3,), torch.bool),
        "int8_5": rows((5,), torch.int8), "int16_96": rows((96,), torch.int16),
        "int16_8_one_in": rows((8,), torch.int16, 1),
        "int32_32_one_in": rows((32,), torch.int32, 1),
        "int64_3x5": rows((3, 5), torch.int64),
        "float64_one_in": rows((), torch.float64, 1),
        "float32_4x4": rows((4, 4), torch.float32)}
    cases += [
        ("gather_node_state_one_element_in", "node_gather",
         ({k: unaligned(t) for k, t in node_state.items()}, every)),
        ("gather_node_state_one_lane_in", "node_gather",
         ({k: lane_in(t) for k, t in node_state.items()}, every)),
        ("gather_node_state_B1", "node_gather",
         ({k: t[:1] for k, t in node_state.items()}, every[:1])),
        ("gather_node_state_B4099", "node_gather",
         ({k: t[:4099] for k, t in node_state.items()}, every[:4099])),
        ("gather_node_state_extreme_indices", "node_gather",
         (node_state, extreme)),
        ("gather_long_rows_every_width", "node_gather", (long_rows, every))]
    rows = [(t, every, t[:, 0].clone() if t.dtype == torch.bool
             else (t[:, 0] + 1).to(t.dtype), mask)
            for t in node_state.values()]
    cases.append(("put_node_state_every_row_masked", "put_rows_", (rows,)))
    writes = []
    for i in range(20):
        R = N + i % 4
        t = leaf(i if i % 5 != 3 else 2, R)
        idx = torch.as_tensor(rng.integers(-2, R + 2, B), device=dev)
        if i % 3 == 0:
            val = ~t[:, 0] if t.dtype == torch.bool else t[:, 0] + 1
        elif i % 3 == 1:
            val = t[:1, 1].clone()
        else:
            val = True if t.dtype == torch.bool else -3
        writes.append((t, idx, val, mask if i % 2 else True))
    cases.append(("put_20_mixed_writes", "put_rows_", (writes,)))
    C = 96
    t_kind = torch.as_tensor(rng.integers(0, 4, (B, C)), dtype=torch.int32,
                             device=dev)
    t_dead = torch.as_tensor(rng.integers(0, 2 ** 31 - 1, (B, C)),
                             dtype=torch.int32, device=dev)
    pop = torch.as_tensor(rng.integers(-1, C + 1, B), dtype=torch.int32,
                          device=dev)
    cases.append(("put_dup_pop_columns", "put_rows_", ([
        (t_kind, pop, 0, mask),
        (t_dead, pop, t_dead[:, 0] + 7, ~mask)],)))
    # the write's launch shapes: destinations and sources one element
    # (4 bytes) and one lane off a 16-byte boundary (the long rows then go
    # 4 bytes an access), broadcast (stride-0) sources, B=1 and lane counts
    # no multiple of a warp or a block, three (idx, mask) pairs in one
    # launch, an all-false mask and every index out of range
    leaves = list(node_state.values())

    def src(t):
        return ~t[:, 0] if t.dtype == torch.bool else (t[:, 0] + 1).to(
            t.dtype)

    def scatter(ts, val=src):
        return [(t, every[:t.shape[0]], val(t), mask[:t.shape[0]])
                for t in ts]

    cases += [
        ("put_node_state_dst_one_element_in", "put_rows_",
         (scatter([unaligned(t) for t in leaves]),)),
        ("put_node_state_dst_one_lane_in", "put_rows_",
         (scatter([lane_in(t) for t in leaves]),)),
        ("put_node_state_src_one_element_in", "put_rows_",
         (scatter(leaves, val=lambda t: unaligned(src(t))),)),
        ("put_node_state_broadcast_rows", "put_rows_",
         (scatter(leaves, val=lambda t: src(t)[:1].clone()),)),
        ("put_node_state_B1", "put_rows_", (scatter([t[:1] for t in
                                                     leaves]),)),
        ("put_node_state_B4099", "put_rows_",
         (scatter([t[:4099] for t in leaves]),))]
    other = torch.roll(every, 1)
    pairs = [(every, mask), (other, mask), (every, ~mask)]
    cases.append(("put_node_state_three_pairs", "put_rows_", ([
        (t, pairs[i % 3][0], src(t), pairs[i % 3][1])
        for i, t in enumerate(leaves)],)))
    none = torch.zeros_like(mask)
    outside = torch.where(every % 2 == 0, -1, N).to(torch.int32)
    cases.append(("put_node_state_false_mask_and_out_of_range", "put_rows_",
                  ([(t, every, src(t), none) if i % 2 else
                    (t, outside, src(t), True)
                    for i, t in enumerate(leaves)],)))
    return cases


def check_put_rows(name, writes, written):
    """put_rows_ changed no row of a tensor but (lane, idx) where the lane
    is written: `writes` are its operands before, `written` the tensors
    after an in-place write."""
    import torch
    for i, ((mat, idx, _, mask), new) in enumerate(zip(writes, written)):
        if not mat.numel():
            continue
        B, R = mat.shape[:2]
        moved = (mat != new).reshape(B, R, -1).any(-1)
        ok = (idx >= 0) & (idx < R)
        if mask is False:
            ok = torch.zeros_like(ok)
        elif mask is not True:
            ok = ok & mask
        rows = torch.arange(R, device=mat.device) == idx[:, None]
        check(not bool((moved & ~(rows & ok[:, None])).any()),
              f"{name}: write {i} changed a row it must not touch")


def k1_bound(kernel, method, args, kw, out):
    """(bytes, operations) of one threefry kernel call: each operand
    tensor read once and the output written once; THREEFRY_BLOCK_OPS a
    block, for the blocks the draws need (step_keys: the 5-way split's
    five, the two dup fold_ins and the extension split's blocks its
    written keys read; split: one a key it makes; fold_in, uniform,
    bernoulli: one a value; randint: the key's split into two, then F
    words from each half, two words a block; split_randint: the split's
    two and the randint's four). dup_draws counts what this data needs,
    as the kernel reads it: valid, now, dmin and tlimit every lane, the
    kind where valid, the node and its rate where a message, the Bernoulli
    key and block where the rate is positive, the latency key, bounds and
    four blocks where the lane fired; its five outputs every lane."""
    import math
    if kernel == "step_keys":   # 5 + 2 blocks, and the extension split's
        # blocks that the keys it writes read (words 0 .. 2n - 1)
        key, halted, _, n_ext, n_write = args
        nbytes = key.numel() * 4 + halted.numel() + sum(
            t.numel() * 4 for t in out)
        blocks = key.shape[0] * (7 + min(n_ext, 2 * n_write))
        return nbytes, blocks * THREEFRY_BLOCK_OPS
    if kernel == "dup_draws":
        _, _, valid, kind, node, rate, now = args[:7]
        fire = out[2]
        N = rate.shape[-1]
        r = rate.gather(1, node.long().clamp(0, N - 1)[:, None])[:, 0]
        msg = valid & (kind == 1)
        may = msg & (r > 0)
        nv, nm, nmay, nf = (int(t.sum()) for t in (valid, msg, may, fire))
        B = now.shape[0]
        nbytes = B * 13 + nv * 4 + nm * 8 + nmay * 8 + nf * 16 + B * 11
        return nbytes, (nmay + 4 * nf) * THREEFRY_BLOCK_OPS
    if kernel == "split_randint":
        n = out[2].numel()
        return n * (8 + 20), n * 6 * THREEFRY_BLOCK_OPS
    nbytes = out.numel() * out.element_size()
    for a in args:
        if hasattr(a, "element_size"):
            nbytes += a.numel() * a.element_size()
    if method in ("split", "fold_in"):
        blocks = out.numel() // 2
    elif method == "randint":
        F = math.prod(args[3] if len(args) > 3 else kw.get("shape", ()))
        blocks = out.numel() // F * (2 + 2 * -(-F // 2))
    else:
        blocks = out.numel()
    return nbytes, blocks * THREEFRY_BLOCK_OPS


def k4_bound(kernel, args):
    """The bytes of one node-row call: node_gather reads each leaf's rows
    it gathers and the index once and writes the rows; put_rows_ reads
    each index and mask once, and for each lane it writes (in range, mask
    set: what this data needs) reads the source row and writes the row."""
    import torch
    if kernel == "node_gather":
        tree, idx = args
        leaves = flat_tree(tree).values()
        B = idx.shape[0]
        return idx.numel() * 4 + 2 * B * sum(
            t[0, 0].numel() * t.element_size() for t in leaves if t.numel())
    nbytes = 0
    for mat, idx, val, mask in args[0]:
        if mask is False or not mat.numel():
            continue
        B, R = mat.shape[:2]
        ok = (idx >= 0) & (idx < R)
        if mask is not True:
            ok = ok & mask
            nbytes += mask.numel()
        row = mat[0, 0].numel() * mat.element_size()
        src = row if isinstance(val, torch.Tensor) and val.shape[:1] == (
            B,) else 0
        nbytes += idx.numel() * idx.element_size() + int(ok.sum()) * (
            row + src)
    return nbytes


def gather_sector_bytes(tree, idx):
    """The bytes node_gather moves counted in whole 32-byte sectors, the
    memory's unit of transfer: the distinct sectors its lanes' source rows
    touch (a one-element row's 4 bytes fetch its sector, a 20-byte row
    one or two) and those of its contiguous outputs."""
    import torch
    R = next(iter(flat_tree(tree).values())).shape[1]
    r = idx.to(torch.int64).clamp(0, R - 1)
    lanes = torch.arange(idx.shape[0], device=idx.device)
    total = 0
    for t in flat_tree(tree).values():
        if not t.numel():
            continue
        rb = t[0, 0].numel() * t.element_size()
        start = t.data_ptr() + (lanes * R + r) * rb
        first, last = start // 32, (start + rb - 1) // 32
        span = int((last - first).max()) + 1
        ids = first[:, None] + torch.arange(span, device=idx.device)
        total += 32 * int(torch.unique(ids[ids <= last[:, None]]).numel())
        total += 32 * -(-idx.shape[0] * rb // 32)
    return total + idx.numel() * 4


def plain_draws_in_step(rt, state):
    """({core/prng.py function: calls}, [shapes of the one-hot put_row
    writes of node_state, t_kind or t_deadline]) in one eager step of
    `state` (on a copy): every function of core/prng.py, wherever the
    port's modules bind it, and select.put_row are wrapped for the step."""
    import inspect
    import torch
    from madsim_tpu_torch.core import prng
    from madsim_tpu_torch.core.state import map_state
    from madsim_tpu_torch.ops import select as sel
    own = map_state(torch.clone, state)
    targets = {t.data_ptr() for t in [own.t_kind, own.t_deadline]
               + list(own.node_state.values()) if t.numel()}
    calls, onehot = {}, []

    def counted(name, fn):
        def wrapper(*a, **kw):
            calls[name] = calls.get(name, 0) + 1
            return fn(*a, **kw)
        return wrapper

    def put_spy(mat, *a, **kw):
        if mat.numel() and mat.data_ptr() in targets:
            onehot.append(list(mat.shape))
        return real_put(*((mat,) + a), **kw)

    real_put = sel.put_row
    spies = {id(f): counted(n, f) for n, f in vars(prng).items()
             if inspect.isfunction(f) and f.__module__ == prng.__name__}
    spies[id(real_put)] = put_spy
    patched = []
    for mod in [m for n, m in sys.modules.items()
                if n.startswith("madsim_tpu_torch") and m is not None]:
        for attr, val in list(vars(mod).items()):
            if inspect.isfunction(val) and id(val) in spies:
                patched.append((mod, attr, val))
                setattr(mod, attr, spies[id(val)])
    try:
        rt._step(own)
    finally:
        for mod, attr, val in patched:
            setattr(mod, attr, val)
    return calls, onehot


def k1k4_kernel_phase(wrappers, cases, main, launches):
    """Each K1/K4 kernel against its plain version on `cases` ([(case,
    kernel, method, args, kwargs)]), exactly; then its time on `main`
    ({kernel: (case, method, args, kwargs)}, a call of a main path's
    step) as a CUDA-graph replay against the plain version's eager calls,
    in turns, beside its bound. Returns {kernel: kernels-line numbers}."""
    import torch
    from madsim_tpu_torch.ops.node_rows import node_gather_plain, \
        put_rows_plain
    err = {k: 0 for k in K1K4}
    names = {k: [] for k in K1K4}
    for case, k, method, args, kw in cases:
        w = wrappers[k]
        if k in K1:
            out_k = getattr(w, method)(*args, **kw)
            out_p = k1_plain(k, method, args, kw)
        elif k == "node_gather":
            out_k = w(*args)
            out_p = node_gather_plain(*args)
        else:     # in place: kernel and plain version each write a copy
            a, b = clone_layout(args[0]), clone_layout(args[0])
            out_k = w(a)
            out_p = put_rows_plain(b)
            check(all(o is x[0] for o, x in zip(out_k, a)),
                  f"put_rows_ on {case}: not written in place")
            check_put_rows(f"put_rows_ on {case}", args[0], out_k)
        torch.cuda.synchronize()
        err[k] = max(err[k], check_equal(f"{k} on {case}", out_k, out_p))
        names[k].append(case)
    out = {}
    for k in K1K4:
        main_case, method, args, kw = main[k]
        w = wrappers[k]
        if k in K1:
            def kern():
                return getattr(w, method)(*args, **kw)

            def plain():
                return k1_plain(k, method, args, kw)
            res = kern()
            nbytes, ops = k1_bound(k, method, args, kw, res)
        elif k == "node_gather":
            def kern():
                return w(*args)

            def plain():
                return node_gather_plain(*args)
            nbytes, ops = k4_bound(k, args), 0
        else:
            # the scatter rewrites the rows it wrote with the same values:
            # replays repeat the same work on the same operands
            live = clone_tree(args[0])
            nbytes, ops = k4_bound(k, (live,)), 0

            def kern():
                return w(live)

            def plain():
                return put_rows_plain(live)
        k_ms = graph_ms(kern, 50)
        p_ms = cuda_ms(plain, 5)
        k_ms2 = graph_ms(kern, 50)
        p_ms2 = cuda_ms(plain, 5)
        b_ms, o_ms = nbytes / HBM_BYTES_PER_S, ops / INT32_OPS_PER_S
        out[k] = dict(ms=min(k_ms, k_ms2), plain_ms=min(p_ms, p_ms2),
                      bound_ms=max(b_ms, o_ms) * 1e3,
                      bound_by="bytes" if b_ms >= o_ms else "operations",
                      max_abs_err=err[k], library_ms=None)
        extra = {}
        if k == "node_gather":     # the floor in whole sectors, beside it
            extra["sector_bytes"] = gather_sector_bytes(*args)
            extra["sector_bound_ms"] = (extra["sector_bytes"]
                                        / HBM_BYTES_PER_S * 1e3)
        emit(phase="kernel", name=k, cases=names[k], **extra,
             main_case=f"{main_case}:{method}", exact=True,
             max_abs_err=err[k], launches_on_main_path=launches[k],
             ms=[k_ms, k_ms2], plain_ms=[p_ms, p_ms2], bound_bytes=nbytes,
             bound_operations=ops, bound_ms=out[k]["bound_ms"],
             bound_by=out[k]["bound_by"], library="none")
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    try:
        from madsim_tpu_torch import interop, workloads
        from madsim_tpu_torch.obs.rings import ring_records
        from madsim_tpu_torch.ops import kernels
        from madsim_tpu_torch.ops.emit_write import (RING_COLS, TABLE_COLS,
                                                     emit_write,
                                                     emit_write_plain)
        from madsim_tpu_torch.ops.sched_pick import (sched_pick,
                                                     sched_pick_plain)
        from madsim_tpu_torch.parallel import stats
        from madsim_tpu_torch.parallel.explore import explore
        from madsim_tpu_torch.search import Corpus, KnobPlan, fuzz, pct_sweep
        from madsim_tpu_torch.search import corpus as corpus_mod
        from madsim_tpu_torch.search import mutate as mutate_mod
        from madsim_tpu_torch.search.pct import with_prio_nudge
    except ImportError as e:
        print(f"chip_smoke: run from a checkout of the repository "
              f"({e})", file=sys.stderr)
        return 2
    import numpy as np

    dev = torch.device("cuda")
    wrappers = kernels.wrappers()
    names = list(STEP_KERNELS)          # launched once per Raft step
    no_raft = [k for k in names if k != "raft_invariant"]
    every = names + list(K1K4)          # every kernel of the step
    on_path = set()                     # the K1/K4 kernels a path ran

    def reset_counts():
        for w in wrappers.values():
            w.launches = 0
            w.captured = 0

    def read_counts():
        return {k: w.launches for k, w in wrappers.items()}

    # ---- device -------------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi.splitlines()[0], flush=True)
    emit(phase="device", torch=torch.__version__, cuda=torch.version.cuda,
         python=sys.version.split()[0], name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), nvidia_smi=smi)

    # ---- build --------------------------------------------------------------
    t0 = time.perf_counter()
    report = kernels.build_all(force=True)
    ptxas = {k: [ln.strip() for ln in r["log"].splitlines()
                 if "entry function" in ln or "registers" in ln
                 or "spill" in ln]
             for k, r in report.items()}
    emit(phase="build", seconds=time.perf_counter() - t0,
         kernels=sorted(report), ptxas=ptxas)
    libs = sorted({kernels.library(k) for k in wrappers})
    check(sorted(report) == libs, f"build: {sorted(report)} != {libs}")

    # ---- golden: the frozen digests through both runners --------------------
    with open(os.path.join(here, "tests", "data",
                           "golden_r22_leaves.json")) as f:
        golden = json.load(f)
    emit_cases = {}
    fp_cases = {}        # fingerprint operands: whole states
    n_leaves = 0
    for wname, build in workloads.GOLDEN_WORKLOADS.items():
        p = workloads.GOLDEN_RUNS[wname]
        rt = build(device=dev)
        seeds = np.arange(p["seeds"], dtype=np.uint32)
        init = rt.init_batch(seeds)           # both runners start from it
        init_digests = interop.leaf_digests(init)
        per = step_launches(wrappers, rt, init)
        for runner in ("run", "run_fused"):
            torch.cuda.synchronize()
            reset_counts()
            t0 = time.perf_counter()
            if runner == "run":
                s, _ = rt.run(init, p["max_steps"], p["chunk"])
            else:
                s = rt.run_fused(init, p["max_steps"], p["chunk"])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = read_counts()
            if runner == "run":
                launches, steps = counts, rt.steps_run
            else:
                launches = fused_launches(rt, counts, every)
                steps = rt.steps_run + rt.fused_stats["warmup_steps"]
            check(steps > 0, f"golden {wname} {runner}: no step ran")
            on_path |= check_once_per_step(
                f"golden {wname} {runner}", launches, steps, no_raft, per)
            want = golden[wname][runner]
            got = interop.leaf_digests(s)
            bad = [k for k in want if got.get(k) != want[k]]
            n_leaves += len(want)
            after = interop.leaf_digests(init)
            input_changed = [k for k in init_digests
                             if after[k] != init_digests[k]]
            emit(phase="golden", workload=wname, runner=runner,
                 seeds=p["seeds"], steps_run=rt.steps_run, wall_s=wall,
                 launches=launches, k1k4_per_step=per,
                 fused=getattr(rt, "fused_stats", None)
                 if runner == "run_fused" else None, leaves=len(want),
                 mismatched=bad, input_leaves_unchanged=not input_changed)
            check(not bad, f"golden {wname} {runner}: digests differ: {bad}")
            check(not input_changed, f"golden {wname} {runner}: the run "
                  f"changed its input state's leaves {input_changed}")
        fp_cases[f"golden_{wname}"] = s       # pingpong: the traced build
        if wname == "wal_kv":          # operands from mid-run
            s, _ = rt.run(init, 40, chunk=40)
            emit_cases["wal_kv_step_40"] = emit_operands(rt, s)
            # zero-size leaves: a node-state leaf and an extension leaf
            z = fp_cases["golden_wal_kv"]
            fp_cases["golden_wal_kv_zero_size_leaves"] = z.replace(
                node_state=dict(z.node_state, zz=torch.zeros(
                    z.alive.shape + (0,), dtype=torch.int32, device=dev)),
                ext={"z": torch.zeros((z.now.shape[0], 0), dtype=torch.bool,
                                      device=dev)})
        del s, init, rt
    check(n_leaves == 342, f"golden: {n_leaves} leaves checked, not 342")

    # ---- flagship: the eager runner at full width ---------------------------
    rt = workloads.flagship_runtime(device=dev)
    s = rt.init_batch(np.arange(FLAG_B, dtype=np.uint32))
    captured = {0: select_inputs(s)}
    raft_cases = {"flagship_step_0": raft_operands(rt, s)}
    super_cases = {"flagship_step_0": super_operands(rt, s)}
    per_flag = step_launches(wrappers, rt, s)
    check(per_flag == FLAGSHIP_K1K4,
          f"flagship: a step launches {per_flag}, not {FLAGSHIP_K1K4}: its "
          f"keys one step_keys, the dup section one dup_draws, Raft's two "
          f"timer draws two split_randint, no threefry_keys or "
          f"threefry_draw")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    s, _ = rt.run(s, FLAG_CHUNK, chunk=FLAG_CHUNK)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    first_steps = rt.steps_run
    first_counts = read_counts()
    # outside the timed steady window and the counted runs (the captures
    # step a copy of the state)
    snap = select_inputs(s)
    raft_cases[f"flagship_step_{FLAG_CHUNK}"] = raft_operands(rt, s)
    super_cases[f"flagship_step_{FLAG_CHUNK}"] = super_operands(rt, s)
    k1k4_cases = k1k4_operands(wrappers, rt, s)
    draws, onehot = plain_draws_in_step(rt, s)
    emit(phase="no_plain_draws", runner="run", batch=FLAG_B,
         at_step=FLAG_CHUNK, prng_calls=draws, onehot_put_rows=onehot,
         k1k4_per_step=per_flag)
    check(not draws, f"no_plain_draws: an eager flagship step on the card "
          f"called core/prng.py: {draws}")
    check(not onehot, f"no_plain_draws: an eager flagship step on the "
          f"card wrote node_state, t_kind or t_deadline with a one-hot "
          f"put_row: {onehot}")
    flag_fp_chunk = fingerprints_once(rt, s, "flagship")
    torch.cuda.synchronize()
    reset_counts()
    t2 = time.perf_counter()
    steps_mid = int(s.steps.sum())
    s, _ = rt.run(s, FLAG_STEPS - FLAG_CHUNK, chunk=FLAG_CHUNK)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    counts = {k: v + first_counts[k] for k, v in read_counts().items()}
    steps_run = first_steps + rt.steps_run
    captured[FLAG_CHUNK] = snap
    captured[FLAG_STEPS] = select_inputs(s)
    raft_cases[f"flagship_step_{FLAG_STEPS}"] = raft_operands(rt, s)
    check(steps_run == FLAG_STEPS, f"flagship: {steps_run} steps")
    on_path |= check_once_per_step("flagship", counts, steps_run, names,
                                   per_flag)
    crashed = int(s.crashed.sum())
    oops = int((s.oops != 0).sum())
    live = float((~s.halted).float().mean())
    steady = t3 - t2
    eager_ms = steady / (FLAG_STEPS - FLAG_CHUNK) * 1e3
    dispatched = int(s.steps.sum()) - steps_mid
    emit(phase="flagship", runner="run", batch=FLAG_B, steps=steps_run,
         chunk=FLAG_CHUNK, launches=counts, k1k4_per_step=per_flag,
         first_chunk_s=t1 - t0,
         steady_s=steady, whole_run_seed_events_per_s=FLAG_B * FLAG_STEPS
         / (t1 - t0 + t3 - t2), ms_per_step=eager_ms,
         seed_events_per_s=FLAG_B * (FLAG_STEPS - FLAG_CHUNK) / steady,
         dispatched_events_per_s=dispatched / steady,
         max_memory_allocated=torch.cuda.max_memory_allocated(),
         crashed=crashed, oops_lanes=oops, live=live,
         sim_seconds_max=float(s.now.max()) / 1e6)
    check(crashed == 0, f"flagship: {crashed} lanes crashed")
    check(oops == 0, f"flagship: {oops} lanes overflowed the event table")
    check(live > 0.9, f"flagship: only {live:.3f} of lanes live")
    flag_fp = fingerprints_once(rt, s, "flagship")
    fp_cases[f"flagship_step_{FLAG_STEPS}"] = s
    del s, rt

    # ---- fused: the traced flagship through the CUDA-graph runner -----------
    rt = workloads.flagship_runtime(device=dev, trace_cap=64)
    s = rt.init_batch(np.arange(FLAG_B, dtype=np.uint32))
    emit_cases["flagship_step_0"] = emit_operands(rt, s)
    per_tr = step_launches(wrappers, rt, s)
    check(per_tr == dict(FLAGSHIP_K1K4, put_rows_=3),
          f"fused: a traced step launches {per_tr} (the Lamport clock a "
          f"third put_rows_)")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    s = rt.run_fused(s, FLAG_CHUNK, chunk=FLAG_CHUNK)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    launches = fused_launches(rt, read_counts(), every)
    steps_run = rt.steps_run
    warm = rt.fused_stats["warmup_steps"]
    emit_cases[f"flagship_step_{FLAG_CHUNK}"] = emit_operands(rt, s)
    draws_tr, onehot_tr = plain_draws_in_step(rt, s)
    step_read, step_written, step_changed = step_bytes(rt, s)
    torch.cuda.synchronize()
    reset_counts()
    t2 = time.perf_counter()
    s = rt.run_fused(s, FLAG_STEPS - FLAG_CHUNK, chunk=FLAG_CHUNK)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    more = fused_launches(rt, read_counts(), every)
    launches = {k: launches[k] + more[k] for k in every}
    steps_run += rt.steps_run
    check(steps_run == FLAG_STEPS, f"fused: {steps_run} steps")
    on_path |= check_once_per_step("fused", launches, steps_run + warm,
                                   names, per_tr)
    fused_launch = {k: launches[k] for k in every}
    block = rt.fused_stats["block"]
    graph_per_step = {k: rt.fused_stats["captured"][k] / block
                      for k in every}
    check(all(graph_per_step[k] == per_tr[k] for k in K1K4),
          f"fused: the graph captured {graph_per_step} a step, the eager "
          f"step launches {per_tr}")
    check(not draws_tr and not onehot_tr,
          f"fused: a traced eager step on the card called core/prng.py "
          f"{draws_tr} or wrote a one-hot put_row {onehot_tr}")
    crashed = int(s.crashed.sum())
    oops = int((s.oops != 0).sum())
    live = float((~s.halted).float().mean())
    steady = t3 - t2
    fused_ms = steady / (FLAG_STEPS - FLAG_CHUNK) * 1e3
    fp_launches = wrappers["fingerprint"].launches
    same_fp = bool((fingerprints_once(rt, s, "fused") == flag_fp).all())
    fp_launches = wrappers["fingerprint"].launches - fp_launches
    ring = ring_records(s, 0)
    steps_up = bool((np.diff(ring["step"]) > 0).all())
    emit(phase="fused", runner="run_fused", batch=FLAG_B, steps=steps_run,
         chunk=FLAG_CHUNK, trace_cap=64, fused=rt.fused_stats,
         launches=fused_launch, warmup_steps=warm,
         launches_per_step_graph=graph_per_step,
         k1k4_per_step_eager=per_tr,
         first_chunk_s=t1 - t0, steady_s=steady, ms_per_step=fused_ms,
         seed_events_per_s=FLAG_B * (FLAG_STEPS - FLAG_CHUNK) / steady,
         eager_ms_per_step=eager_ms,
         eager_seed_events_per_s=FLAG_B / eager_ms * 1e3,
         max_memory_allocated=torch.cuda.max_memory_allocated(),
         crashed=crashed, oops_lanes=oops, live=live,
         fingerprints_equal_eager=same_fp, ring_lane0_records=len(
             ring["step"]), ring_lane0_total=ring["total"],
         ring_lane0_steps_increase=steps_up)
    check(crashed == 0, f"fused: {crashed} lanes crashed")
    check(oops == 0, f"fused: {oops} lanes overflowed the event table")
    check(live > 0.9, f"fused: only {live:.3f} of lanes live")
    check(same_fp, "fused: fingerprints differ from the eager flagship's")
    check(len(ring["step"]) > 0 and steps_up,
          "fused: lane 0's ring is empty or its steps do not increase")
    step_bound_ms = (step_read + step_written) / HBM_BYTES_PER_S * 1e3
    # K4 (the per-lane row gather and scatter, still plain PyTorch): the
    # acting node's row of every node-state leaf read (the slice), the
    # handlers' new row read and written back (the scatter), and the
    # dispatched event's payload row read
    node_row = sum(t[0, 0].numel() * t.element_size()
                   for t in s.node_state.values())
    k4_bytes = FLAG_B * (3 * node_row + s.t_payload[0, 0].numel() * 4)
    emit(phase="step_bound", batch=FLAG_B, trace_cap=64, at_step=FLAG_CHUNK,
         read_bytes=step_read, written_bytes=step_written,
         bytes=step_read + step_written, bound_ms=step_bound_ms,
         bound_by="bytes", changed_leaves=step_changed,
         run_fused_ms_per_step=fused_ms,
         ms_over_bound=fused_ms / step_bound_ms, k4_node_row_bytes=node_row,
         k4_bound_bytes=k4_bytes,
         k4_bound_ms=k4_bytes / HBM_BYTES_PER_S * 1e3)
    expect_tr = dict({k: 1 for k in names}, **per_tr)
    prof_fused = profile_steps(
        lambda st, n: rt.run_fused(st, n, chunk=n), s, FLAG_B, expect_tr)
    check(prof_fused["kernel_launches"]
          == {k: PROF_STEPS * n for k, n in expect_tr.items()},
          f"profile run_fused: traced launches "
          f"{prof_fused['kernel_launches']} in {PROF_STEPS} steps")
    del s, rt

    # ---- fused_wal_kv: batch independence at full width ---------------------
    p = workloads.GOLDEN_RUNS["wal_kv"]
    rt = workloads.build_wal_kv(device=dev)
    s = rt.init_batch(np.arange(FLAG_B, dtype=np.uint32))
    # both kernels' operands at this path's shape (B=100,000, C=256),
    # mid-run; held against the plain versions in the kernel phase
    mid = rt.run_fused(s, 40, chunk=40)
    wal_case = f"wal_kv_B{FLAG_B}_step_{rt.steps_run}"
    emit_cases[wal_case] = emit_operands(rt, mid)
    super_cases[wal_case] = super_operands(rt, mid)
    wal_select = select_inputs(mid)
    per_wal = step_launches(wrappers, rt, mid)
    # the torn-write flush's split and draw: wal_kv's step keeps the
    # threefry_keys and threefry_draw kernels on a main path
    wal_k1 = {k: [(wal_case, *c) for c in calls] for k, calls in
              k1k4_operands(wrappers, rt, mid).items()
              if k in ("threefry_keys", "threefry_draw")}
    del mid
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    s = rt.run_fused(s, p["max_steps"], p["chunk"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = fused_launches(rt, read_counts(), every)
    on_path |= check_once_per_step(
        "fused_wal_kv", launches,
        rt.steps_run + rt.fused_stats["warmup_steps"], no_raft, per_wal)
    check(per_wal["threefry_keys"] >= 1 and per_wal["threefry_draw"] >= 1,
          f"fused_wal_kv: a step launches {per_wal}; the torn-write flush "
          f"draws through threefry_keys and threefry_draw")
    wal_launch = launches
    want = golden["wal_kv"]["run_fused"]
    got = interop.leaf_digests(slice_lanes(s, p["seeds"]))
    bad = [k for k in want if got.get(k) != want[k]]
    halted = float(s.halted.float().mean())
    crashed = int(s.crashed.sum())
    emit(phase="fused_wal_kv", batch=FLAG_B, steps_run=rt.steps_run,
         wall_s=wall, fused=rt.fused_stats, launches=launches,
         halted=halted, crashed=crashed, leaves=len(want), mismatched=bad,
         operands_taken_at=wal_case)
    check(crashed == 0, f"fused_wal_kv: {crashed} lanes crashed")
    check(halted == 1.0, f"fused_wal_kv: only {halted} of lanes halted")
    check(not bad, f"fused_wal_kv: lanes 0..31 differ: {bad}")
    del s, rt

    # ---- fuzz_flagship: the coverage-guided fuzzer at full width ------------
    search = ("mutate", "apply_knobs")
    rt = workloads.flagship_runtime(device=dev)
    per_fz = step_launches(wrappers, rt, rt.init_batch(np.arange(
        64, dtype=np.uint32)))
    runs = []            # per run_fused call: steps and step-kernel launches

    def after_run(_):
        st = rt.fused_stats
        runs.append(dict(steps=st["steps"], warmup=st["warmup_steps"],
                         replayed={k: st["captured"][k] * st["replays"]
                                   for k in every}))

    rounds_seen = []

    class Rounds:
        def on_round(self, rec):
            rounds_seen.append(rec)

        def on_done(self, rec):
            pass

    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    with Spy(rt, "run_fused", after=after_run) as run_spy, \
            Spy(corpus_mod.Corpus, "observe") as obs_spy, \
            Spy(corpus_mod.Corpus, "schedule") as sched_spy, \
            Spy(mutate_mod, "mutate_batch", keep=(0,)) as mut_spy, \
            Spy(mutate_mod, "apply_knobs",
                keep=(FUZZ_ROUNDS - 1,)) as app_spy:
        res = fuzz(rt, max_steps=FUZZ_STEPS, batch=FLAG_B,
                   max_rounds=FUZZ_ROUNDS, havoc=FUZZ_HAVOC, chunk=FLAG_CHUNK,
                   fused=True, observer=Rounds())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    launched = len(run_spy.seconds)
    steps = sum(r["steps"] for r in runs)        # warm-up steps left out
    warm = sum(r["warmup"] for r in runs)
    fuzz_launch = {k: counts[k] + sum(r["replayed"][k] for r in runs)
                   for k in every}
    fuzz_launch.update({k: counts[k] for k in search})
    # the reference launches round r+1 before it reads round r, so round 1
    # is launched on an empty corpus and mutation starts with round 2:
    # one corpus draw (and one mutate) per round launched on a corpus
    mutated = len(sched_spy.seconds)
    first_mut = launched - mutated
    prev = 0.0
    for r, rec in enumerate(rounds_seen):
        sched = sched_spy.seconds[r - first_mut] if r >= first_mut else 0.0
        host = obs_spy.seconds[r] + sched
        emit(phase="fuzz_flagship_round", round=r,
             wall_s=rec["wall_s"] - prev,
             run_fused_wall_s=run_spy.seconds[r],
             host_s=host, corpus_observe_s=obs_spy.seconds[r],
             corpus_schedule_s=sched, mutated=r >= first_mut,
             host_longer_than_run_fused=host > run_spy.seconds[r],
             new_schedules=rec["new_schedules"],
             corpus_size=rec["corpus_size"])
        prev = rec["wall_s"]
    emit(phase="fuzz_flagship", batch=FLAG_B, max_steps=FUZZ_STEPS,
         rounds=res["rounds"], launched_rounds=launched, havoc=FUZZ_HAVOC,
         steps_run=steps, warmup_steps=warm, wall_s=wall,
         seed_events_per_s=FLAG_B * steps / wall,
         run_fused_wall_s=sum(run_spy.seconds),
         host_s=sum(obs_spy.seconds) + sum(sched_spy.seconds),
         launches=fuzz_launch, distinct_schedules=res["distinct_schedules"],
         seeds_run=res["seeds_run"], crashes=res["crashes"],
         crash_codes=sorted(res["crash_repros"]),
         corpus_size=res["corpus_size"], mutation_ops=res["mutation_ops"],
         mutation_yield=res["mutation_yield"])
    check(res["rounds"] == FUZZ_ROUNDS == launched,
          f"fuzz_flagship: {res['rounds']} rounds, {launched} launched")
    check(fuzz_launch["apply_knobs"] == launched,
          f"fuzz_flagship: apply_knobs launched "
          f"{fuzz_launch['apply_knobs']} times in {launched} rounds")
    check(fuzz_launch["mutate"] == mutated >= 1,
          f"fuzz_flagship: mutate launched {fuzz_launch['mutate']} times "
          f"in {mutated} mutated rounds")
    on_path |= check_once_per_step("fuzz_flagship", fuzz_launch,
                                   steps + warm, names, per_fz)
    check(res["distinct_schedules"] >= 0.99 * res["seeds_run"],
          f"fuzz_flagship: {res['distinct_schedules']} distinct schedules "
          f"in {res['seeds_run']} lanes")
    check(sum(res["mutation_ops"].values()) > 0,
          "fuzz_flagship: no operator applied")
    mutate_cases = {f"flagship_round_{first_mut}": mut_spy.kept[0][0]}
    apply_cases = {f"flagship_round_{FUZZ_ROUNDS - 1}":
                   app_spy.kept[FUZZ_ROUNDS - 1][0]}
    del mut_spy, app_spy

    # ---- explore_flagship: blind sweeps with the on-device digest -----------
    digests = []

    def keep_digest(out):
        digests.append(out)

    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    with Spy(stats, "coverage_digest", keep=range(EXPLORE_ROUNDS),
             after=keep_digest) as cov_spy:
        res = explore(rt, max_steps=FUZZ_STEPS, batch=FLAG_B,
                      max_rounds=EXPLORE_ROUNDS, chunk=FLAG_CHUNK)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    check(counts["coverage_digest"] == res["rounds"] == EXPLORE_ROUNDS,
          f"explore_flagship: coverage_digest launched "
          f"{counts['coverage_digest']} times in {res['rounds']} rounds")
    for i, (pairs, n) in enumerate(digests):
        st = cov_spy.kept[i][0][0]
        want = np.unique(stats.sched_hash_u64(st))
        check(int(n) == len(want) and np.array_equal(
            stats.digest_hashes(pairs, n), want),
              f"explore_flagship: round {i} digest differs from np.unique")
    emit(phase="explore_flagship", batch=FLAG_B, max_steps=FUZZ_STEPS,
         rounds=res["rounds"], wall_s=wall,
         seed_events_per_s=FLAG_B * FUZZ_STEPS * res["rounds"] / wall,
         coverage_digest_launches=counts["coverage_digest"],
         distinct_schedules=res["distinct_schedules"],
         new_per_round=res["new_per_round"], crashes=res["crashes"])
    explore_launches = counts["coverage_digest"]
    coverage_cases = {"explore_round_0": (cov_spy.kept[0][0][0]
                                          .sched_hash.clone(),)}
    del cov_spy, digests

    # ---- pct_flagship: one seed under 100,000 tie-break policies ------------
    nudges = distinct_nudges(FLAG_B)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    res = pct_sweep(rt, 0, nudges, PCT_STEPS, chunk=FLAG_CHUNK)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = fused_launches(rt, read_counts(), every)
    on_path |= check_once_per_step(
        "pct_flagship", launches,
        rt.steps_run + rt.fused_stats["warmup_steps"], names, per_fz)
    emit(phase="pct_flagship", batch=FLAG_B, steps=rt.steps_run,
         wall_s=wall, seed_events_per_s=FLAG_B * rt.steps_run / wall,
         launches=launches, distinct_schedules=res["distinct_schedules"],
         crashed=len(res["crashed_by_nudge"]))
    check(res["distinct_schedules"] > 1,
          "pct_flagship: every nudge gave the same schedule")
    s = with_prio_nudge(rt.init_batch(np.zeros(FLAG_B, np.uint32)), nudges)
    s = rt.run_fused(s, PCT_STEPS // 2, chunk=PCT_STEPS // 2)
    pct_select = select_inputs(s)      # nudged operands from mid-run
    del s, rt

    # ---- search_same_on_both: one campaign on the card and on the CPU -------
    camp = {}
    for where in ("cuda", "cpu"):
        rt = workloads.saturating_runtime(device=where)
        corpus = Corpus(KnobPlan.from_runtime(rt),
                        rng=np.random.default_rng(SAT["rng_seed"]))
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        with Spy(corpus_mod.Corpus, "schedule") as sched_spy:
            r = fuzz(rt, corpus=corpus, dry_rounds=SAT["max_rounds"] + 1,
                     **SAT)
        torch.cuda.synchronize()
        camp[where] = dict(result=r, entries=corpus.entries,
                           wall_s=time.perf_counter() - t0,
                           counts=read_counts(),
                           mutated=len(sched_spy.seconds))
    rt = workloads.saturating_runtime(device=dev)
    reset_counts()
    blind = explore(rt, dry_rounds=SAT["max_rounds"] + 1,
                    **{k: SAT[k] for k in ("max_steps", "batch",
                                           "max_rounds", "chunk")})
    blind_counts = read_counts()
    gpu, cpu = camp["cuda"], camp["cpu"]
    same = same_tree(gpu["result"], cpu["result"])
    same_corpus = same_tree(gpu["entries"], cpu["entries"])
    emit(phase="search_same_on_both", **{k: v for k, v in SAT.items()},
         wall_s_cuda=gpu["wall_s"], wall_s_cpu=cpu["wall_s"],
         launches_cuda={k: gpu["counts"][k] for k in search},
         launches_cpu={k: cpu["counts"][k] for k in search},
         results_equal=same, corpora_equal=same_corpus,
         corpus_entries=len(gpu["entries"]),
         fuzz_distinct_schedules=gpu["result"]["distinct_schedules"],
         explore_distinct_schedules=blind["distinct_schedules"],
         fuzz_new_per_round=gpu["result"]["new_per_round"],
         explore_new_per_round=blind["new_per_round"],
         mutation_ops=gpu["result"]["mutation_ops"])
    check(same, "search_same_on_both: fuzz results differ between the "
          "card and the CPU")
    check(same_corpus, "search_same_on_both: the corpora differ")
    check(gpu["result"]["rounds"] == SAT["max_rounds"]
          and gpu["counts"]["apply_knobs"] == SAT["max_rounds"]
          and gpu["counts"]["mutate"] == gpu["mutated"] >= 1,
          f"search_same_on_both: launches {gpu['counts']} in "
          f"{gpu['result']['rounds']} rounds")
    check(all(v == 0 for v in cpu["counts"].values()),
          "search_same_on_both: a kernel launched on the CPU run")
    check(blind_counts["coverage_digest"] == blind["rounds"],
          "search_same_on_both: explore's digest launches")
    check(gpu["result"]["distinct_schedules"]
          > blind["distinct_schedules"],
          "search_same_on_both: the fuzzer found no more schedules than "
          "blind explore")
    del camp, rt

    # ---- flagship_same_on_both: the traced flagship, card against CPU -------
    # one seed batch (a lane count no multiple of any kernel's lane tile)
    # through both runners on the card and the eager runner on the CPU:
    # every leaf equal, the card's eager run through every step kernel
    runs = {}
    for where, runner in (("cuda", "run"), ("cuda", "run_fused"),
                          ("cpu", "run")):
        rt = workloads.flagship_runtime(device=where, trace_cap=64)
        s0 = rt.init_batch(np.arange(SAME_B, dtype=np.uint32))
        reset_counts()
        out = (rt.run_fused(s0, SAME_STEPS, chunk=64) if runner == "run_fused"
               else rt.run(s0, SAME_STEPS, chunk=64)[0])
        runs[where, runner] = (read_counts(), {
            k: v.cpu() for k, v in interop.state_leaves(out).items()})
    ref = runs["cpu", "run"][1]
    for where, runner in (("cuda", "run"), ("cuda", "run_fused")):
        got = runs[where, runner][1]
        diff = [k for k in ref if not torch.equal(ref[k], got[k])]
        check(sorted(got) == sorted(ref) and not diff,
              f"flagship_same_on_both: {runner} on the card differs from "
              f"the CPU in {diff[:4]}")
    eager = runs["cuda", "run"][0]
    emit(phase="flagship_same_on_both", batch=SAME_B, steps=SAME_STEPS,
         trace_cap=64, leaves=len(ref), equal=True, launches_cuda_run=eager)
    check(all(eager[k] == SAME_STEPS * n for k, n in
              dict(per_tr, raft_invariant=1, sched_pick=1, apply_super=1,
                   emit_write=1).items()),
          f"flagship_same_on_both: the card's eager launches {eager}")
    check(all(v == 0 for v in runs["cpu", "run"][0].values()),
          "flagship_same_on_both: a kernel launched on the CPU run")
    del runs, ref, rt, s0, out

    # ---- kernel: sched_pick against its plain version -----------------------
    B, C = captured[0][0].shape
    N = captured[0][5].shape[1]
    edges = edge_inputs(dev, B, C, N)
    every_halted = list(edge_inputs(dev, B, C, N, seed=4))
    every_halted[8] = torch.ones_like(every_halted[8])
    cases = {"edges": edges,
             "B_1_one_candidate": lanes_of(edges, [1]),
             "B_1_all_tied": lanes_of(edges, [2]),
             "B_1_tied_nudged": lanes_of(edges, [3]),
             "B_1_random": lanes_of(edges, [10]),
             "B_100003": edge_inputs(dev, FLAG_B + 3, C, N, seed=1),
             "C_33_N_32": edge_inputs(dev, B, 33, 32, seed=2),
             "C_256_N_32": edge_inputs(dev, B, 256, 32, seed=3),
             "mixed_tiles": mixed_tile_inputs(dev, B, C, N, seed=5),
             "mixed_tiles_C_256_N_32": mixed_tile_inputs(dev, B, 256, 32,
                                                         seed=6),
             "every_lane_halted": tuple(every_halted),
             "unaligned_tables": tuple(unaligned(a) if i < 5 else a
                                       for i, a in enumerate(edges))}
    cases.update({f"flagship_step_{k}": v for k, v in captured.items()})
    cases[wal_case] = wal_select
    cases[f"pct_flagship_step_{PCT_STEPS // 2}"] = pct_select
    max_err = 0
    for name, args in cases.items():
        out_k = sched_pick(*args)
        out_p = sched_pick_plain(*args)
        torch.cuda.synchronize()
        check(len(out_k) == len(out_p) == 9, "sched_pick: output arity")
        for field, a, b in zip(("idx", "dmin", "valid", "any_ev",
                                "sched_hash", "ev_kind", "ev_node", "ev_src",
                                "ev_tag"), out_k, out_p):
            err = int((a.to(torch.int64) - b.to(torch.int64)).abs().max())
            max_err = max(max_err, err)
            check(torch.equal(a, b),
                  f"sched_pick != sched_pick_plain on {name}: {field}")
    main_args = captured[FLAG_CHUNK]
    # timed in turns (kernel, plain, kernel, plain): the kernel as device
    # time (graph_ms), the plain version's many small eager launches
    # between events; the t_kind and t_deadline tables alone (~77 MB at
    # B=100,000) exceed the 50 MB L2, so each launch reads device memory
    k_ms = graph_ms(lambda: sched_pick(*main_args), 50)
    p_ms = cuda_ms(lambda: sched_pick_plain(*main_args), 5)
    k_ms2 = graph_ms(lambda: sched_pick(*main_args), 50)
    p_ms2 = cuda_ms(lambda: sched_pick_plain(*main_args), 5)
    k_eager = cuda_ms(lambda: sched_pick(*main_args), 50)
    nbytes = bound_bytes(*main_args)
    sp_bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    sp = dict(ms=min(k_ms, k_ms2), plain_ms=min(p_ms, p_ms2),
              bound_ms=sp_bound_ms, max_abs_err=max_err)
    # registers a thread and resident blocks an SM, at the flagship's C
    # and at wal_kv's
    occupancy = {f"C_{c}": sched_pick.occupancy(c)
                 for c in sorted({C, wal_select[0].shape[1]})}
    emit(phase="kernel", name="sched_pick", cases={
        k: list(v[0].shape) for k, v in sorted(cases.items())}, batch=B,
         C=C, N=N, exact=True, max_abs_err=max_err,
         launches_on_main_path=fused_launch["sched_pick"],
         launches_per_step=fused_launch["sched_pick"] / (FLAG_STEPS + warm),
         ms=[k_ms, k_ms2], eager_launch_ms=k_eager,
         ms_in_flagship_graph=prof_fused["sched_pick_ms_per_step"],
         occupancy=occupancy, plain_ms=[p_ms, p_ms2], bound_bytes=nbytes,
         bound_ms=sp_bound_ms, library="none")
    del cases, captured, main_args, wal_select, pct_select, edges, \
        every_halted

    # ---- kernel: emit_write against its plain version -----------------------
    for C_e, E_e, ns_e, jit_e, ring_e in ((96, 12, 7, True, True),
                                          (96, 0, 0, False, True),
                                          (256, 3, 1, False, True),
                                          (256, 5, 0, True, False),
                                          (256, 6, 6, False, False)):
        emit_cases[f"edges_C{C_e}_E{E_e}_sends{ns_e}"
                   f"{'_jitter' if jit_e else ''}"
                   f"{'_ring' if ring_e else ''}"] = emit_edge_operands(
            dev, 4096, C_e, 5, 8, E_e, ns_e, jit_e, ring_e, ring_e,
            seed=C_e + E_e)
    max_err_e = 0
    for name, args in emit_cases.items():
        # kernel and plain version each write a copy of the operands
        a, b = clone_tree(args), clone_tree(args)
        out_k = emit_write(*a)
        out_p = emit_write_plain(*b)
        torch.cuda.synchronize()
        check(all(out_k[0][k] is a[0][k] for k in TABLE_COLS)
              and (a[3] is None or all(out_k[2]["cols"][k]
                                       is a[3]["cols"][k]
                                       for k in RING_COLS)),
              f"emit_write on {name}: not written in place")
        # every table and ring leaf, untouched rows included
        max_err_e = max(max_err_e, check_equal(
            f"emit_write on {name}", (a[0], a[3], out_k),
            (b[0], b[3], out_p)))
        check_rows_written(f"emit_write on {name}", args, a)
    main_e = emit_cases[f"flagship_step_{FLAG_CHUNK}"]
    # the write changes its operands, so each timed call restores the
    # touched columns from main_e first; the restore alone is subtracted
    live = clone_tree(main_e)
    restores = [(live[0][k], main_e[0][k]) for k in TABLE_COLS]
    if main_e[3] is not None:
        restores += [(live[3]["cols"][k], main_e[3]["cols"][k])
                     for k in RING_COLS]

    def restore():
        for dst, src in restores:
            dst.copy_(src)

    def kernel_ms():
        return (graph_ms(lambda: (restore(), emit_write(*live)), 20)
                - graph_ms(restore, 20))

    def plain_ms():
        return (cuda_ms(lambda: (restore(), emit_write_plain(*live)), 5)
                - cuda_ms(restore, 5))

    ek, ep, ek2, ep2 = kernel_ms(), plain_ms(), kernel_ms(), plain_ms()
    restore_ms = graph_ms(restore, 20)
    ek_eager = (cuda_ms(lambda: (restore(), emit_write(*live)), 20)
                - cuda_ms(restore, 20))
    ek_graph = prof_fused["emit_write_ms_per_step"]
    e_bytes, e_ops = emit_bound(*main_e)
    e_bound_ms = max(e_bytes / HBM_BYTES_PER_S, e_ops / INT32_OPS_PER_S) \
        * 1e3
    e_bound_by = ("bytes" if e_bytes / HBM_BYTES_PER_S
                  >= e_ops / INT32_OPS_PER_S else "operations")
    ew = dict(ms=min(ek, ek2), plain_ms=min(ep, ep2), bound_ms=e_bound_ms,
              max_abs_err=max_err_e, bound_by=e_bound_by)
    emit(phase="kernel", name="emit_write", cases={
        k: list(v[0]["t_kind"].shape) for k, v in sorted(emit_cases.items())},
         batch=main_e[0]["t_kind"].shape[0],
         C=main_e[0]["t_kind"].shape[1], E=main_e[1]["m"].shape[1],
         n_sends=main_e[4], exact=True, max_abs_err=max_err_e,
         launches_on_main_path=fused_launch["emit_write"],
         launches_per_step=fused_launch["emit_write"] / (FLAG_STEPS + warm),
         ms=[ek, ek2], eager_launch_ms=ek_eager, plain_ms=[ep, ep2],
         restore_ms=restore_ms, ms_in_flagship_graph=ek_graph,
         bound_bytes=e_bytes,
         bound_operations=e_ops, bound_ms=e_bound_ms, bound_by=e_bound_by,
         library="none")
    del emit_cases, main_e, live, restores

    # ---- kernel: the search kernels against their plain versions ----------
    from madsim_tpu_torch.ops.apply_knobs import TABLE_COLS as APPLY_COLS
    from madsim_tpu_torch.ops.apply_knobs import apply_knobs, \
        apply_knobs_plain
    from madsim_tpu_torch.ops.coverage import coverage_digest, \
        coverage_digest_plain, sort_key
    from madsim_tpu_torch.ops.mutate import (mutate_batch, mutate_batch_plain,
                                             mutate_tile)
    search_kernels = {}
    # the first mutated round's own operands: at B not a multiple of the
    # kernel's tile, masked, and with a knob array off a 16-byte boundary
    main_m = f"flagship_round_{first_mut}"
    kb_m, key_m, guards_m, havoc_m, _ = mutate_cases[main_m]
    R_m, D_m = kb_m["row_time"].shape[1], kb_m["dup_src"].shape[1]
    m_tile, m_smem = mutate_tile(R_m, D_m, guards_m["pool_ok"].shape[1] - 1)
    for n in (m_tile + 1, 4099):
        mutate_cases[f"{main_m}_B{n}"] = (
            {k: v[:n] for k, v in kb_m.items()}, key_m, guards_m, havoc_m,
            None)
    mutate_cases[f"{main_m}_masked"] = (
        kb_m, key_m, guards_m, havoc_m, torch.as_tensor(
            np.random.default_rng(7).random(FLAG_B) < 0.6, device=dev))
    mutate_cases[f"{main_m}_row_time_one_element_in"] = (
        dict(kb_m, row_time=unaligned(kb_m["row_time"])), key_m, guards_m,
        havoc_m, None)
    edge_rts = {"all_knobs": workloads.all_knobs_runtime(device=dev),
                "flagship": workloads.flagship_runtime(device=dev)}
    for pname, ert in edge_rts.items():
        plan = KnobPlan.from_runtime(ert)
        guards, base = plan._device_tables(dev)
        kb = edge_knobs(plan, EDGE_B, 3, dev)
        mask = torch.as_tensor(np.random.default_rng(5).random(EDGE_B)
                               < 0.6, device=dev)
        for h, m in ((0, None), (1, None), (6, None), (6, mask)):
            key = torch.tensor([h, 99], dtype=torch.int32, device=dev)
            masked = "_masked" if m is not None else ""
            mutate_cases[f"{pname}_havoc{h}{masked}"] = (kb, key, guards, h,
                                                          m)
        st = ert.init_batch(np.arange(EDGE_B, dtype=np.uint32))
        cols = {n: getattr(st, n) for n in APPLY_COLS}
        apply_cases[f"{pname}_foreign"] = (
            cols, st.tlimit, st.jitter, kb, base, guards, plan.n_init,
            plan.jitter_gate)
        # every row garbage: the write must not read what its rows held,
        # and must leave the other rows as they were
        gen = torch.Generator(device=dev).manual_seed(11)
        junk = {n: torch.randint(-2 ** 31, 2 ** 31 - 1, c.shape,
                                 generator=gen, device=dev,
                                 dtype=torch.int32)
                for n, c in cols.items()}
        apply_cases[f"{pname}_foreign_garbage_rows"] = (
            junk, st.tlimit, st.jitter, kb, base, guards, plan.n_init,
            plan.jitter_gate)
        apply_cases[f"{pname}_foreign_unaligned_payload"] = (
            dict(junk, t_payload=unaligned(junk["t_payload"])), st.tlimit,
            st.jitter, kb, base, guards, plan.n_init, plan.jitter_gate)
    coverage_cases.update({k: (h,) for k, h in
                           coverage_edge_hashes(dev).items()})
    for kname, kern, plain, cases_k, main_case in (
            ("mutate", mutate_batch, mutate_batch_plain, mutate_cases,
             f"flagship_round_{first_mut}"),
            ("apply_knobs", apply_knobs, apply_knobs_plain, apply_cases,
             f"flagship_round_{FUZZ_ROUNDS - 1}"),
            ("coverage_digest", coverage_digest, coverage_digest_plain,
             coverage_cases, "explore_round_0")):
        err = 0
        issued = {}
        for cname, args in cases_k.items():
            if kname == "apply_knobs":
                # in place: kernel and plain version each write a copy
                a, b = clone_tree(args), clone_tree(args)
                out_k = kern(*a)
                out_p = plain(*b)
                torch.cuda.synchronize()
                check(all(out_k[n] is a[0][n] and out_p[n] is b[0][n]
                          for n in APPLY_COLS),
                      f"apply_knobs on {cname}: not written in place")
                err = max(err, check_equal(f"{kname} on {cname}",
                                           (a[0], out_k), (b[0], out_p)))
                check_knob_rows_written(f"{kname} on {cname}", args, a[0])
                continue
            out_k = kern(*args)
            out_p = plain(*args)
            torch.cuda.synchronize()
            err = max(err, check_equal(f"{kname} on {cname}", out_k, out_p))
            if kname == "coverage_digest":
                issued[cname] = dict(kern.issued)
                check(issued[cname] == dict(kernels=10, memsets=1),
                      f"coverage_digest on {cname}: issued "
                      f"{issued[cname]}, not 10 kernels and 1 memset")
        margs = cases_k[main_case]
        # apply_knobs writes margs' columns in place; its rows depend on
        # the knobs alone, so every replay repeats the same work
        k_ms = graph_ms(lambda: kern(*margs), 20)
        p_ms = cuda_ms(lambda: plain(*margs), 3)
        k_ms2 = graph_ms(lambda: kern(*margs), 20)
        p_ms2 = cuda_ms(lambda: plain(*margs), 3)
        extra = {}
        lib_ms = None
        if kname == "mutate":
            nbytes, ops = mutate_bound(*margs)
            extra = dict(tile=m_tile, smem_bytes=m_smem)
        elif kname == "apply_knobs":
            nbytes, ops = apply_bound(*margs), 0
            # the write's own layout, for scale: torch's fill_ of the
            # slices it writes (35 of 96 rows of five int32 columns and of
            # the payload, at the flagship's plan), which also moves only
            # the bytes written
            lo = margs[6]
            hi = lo + margs[4]["op"].shape[0] + margs[3]["dup_src"].shape[1]
            mcols = margs[0]

            def fill():
                for n in APPLY_COLS:
                    mcols[n][:, lo:hi].fill_(7)

            extra = dict(written_slices_fill_ms=min(graph_ms(fill, 20),
                                                    graph_ms(fill, 20)))
        else:
            B_c = margs[0].shape[0]
            nbytes, ops = 16 * B_c + 4, 0
            key64 = sort_key(margs[0])
            lib_ms = min(cuda_ms(lambda: torch.unique(key64), 10),
                         cuda_ms(lambda: torch.unique(key64), 10))
            extra = dict(library="torch.unique over the 64-bit key",
                         launches_per_call=issued[main_case]["kernels"],
                         memsets_per_call=issued[main_case]["memsets"],
                         batch=B_c)
        b_ms, o_ms = nbytes / HBM_BYTES_PER_S, ops / INT32_OPS_PER_S
        bound_ms = max(b_ms, o_ms) * 1e3
        bound_by = "bytes" if b_ms >= o_ms else "operations"
        search_kernels[kname] = dict(
            ms=min(k_ms, k_ms2), plain_ms=min(p_ms, p_ms2),
            bound_ms=bound_ms, bound_by=bound_by, max_abs_err=err,
            library_ms=lib_ms)
        emit(phase="kernel", name=kname, cases=sorted(cases_k),
             main_case=main_case, exact=True, max_abs_err=err,
             ms=[k_ms, k_ms2], plain_ms=[p_ms, p_ms2], bound_bytes=nbytes,
             bound_operations=ops, bound_ms=bound_ms, bound_by=bound_by,
             library_ms=lib_ms, **extra)
    del mutate_cases, apply_cases, coverage_cases, edge_rts

    # ---- kernel: the Raft safety check against its plain version -----------
    from madsim_tpu_torch.ops.raft_invariant import (raft_invariant_check,
                                                     raft_invariant_plain)
    for k in list(raft_cases):     # the captured operands in both forms
        raft_cases[k + "_pairwise"] = raft_cases[k][:-1] + (True,)
    for B_r, N_r, L_r, F_r, snap, peer in (
            (EDGE_B, 5, 32, 1, False, None), (EDGE_B, 5, 32, 1, True, None),
            (EDGE_B, 3, 8, 2, True, (1, 0, 1)),
            (EDGE_B, 5, 8, 1, True, (1, 1, 0, 1, 1)),
            (1, 5, 32, 1, False, None), (1, 3, 8, 1, True, None),
            (FLAG_B + 3, 5, 32, 1, True, None), (EDGE_B, 8, 8, 2, True, None),
            (EDGE_B + 5, 32, 32, 8, True, None), (37, 16, 32, 4, True, None)):
        ops = raft_edge_operands(dev, B_r, N_r, L_r, F_r, B_r + L_r, peer,
                                 snap)
        for ws in (False, True):
            raft_cases[f"edges_B{B_r}_N{N_r}_L{L_r}_F{F_r}"
                       f"{'_snap' if snap else ''}"
                       f"{'_peers' if peer else ''}"
                       f"_{'pairwise' if ws else 'adjacent'}"] = ops + (ws,)
    # operands off a 16-byte boundary: every tensor one element in (the
    # log rows then go 4 bytes an access), and one lane in (the vectors
    # off, the log columns still aligned); B=4101, no multiple of a
    # block's lanes
    ops = raft_edge_operands(dev, EDGE_B + 5, 5, 32, 1, 77, None, True)
    for how, move in (("one_element_in", unaligned), ("one_lane_in", lane_in)):
        moved = tuple(move(t) for t in ops[:7]) + (
            tuple(move(c) for c in ops[7]),) + ops[8:]
        for ws in (False, True):
            raft_cases[f"edges_B{EDGE_B + 5}_{how}_"
                       f"{'pairwise' if ws else 'adjacent'}"] = moved + (ws,)
    err = 0
    for name, args in raft_cases.items():
        out_k = raft_invariant_check(*args)
        out_p = raft_invariant_plain(*args)
        torch.cuda.synchronize()
        err = max(err, check_equal(f"raft_invariant on {name}", out_k, out_p))
    main_r = raft_cases[f"flagship_step_{FLAG_CHUNK}"]
    k_ms = graph_ms(lambda: raft_invariant_check(*main_r), 50)
    p_ms = cuda_ms(lambda: raft_invariant_plain(*main_r), 5)
    k_ms2 = graph_ms(lambda: raft_invariant_check(*main_r), 50)
    p_ms2 = cuda_ms(lambda: raft_invariant_plain(*main_r), 5)
    nbytes, ops_n = raft_bound(*main_r)
    b_ms, o_ms = nbytes / HBM_BYTES_PER_S, ops_n / INT32_OPS_PER_S
    from madsim_tpu_torch.ops.raft_invariant import rows_vec4
    vec4 = rows_vec4((main_r[6],) + main_r[7], main_r[6].shape[-1])
    ri = dict(ms=min(k_ms, k_ms2), plain_ms=min(p_ms, p_ms2),
              bound_ms=max(b_ms, o_ms) * 1e3,
              bound_by="bytes" if b_ms >= o_ms else "operations",
              max_abs_err=err, library_ms=None)
    emit(phase="kernel", name="raft_invariant", cases={
        k: list(v[0].shape) for k, v in sorted(raft_cases.items())},
         main_case=f"flagship_step_{FLAG_CHUNK}", exact=True,
         max_abs_err=err, launches_on_main_path=fused_launch[
             "raft_invariant"], ms=[k_ms, k_ms2], plain_ms=[p_ms, p_ms2],
         ms_in_flagship_graph=prof_fused["raft_invariant_ms_per_step"],
         bound_bytes=nbytes, bound_operations=ops_n, bound_ms=ri["bound_ms"],
         bound_by=ri["bound_by"], library="none", rows_vec4=vec4)
    del raft_cases, main_r

    # ---- kernel: the supervisor op against its plain version ----------------
    from madsim_tpu_torch.ops.apply_super import apply_super, apply_super_plain
    flag_rt = workloads.flagship_runtime(device=dev)
    super_cases["edges_raft"] = super_edge_operands(flag_rt, EDGE_B, 7)
    super_cases["edges_raft_B1"] = super_edge_operands(flag_rt, 1, 9)
    # the warp mapping's edges: a partial last warp, C no multiple of 32,
    # N = 32, bool and zero-size leaves
    super_cases["edges_raft_B1003"] = super_edge_operands(flag_rt, 1003, 10)
    for n_, c_, b_ in ((7, 100, 4099), (32, 100, 4099), (32, 33, 77)):
        m_rt, m_plan = mixed_leaf_runtime(dev, N=n_, C=c_)
        super_cases[f"edges_mixed_leaves_N{n_}_C{c_}_B{b_}"] = \
            super_edge_operands(m_rt, b_, n_ + c_, m_plan)
        del m_rt
    fc_rt, fc_plan = fs_conn_runtime(dev)
    super_cases[f"edges_fs_conn_B{FLAG_B}"] = super_edge_operands(
        fc_rt, FLAG_B, 8, fc_plan)
    # K3's time against its op count: the step-512 operands with no op
    # lane, as they are, and with every lane a RESTART (a kill and a boot)
    flag_main = f"flagship_step_{FLAG_CHUNK}"
    super_timed = (f"{flag_main}_no_op_lanes", flag_main,
                   f"{flag_main}_every_lane_restart")
    plan_m, s_m, op_m, node_m, src_m, pay_m, key_m = super_cases[flag_main]
    n_m = plan_m.cfg.n_nodes
    lanes_m = torch.arange(op_m.shape[0], device=dev, dtype=torch.int32)
    super_cases[super_timed[0]] = (
        plan_m, s_m, torch.zeros_like(op_m), node_m.clamp(0, n_m - 1),
        src_m, pay_m, key_m)
    super_cases[super_timed[2]] = (
        plan_m, s_m, torch.full_like(op_m, 3), lanes_m % n_m, src_m, pay_m,
        key_m)
    err = 0
    for name, args in super_cases.items():
        # in place: kernel and plain version each take a copy
        a, b = clone_tree(args), clone_tree(args)
        out_k = apply_super(*a)
        out_p = apply_super_plain(b[0].cfg, b[0].spec_default,
                                  b[0].persist_mask, *b[1:])
        torch.cuda.synchronize()
        check(out_k[0].alive is a[1].alive and out_k[0].t_kind is a[1].t_kind
              and out_k[0].clog_link is a[1].clog_link,
              f"apply_super on {name}: not written in place")
        err = max(err, check_equal(
            f"apply_super on {name}",
            (interop.state_leaves(out_k[0]), out_k[1:]),
            (interop.state_leaves(out_p[0]), out_p[1:])))
        check_super_rows(f"apply_super on {name}", args[1], out_k[0],
                         args[2], out_k[2])
    # the op writes its operands, so each timed call works on its own copy
    # of the leaves it writes, restored before each timed replay
    timed = {}
    for name in super_timed:
        main_s = super_cases[name]
        k_ms = [super_apply_ms(apply_super, main_s)[0] for _ in range(2)]
        p_ms = [cuda_ms(lambda: apply_super_plain(
            main_s[0].cfg, main_s[0].spec_default, main_s[0].persist_mask,
            *main_s[1:]), 5) for _ in range(2)]
        nbytes, ops_n = super_bound(*main_s)
        b_ms, o_ms = nbytes / HBM_BYTES_PER_S, ops_n / INT32_OPS_PER_S
        op_lanes = main_s[2] != 0
        heavy = op_lanes & ((main_s[2] <= 3) | ((main_s[2] >= 13)
                                                & (main_s[2] <= 15)))
        sector_bytes = super_sector_bytes(*main_s)
        timed[name] = dict(
            ms=k_ms, plain_ms=p_ms, op_lanes=int(op_lanes.sum()),
            heavy_op_lanes=int(heavy.sum()), bound_bytes=nbytes,
            bound_operations=ops_n, bound_ms=max(b_ms, o_ms) * 1e3,
            bound_by="bytes" if b_ms >= o_ms else "operations",
            sector_bytes=sector_bytes,
            sector_bound_ms=sector_bytes / HBM_BYTES_PER_S * 1e3)
    main_t = timed[flag_main]
    asup = dict(ms=min(main_t["ms"]), plain_ms=min(main_t["plain_ms"]),
                bound_ms=main_t["bound_ms"], bound_by=main_t["bound_by"],
                max_abs_err=err, library_ms=None)
    emit(phase="kernel", name="apply_super", cases={
        k: list(v[2].shape) for k, v in sorted(super_cases.items())},
         main_case=flag_main, exact=True, max_abs_err=err,
         launches_on_main_path=fused_launch["apply_super"],
         ms=main_t["ms"], plain_ms=main_t["plain_ms"],
         ms_in_flagship_graph=prof_fused["apply_super_ms_per_step"],
         ops_in_main_case=main_t["op_lanes"], by_operands=timed,
         bound_bytes=main_t["bound_bytes"],
         bound_operations=main_t["bound_operations"],
         bound_ms=asup["bound_ms"], bound_by=asup["bound_by"],
         library="none")
    del super_cases, main_s, flag_rt, fc_rt, s_m, op_m, node_m, src_m, \
        pay_m, key_m

    # ---- kernel: the state fingerprint against its plain version ------------
    from madsim_tpu_torch.utils.hashing import (_KIND, _leaves, fingerprint,
                                                fingerprint_plain, fp_layout,
                                                fp_tile)
    main_f = fp_cases[f"flagship_step_{FLAG_STEPS}"]
    fp_meta = [(t.numel() // FLAG_B, _KIND[t.dtype]) for t in _leaves(main_f)]
    f_tile = fp_tile(fp_meta)
    f_smem = fp_layout(fp_meta, f_tile)[1]
    # one leaf off a 16-byte boundary (an int32 leaf 4 bytes: 4-byte copies;
    # a bool leaf 1 byte: an element at a time), one lane, a tile and one
    for name, st in (
            ("payload_one_element_in",
             main_f.replace(t_payload=unaligned(main_f.t_payload))),
            ("halted_one_byte_in",
             main_f.replace(halted=unaligned(main_f.halted))),
            ("B1", slice_lanes(main_f, 1)),
            (f"B{f_tile + 1}", slice_lanes(main_f, f_tile + 1))):
        fp_cases[f"flagship_step_{FLAG_STEPS}_{name}"] = st
    err = 0
    for name, st in fp_cases.items():
        out_k = fingerprint(st)
        out_p = fingerprint_plain(st)
        torch.cuda.synchronize()
        err = max(err, check_equal(f"fingerprint on {name}", out_k, out_p))
    fk, fpl, fk2, fpl2 = (graph_ms(lambda: fingerprint(main_f), 20),
                          cuda_ms(lambda: fingerprint_plain(main_f), 3),
                          graph_ms(lambda: fingerprint(main_f), 20),
                          cuda_ms(lambda: fingerprint_plain(main_f), 3))
    nbytes = fp_bound(main_f)
    fpk = dict(ms=min(fk, fk2), plain_ms=min(fpl, fpl2),
               bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
               max_abs_err=err, library_ms=None)
    emit(phase="kernel", name="fingerprint", cases={
        k: int(v.now.shape[0]) for k, v in sorted(fp_cases.items())},
         main_case=f"flagship_step_{FLAG_STEPS}", exact=True,
         max_abs_err=err, launches_on_main_path=fp_launches,
         ms=[fk, fk2], plain_ms=[fpl, fpl2], bound_bytes=nbytes,
         bound_ms=fpk["bound_ms"], bound_by="bytes", library="none",
         tile=f_tile, smem_bytes=f_smem)
    del fp_cases, main_f

    # ---- kernel: the threefry draws (K1) and the node rows (K4) -------------
    # their launches on a main path: the traced flagship's, and for the
    # torn-write flush's split and draw the wal_kv run's
    k1k4_launches = dict(fused_launch, **{
        k: wal_launch[k] for k in ("threefry_keys", "threefry_draw")})
    # edge operands, and every K1/K4 launch of the flagship's step 512
    k_cases = k1_edge_cases(dev, EDGE_B)
    node_tree = k1k4_cases["node_gather"][0][1][0]
    k_cases += [(case, k, "run", args, {}) for case, k, args in
                k4_edge_cases(dev, node_tree)]
    for k, calls in k1k4_cases.items():
        k_cases += [(f"flagship_step_{FLAG_CHUNK}_{i}_{m}", k, m, a, kw)
                    for i, (m, a, kw) in enumerate(calls)]
    for k, calls in wal_k1.items():
        k_cases += [(f"{case}_{i}_{m}", k, m, a, kw)
                    for i, (case, m, a, kw) in enumerate(calls)]
    # timed on the step's own calls: the flagship's fused keys, dup
    # section, first handler draw, node slice and node scatter; wal_kv's
    # torn-write flush split and draw (no flagship step launches them)
    flag_main = f"flagship_step_{FLAG_CHUNK}"
    k1k4_main = {
        "step_keys": (flag_main, *k1k4_cases["step_keys"][0]),
        "dup_draws": (flag_main, *k1k4_cases["dup_draws"][0]),
        "split_randint": (flag_main, *k1k4_cases["split_randint"][0]),
        "threefry_keys": next(c for c in wal_k1["threefry_keys"]
                              if c[1] == "split"),
        "threefry_draw": next(c for c in wal_k1["threefry_draw"]
                              if c[1] == "randint"),
        "node_gather": (flag_main, *k1k4_cases["node_gather"][0]),
        "put_rows_": (flag_main, *max(k1k4_cases["put_rows_"],
                                      key=lambda c: len(c[1][0])))}
    k1k4 = k1k4_kernel_phase(wrappers, k_cases, k1k4_main, k1k4_launches)
    # a flagship step's K1 launches all together (step_keys, dup_draws,
    # the handlers' split_randint), replayed in one graph beside the sum
    # of their bounds
    k1_calls = [(k, m, a, kw) for k in K1 for m, a, kw in k1k4_cases[k]]

    def step_k1_launches():
        return [getattr(wrappers[k], m)(*a, **kw)
                for k, m, a, kw in k1_calls]
    outs = step_k1_launches()
    kb = [k1_bound(k, m, a, kw, o)
          for (k, m, a, kw), o in zip(k1_calls, outs)]
    k1_bound_ms = sum(max(b / HBM_BYTES_PER_S, o / INT32_OPS_PER_S)
                      for b, o in kb) * 1e3
    k1_ms = [graph_ms(step_k1_launches, 50) for _ in range(2)]
    emit(phase="kernel", name="k1_launches_a_step",
         launches=[f"{k}.{m}" for k, m, _, _ in k1_calls], ms=k1_ms,
         bound_bytes=sum(b for b, _ in kb),
         bound_operations=sum(o for _, o in kb), bound_ms=k1_bound_ms)
    del k_cases, k1k4_cases, k1k4_main, node_tree, k1_calls, outs, wal_k1

    # ---- determinism and batch independence ---------------------------------
    # each runner twice on lanes 0..4095 alone, held against the same lanes
    # of the B=100,000 eager run: the eager runner at its first chunk, the
    # graph runner at the end
    for runner, steps, want in (("run", DET_EAGER_STEPS, flag_fp_chunk),
                                ("run_fused", FLAG_STEPS, flag_fp)):
        fps = []
        for rep in range(2):
            rt4 = workloads.flagship_runtime(device=dev)
            s = rt4.init_batch(np.arange(DET_B, dtype=np.uint32))
            per_det = step_launches(wrappers, rt4, s)
            reset_counts()
            t0 = time.perf_counter()
            if runner == "run":
                s, _ = rt4.run(s, steps, chunk=FLAG_CHUNK)
                torch.cuda.synchronize()
                counts = read_counts()
                launched = rt4.steps_run
            else:
                s = rt4.run_fused(s, steps, chunk=FLAG_CHUNK)
                torch.cuda.synchronize()
                counts = fused_launches(rt4, read_counts(), every)
                launched = rt4.steps_run + rt4.fused_stats["warmup_steps"]
            check(rt4.steps_run == steps,
                  f"determinism {runner}: {rt4.steps_run} steps")
            on_path |= check_once_per_step(
                f"determinism {runner}", counts, launched, names, per_det)
            fps.append(fingerprints_once(rt4, s, f"determinism {runner}"))
            emit(phase="determinism", runner=runner, run=rep, batch=DET_B,
                 steps=rt4.steps_run, launches=counts,
                 wall_s=time.perf_counter() - t0)
            del s
        same_twice = bool((fps[0] == fps[1]).all())
        same_as_big = bool((fps[0] == want[:DET_B]).all())
        emit(phase="determinism", runner=runner, lanes=DET_B, steps=steps,
             same_twice=same_twice, same_as_batch_100000=same_as_big,
             distinct_fingerprints=int(len(np.unique(fps[0]))))
        check(same_twice,
              f"determinism {runner}: two runs of lanes 0..4095 differ")
        check(same_as_big, f"batch independence {runner}: lanes 0..4095 "
              f"alone differ from the same lanes inside the B=100,000 run "
              f"at step {steps}")

    # ---- profile: where a flagship step's time goes, for each runner --------
    rt = workloads.flagship_runtime(device=dev)
    s = rt.init_batch(np.arange(FLAG_B, dtype=np.uint32))
    expect = dict({k: 1 for k in names}, **per_flag)
    prof_eager = profile_steps(
        lambda st, n: rt.run(st, n, chunk=n)[0], s, FLAG_B, expect)
    emit(phase="profile", runner="run", paths="kernels", **prof_eager)
    # the same steps with the threefry draws and the node rows as plain
    # PyTorch, in the same call (core/prng.py, the tree of
    # select.take_row, the functional select.put_row: the step before
    # those kernels)
    import madsim_tpu_torch.core.step as step_mod
    import madsim_tpu_torch.models.raft as raft_mod
    from madsim_tpu_torch.core import prng
    from madsim_tpu_torch.ops import node_rows as nr_mod
    from madsim_tpu_torch.ops import select as sel_mod
    from madsim_tpu_torch.ops import threefry as tf_mod
    draws = ("split", "fold_in", "randint", "randint_raw", "uniform",
             "bernoulli", "node_hash_key")
    fused = ("step_keys", "dup_draws", "split_randint")
    real_k = ({n: getattr(tf_mod, n) for n in draws + fused},
              nr_mod.node_gather, nr_mod.put_rows_)
    for n in draws:
        setattr(tf_mod, n, getattr(prng, n))
    for n in fused:
        setattr(tf_mod, n, getattr(tf_mod, n + "_plain"))
    nr_mod.node_gather = nr_mod.node_gather_plain
    nr_mod.put_rows_ = lambda writes: [sel_mod.put_row(*w) for w in writes]
    try:
        prof_plain_k = profile_steps(
            lambda st, n: rt.run(st, n, chunk=n)[0], s, FLAG_B,
            dict({k: 1 for k in names}, **{k: 0 for k in K1K4}))
    finally:
        for n, f in real_k[0].items():
            setattr(tf_mod, n, f)
        nr_mod.node_gather, nr_mod.put_rows_ = real_k[1:]
    emit(phase="profile", runner="run",
         paths="plain threefry draws and node rows",
         **prof_plain_k)
    # and with the supervisor op and the Raft check as plain PyTorch on
    # the card (the step before those kernels)
    real = step_mod.apply_super, raft_mod.raft_invariant_check
    step_mod.apply_super = lambda plan, *a: apply_super_plain(
        plan.cfg, plan.spec_default, plan.persist_mask, *a)
    raft_mod.raft_invariant_check = raft_invariant_plain
    expect_plain = dict({"emit_write": 1, "sched_pick": 1}, **per_flag)
    try:
        prof_plain = profile_steps(
            lambda st, n: rt.run(st, n, chunk=n)[0], s, FLAG_B,
            expect_plain)
    finally:
        step_mod.apply_super, raft_mod.raft_invariant_check = real
    emit(phase="profile", runner="run",
         paths="plain apply_super and raft_invariant",
         **prof_plain)
    del s, rt
    emit(phase="profile", runner="run_fused", trace_cap=64, **prof_fused)
    for what, prof in (("kernels", prof_eager),
                       ("plain K1/K4", prof_plain_k)):
        emit(phase="handler_split", runner="run", paths=what,
             ms_per_step=prof["handler_split"],
             sum_ms_per_step=prof["handler_split_ms_per_step"],
             handlers_section_ms_per_step=prof["section_ms_per_step"][
                 "handlers"] if prof["section_ms_per_step"] else None)
    for what, prof, want in (
            ("kernels", prof_eager, expect),
            ("plain K1/K4", prof_plain_k,
             dict({k: 1 for k in names}, **{k: 0 for k in K1K4})),
            ("plain K3/K11", prof_plain, expect_plain)):
        check(prof["kernel_launches"]
              == {k: PROF_STEPS * n for k, n in want.items()},
              f"profile run ({what}): traced launches "
              f"{prof['kernel_launches']} in {PROF_STEPS} steps")
        busy = prof["device_busy_ms_per_step"]
        check(prof["section_ms_per_step"] is not None,
              f"profile run ({what}): no section range in the trace")
        check(abs(prof["sections_ms_per_step"] - busy) <= 0.02 * busy,
              f"profile run ({what}): the sections hold "
              f"{prof['sections_ms_per_step']} of {busy} device ms a step")
    for what, prof in (("run", prof_eager), ("run_fused", prof_fused)):
        check(prof["int32_scan_ms_per_step"] == 0,
              f"profile {what}: an int32 scan is left in the step")

    check(on_path == set(K1K4),
          f"K1/K4 kernels on no checked path: {set(K1K4) - on_path}")

    # ---- kernels ------------------------------------------------------------
    emit(kernels=[
        dict(name="sched_pick", route="cuda",
             source="madsim_tpu_torch/csrc/sched_pick.cu",
             replaces="madsim_tpu/core/step.py:141",
             launches=fused_launch["sched_pick"],
             max_abs_err=sp["max_abs_err"], ms=sp["ms"],
             plain_ms=sp["plain_ms"], bound_ms=sp["bound_ms"],
             bound_by="bytes", library_ms=None),
        dict(name="emit_write", route="cuda",
             source="madsim_tpu_torch/csrc/emit_write.cu",
             replaces="madsim_tpu/core/step.py:476",
             launches=fused_launch["emit_write"],
             max_abs_err=ew["max_abs_err"], ms=ew["ms"],
             plain_ms=ew["plain_ms"], bound_ms=ew["bound_ms"],
             bound_by=ew["bound_by"], library_ms=None)] + [
        dict(name=k, route="cuda", source=f"madsim_tpu_torch/csrc/{src}",
             replaces=where, launches=n, **search_kernels[k])
        for k, src, where, n in (
            ("mutate", "mutate.cu", "madsim_tpu/search/mutate.py:471",
             fuzz_launch["mutate"]),
            ("apply_knobs", "apply_knobs.cu",
             "madsim_tpu/search/mutate.py:499", fuzz_launch["apply_knobs"]),
            ("coverage_digest", "coverage.cu",
             "madsim_tpu/parallel/stats.py:23", explore_launches))] + [
        dict(name=k, route="cuda", source=f"madsim_tpu_torch/csrc/{k}.cu",
             replaces=where, launches=n, **numbers)
        for k, where, n, numbers in (
            ("raft_invariant", "madsim_tpu/models/raft.py:586",
             fused_launch["raft_invariant"], ri),
            ("apply_super", "madsim_tpu/core/step.py:1007",
             fused_launch["apply_super"], asup),
            ("fingerprint", "madsim_tpu/utils/hashing.py:43", fp_launches,
             fpk))] + [
        dict(name=k, route="cuda", source=f"madsim_tpu_torch/csrc/{src}",
             replaces=where, launches=k1k4_launches[k], **k1k4[k])
        for k, src, where in (
            ("step_keys", "prng.cu", "madsim_tpu/core/step.py:138"),
            ("dup_draws", "prng.cu", "madsim_tpu/core/step.py:244"),
            ("split_randint", "prng.cu", "madsim_tpu/core/api.py:82"),
            ("threefry_keys", "prng.cu", "madsim_tpu/core/prng.py:24"),
            ("threefry_draw", "prng.cu", "madsim_tpu/core/prng.py:28"),
            ("node_gather", "node_rows.cu", "madsim_tpu/ops/select.py:66"),
            ("put_rows_", "node_rows.cu", "madsim_tpu/ops/select.py:76"))])
    emit(ok=True, device={"platform": "gpu",
                          "kind": torch.cuda.get_device_name(0),
                          "count": torch.cuda.device_count()})
    return 0


if __name__ == "__main__":
    sys.exit(main())
