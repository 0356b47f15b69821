#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (madsim_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA GPU and nvcc.
It builds the port's CUDA kernels from csrc/, then drives the port's main
path — the batched 5-node Raft chaos sweep at B=100,000 lanes — and holds
every kernel against its plain PyTorch version and the engine against the
frozen golden digests. One JSON object per line, in phases:

  device       torch / CUDA versions, the card's name and power limit
  build        nvcc of every kernel source, in parallel, with ptxas stats
  pingpong     the frozen golden pingpong workload (64 seeds, 4000 steps,
               chunk 256) through Runtime.run: its 67 engine-leaf digests
               must equal tests/data/golden_r22_leaves.json
  flagship     bench.py's Raft chaos config at B=100,000 for 2048 steps
               (chunk 512): no crash, no overflow, >90% of lanes live;
               seed-events/s, ms/step, peak device memory
  kernel       sched_pick against sched_pick_plain on edge-case tables and
               on tables captured from the flagship at steps 0, 512, 2048:
               exactly equal; kernel and plain times and the byte bound
  determinism  lanes 0..4095 alone, twice: fingerprints equal to each
               other and to lanes 0..4095 of the B=100,000 run
  profile      torch.profiler over 16 flagship steps at B=100,000: device
               kernels launched per step, device busy share, top kernels
  kernels      one line naming every kernel with its numbers

Each main path runs with every kernel's launch count set to 0 just before
and read just after; a kernel of the path that was not launched on every
step fails the run. Any failed check raises: the script exits nonzero and
prints no result. Its last line is
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
DET_B = 4096
PROF_STEPS = 16
HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory (data sheet)


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


def profile_steps(workloads, dev, np):
    """Trace PROF_STEPS flagship steps at full width with torch.profiler:
    device kernels per step, their summed device time against the wall
    time (the device's busy share), and the top kernels. Device numbers
    are null when the profiler records no device activity."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    rt = workloads.flagship_runtime(device=dev)
    s = rt.init_batch(np.arange(FLAG_B, dtype=np.uint32))
    s, _ = rt.run(s, 8, chunk=8)                  # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        s, _ = rt.run(s, PROF_STEPS, chunk=PROF_STEPS)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    dev_events = [e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
    launches = [e for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CPU
                and "LaunchKernel" in e.name]
    if not dev_events:
        return dict(steps=PROF_STEPS, wall_ms_per_step=wall_us / PROF_STEPS
                    / 1e3, device_busy_share=None,
                    device_kernels_per_step=None,
                    host_launches_per_step=len(launches) / PROF_STEPS)
    by_name: dict = {}
    for e in dev_events:     # a device event's span is its kernel time
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    busy_us = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return dict(
        steps=PROF_STEPS, batch=FLAG_B,
        wall_ms_per_step=wall_us / PROF_STEPS / 1e3,
        device_busy_ms_per_step=busy_us / PROF_STEPS / 1e3,
        device_busy_share=busy_us / wall_us,
        device_kernels_per_step=len(dev_events) / PROF_STEPS,
        host_launches_per_step=len(launches) / PROF_STEPS,
        sched_pick_ms_per_step=sum(
            t for n, t in by_name.items() if "sched_pick" in n)
        / PROF_STEPS / 1e3,
        top_kernels_ms_per_step=[[n[:80], t / PROF_STEPS / 1e3]
                                 for n, t in top])


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    try:
        from madsim_tpu_torch import interop, workloads
        from madsim_tpu_torch.ops import kernels
        from madsim_tpu_torch.ops.sched_pick import (sched_pick,
                                                     sched_pick_plain)
    except ImportError as e:
        print(f"chip_smoke: run from a checkout of the repository "
              f"({e})", file=sys.stderr)
        return 2
    import numpy as np

    dev = torch.device("cuda")
    wrappers = {"sched_pick": sched_pick}

    def reset_counts():
        for w in wrappers.values():
            w.launches = 0

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
                 if "registers" in ln or "spill" in ln]
             for k, r in report.items()}
    emit(phase="build", seconds=time.perf_counter() - t0,
         kernels=sorted(report), ptxas=ptxas)

    # ---- pingpong: the frozen golden digests --------------------------------
    with open(os.path.join(here, "tests", "data",
                           "golden_r22_leaves.json")) as f:
        golden = json.load(f)["pingpong"]["run"]
    p = workloads.PINGPONG_RUN
    rt = workloads.pingpong_runtime(device=dev)
    s = rt.init_batch(np.arange(p["seeds"], dtype=np.uint32))
    reset_counts()
    t0 = time.perf_counter()
    s, _ = rt.run(s, p["max_steps"], p["chunk"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    check(counts["sched_pick"] == rt.steps_run > 0,
          f"pingpong: sched_pick launches {counts} != steps {rt.steps_run}")
    got = interop.leaf_digests(s)
    engine = [k for k in golden if k not in workloads.RECORDER_LEAVES]
    bad = [k for k in engine if got.get(k) != golden[k]]
    emit(phase="pingpong", seeds=p["seeds"], steps_run=rt.steps_run,
         wall_s=wall, launches=counts, engine_leaves=len(engine),
         mismatched=bad, skipped_recorder_leaves=list(
             workloads.RECORDER_LEAVES))
    check(len(engine) == 67 and not bad,
          f"pingpong golden digests differ: {bad}")
    del s, rt

    # ---- flagship: the main path at full width ------------------------------
    rt = workloads.flagship_runtime(device=dev)
    s = rt.init_batch(np.arange(FLAG_B, dtype=np.uint32))
    captured = {0: select_inputs(s)}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    s, _ = rt.run(s, FLAG_CHUNK, chunk=FLAG_CHUNK)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    first_steps = rt.steps_run
    snap = select_inputs(s)        # outside the timed steady window
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    steps_mid = int(s.steps.sum())
    s, _ = rt.run(s, FLAG_STEPS - FLAG_CHUNK, chunk=FLAG_CHUNK)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    counts = read_counts()
    steps_run = first_steps + rt.steps_run
    captured[FLAG_CHUNK] = snap
    captured[FLAG_STEPS] = select_inputs(s)
    check(counts["sched_pick"] == steps_run == FLAG_STEPS,
          f"flagship: sched_pick launches {counts} != steps {steps_run}")
    flag_launches = counts
    crashed = int(s.crashed.sum())
    oops = int((s.oops != 0).sum())
    live = float((~s.halted).float().mean())
    steady = t3 - t2
    dispatched = int(s.steps.sum()) - steps_mid
    emit(phase="flagship", batch=FLAG_B, steps=steps_run, chunk=FLAG_CHUNK,
         launches=counts, first_chunk_s=t1 - t0, steady_s=steady,
         whole_run_seed_events_per_s=FLAG_B * FLAG_STEPS
         / (t1 - t0 + t3 - t2),
         ms_per_step=steady / (FLAG_STEPS - FLAG_CHUNK) * 1e3,
         seed_events_per_s=FLAG_B * (FLAG_STEPS - FLAG_CHUNK) / steady,
         dispatched_events_per_s=dispatched / steady,
         max_memory_allocated=torch.cuda.max_memory_allocated(),
         crashed=crashed, oops_lanes=oops, live=live,
         sim_seconds_max=float(s.now.max()) / 1e6)
    check(crashed == 0, f"flagship: {crashed} lanes crashed")
    check(oops == 0, f"flagship: {oops} lanes overflowed the event table")
    check(live > 0.9, f"flagship: only {live:.3f} of lanes live")
    flag_fp = rt.fingerprints(s)[:DET_B]
    del s

    # ---- kernel: sched_pick against its plain version -----------------------
    B, C = captured[0][0].shape
    N = captured[0][5].shape[1]
    cases = {"edges": edge_inputs(dev, B, C, N)}
    cases.update({f"flagship_step_{k}": v for k, v in captured.items()})
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
    # timed in turns (kernel, plain, kernel, plain); the t_kind and
    # t_deadline tables alone (~77 MB at B=100,000) exceed the 50 MB L2, so
    # each launch reads device memory
    k_ms = cuda_ms(lambda: sched_pick(*main_args), 50)
    p_ms = cuda_ms(lambda: sched_pick_plain(*main_args), 5)
    k_ms2 = cuda_ms(lambda: sched_pick(*main_args), 50)
    p_ms2 = cuda_ms(lambda: sched_pick_plain(*main_args), 5)
    nbytes = bound_bytes(*main_args)
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    emit(phase="kernel", name="sched_pick", cases=sorted(cases), batch=B,
         C=C, N=N, exact=True, max_abs_err=max_err,
         launches_on_main_path=flag_launches["sched_pick"],
         ms=[k_ms, k_ms2], plain_ms=[p_ms, p_ms2], bound_bytes=nbytes,
         bound_ms=bound_ms)

    # ---- determinism and batch independence ---------------------------------
    fps = []
    for rep in range(2):
        rt4 = workloads.flagship_runtime(device=dev)
        s = rt4.init_batch(np.arange(DET_B, dtype=np.uint32))
        reset_counts()
        t0 = time.perf_counter()
        s, _ = rt4.run(s, FLAG_STEPS, chunk=FLAG_CHUNK)
        torch.cuda.synchronize()
        counts = read_counts()
        check(counts["sched_pick"] == rt4.steps_run == FLAG_STEPS,
              f"determinism: launches {counts} != steps {rt4.steps_run}")
        fps.append(rt4.fingerprints(s))
        emit(phase="determinism", run=rep, batch=DET_B, steps=rt4.steps_run,
             launches=counts, wall_s=time.perf_counter() - t0)
        del s
    same_twice = bool((fps[0] == fps[1]).all())
    same_as_big = bool((fps[0] == flag_fp).all())
    emit(phase="determinism", lanes=DET_B, same_twice=same_twice,
         same_as_batch_100000=same_as_big,
         distinct_fingerprints=int(len(np.unique(fps[0]))))
    check(same_twice, "determinism: two runs of lanes 0..4095 differ")
    check(same_as_big, "batch independence: lanes 0..4095 alone differ "
          "from the same lanes inside the B=100,000 run")

    # ---- profile: where a flagship step's time goes -------------------------
    emit(phase="profile", **profile_steps(workloads, dev, np))

    # ---- kernels ------------------------------------------------------------
    emit(kernels=[dict(
        name="sched_pick", route="cuda",
        source="madsim_tpu_torch/csrc/sched_pick.cu",
        replaces="madsim_tpu/core/step.py:141",
        launches=flag_launches["sched_pick"], max_abs_err=max_err,
        ms=min(k_ms, k_ms2), plain_ms=min(p_ms, p_ms2), bound_ms=bound_ms,
        bound_by="bytes", library_ms=None)])
    emit(ok=True, device={"platform": "gpu",
                          "kind": torch.cuda.get_device_name(0),
                          "count": torch.cuda.device_count()})
    return 0


if __name__ == "__main__":
    sys.exit(main())
