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
               steps) on the card and on the CPU (in a process of its
               own, `chip_smoke.py --search-cpu OUT`, started after the
               build): equal results and equal corpora; the fuzzer finds
               more schedules than blind explore on the same budget
  flagship_same_on_both  the traced flagship (trace_cap=64) at B=203,
               128 steps, through run and run_fused on the card and run
               on the CPU: every leaf equal; the card's eager run launches
               each step kernel its count a step, the CPU run none
  compacting   the flagship's shapes halting at a commit index of 28 or
               10 simulated s (workloads.compacting_runtime, a long tail
               of halts) at B=100,000 through Runtime.run_compacting
               (chunk 512, min_batch 256): every lane halted, every leaf
               equal to run_fused of the same seeds (lane_diff and its
               plain version both find no difference), at least one
               repack, lane_take twice a repack and lane_put once a part;
               the widths, repacks, stash bytes, both wall times and the
               halting distribution
  detsan       detsan_check on the traced flagship at B=100,000, 2048
               steps, through run_fused: ok and no difference (lane_take
               and lane_diff launched once each); planted differences on
               its final state: `.now` moved in three lanes names exactly
               those, -0.0 against 0.0 and NaN against NaN in `.loss` are
               no difference, NaN against a number is; the moved state as
               the baseline raises DetSanFailure naming the first moved
               lane's seed
  minimize     the JAX package's tests/test_minimize.py red case (wal_kv,
               unsynced WAL, six kill/restart pairs, seed 0):
               minimize_scenario and a short fuzz(minimize=True) campaign
               on the card, and on the CPU in a process of its own started
               after the build: the same minimal script, info and fuzz
               result (the `minimized` table included)
  harness_misc  on the flagship: state_at(0, k) for k in 1, 37, 129
               equal to a direct run of k steps; find_divergence over 128
               steps finds none; a B=4096 checkpoint saved at step 512,
               loaded and resumed to 2048 gives the straight run's
               fingerprints
  planes       the plane flagship (workloads.plane_flagship_runtime: the
               flagship with the sim profiler and the latency plane,
               e2e from the leader's propose timer to its append
               replies, trace_cap=64) at B=100,000 for 2048 steps
               through run_fused, and run for the first 512: every leaf
               equal there, the fingerprints equal the plane-off
               flagship's, obs_fold
               launched once a step, lanes 0, 1, 4099 and 99,999 at
               step 1024 equal to a CPU run of those seeds (in a process
               of its own, `chip_smoke.py --planes-cpu OUT`, started
               after the build), the digests over every lane with
               completions and no more node dispatches than steps
               (plane_sums launched four times, lane_p99 once); and
  planes_profile  the plane-on graph step's device ms and obs_fold's ms
               a step beside the plane-off traced step's, the eager
               plane-on step split by section, and sched_pick with and
               without its occupancy output beside a plain count
  slo          slo_invariant (harness/slo.py) on a 2-node pingpong whose
               lanes all miss a 1-tick p99, B=4096: run_fused (the check
               inside the captured graph) equal to run, every lane
               CRASH_SLO, lanes 0..7 equal to a CPU run
  planes_all   the all-planes flagship (workloads.
               all_planes_flagship_runtime: the plane flagship with the
               prefix sketch, 16 series windows of 625 ms and the span
               plane, at an SLO target some completions miss) at
               B=100,000 for 2048 steps through run_fused, and run for
               the first 512: every leaf equal there, the plane-off
               fingerprints, obs_fold once a
               step, lanes 0, 1, 4099 and 99,999 at step 1024 equal to
               the CPU child's run, the series, attribution and sketch
               digests over every lane (plane_sums four launches,
               lane_burst one), and a set_window_len between two
               run_fused calls reaching the captured graph; with
               planes_all_profile, its graph step beside the plane-off
               one and its eager step by section (the span capture's
               `spans` section among them)
  recovery     recovery_invariant (harness/recovery.py) on four pingpong
               recipes (RECOVERY_RECIPES: a clog healed and a
               set_latency never healed, each judged so that every
               lane crashes, and so that none or some do), B=4096, 256
               steps: run_fused equal to run over the first 128, the
               expected CRASH_RECOVERY
               lanes, lanes 0..7 equal to a CPU run
  timetravel_flagship  the flagship at B=100,000 through
               run_fused(2048 steps, ckpt_every=1024): the plane-off
               fingerprints (a harvest never perturbs), snapshots at
               steps 0 and 1024 with each harvest's host seconds and
               bytes; lane 4099's checkpoint at 1024 through
               seed_batch_from(ck, 100,000) (one lane_take of 100,000
               repeats, equal to its plain version, every leaf owning
               its memory) and run_fused for the last 1024 steps: every
               lane ends on lane 4099's parent fingerprint, and the
               fork's lane 0 checkpointed on the card equals the
               parent's; at B=4096 over 512 steps run(ckpt_every=256)
               and run_fused(ckpt_every=256) harvest equal snapshots
  timetravel_explain  the crash-rich wal_kv with a 4-slot ring (24
               seeds, run(ckpt_every=32)): explain_crash(replay=True)
               of its first wrap-truncated crash returns a whole chain,
               divergence_report on a knob pair and a nudge pair with
               their pair traces, a LaneCheckpoint saved and loaded,
               each equal to a CPU run of the same seeds (in a process
               of its own, `chip_smoke.py --tt-cpu OUT`, started after
               the build), the traces byte for byte
  echo         BASELINE.md config 3 (workloads.echo_config3_runtime) at
               50,000 seeds, 20,000 steps at most, through run_fused and
               run: every leaf equal, lanes 0, 1, 25,000 and 49,999
               equal to the CPU child's, no crash, every client acked 10,
               each step kernel its count a step; the graph runner's
               seed-events/s, steps to halt, device ms a step, and the
               eager step's handlers section
  tpc_gossip   two_phase_commit under loss and two coordinator
               kill/restarts, its early_decide_quorum=2 bug variant, and
               gossip through a partition and heal, each at B=16,384
               through run_fused to the halt, run equal to run_fused leaf
               for leaf over the first 256 steps, four lanes equal
               to the CPU child's, the bug variant's crash verdicts on
               its first 512 lanes equal to the CPU's; each graph step's
               device ms and the eager step's handlers and invariant
               sections
  kv_config4   BASELINE.md config 4 (workloads.kv_config4_runtime: the
               replicated KV store on 5 Raft servers and 3 clients, log
               32) at its own 100,000 seeds in one batch through
               run_compacting: no crash, no overflow, every client done,
               all 100,000 client histories linearizable (the port's
               native checker, on the host), lanes 0-3 equal to a CPU
               run of the same seeds (in a process of its own,
               `chip_smoke.py --kv-cpu OUT`, started after the build),
               each step kernel its count a step (the graphs' replays and
               their warm-ups), no plain draw; steps to halt, wall
               seconds, seed-events/s (the engine alone, as config 4
               reckons it), the checker's seconds, the graph step's
               device ms; at B=4096 run_compacting equal to run_fused
  kv_bank      make_kv_runtime's defaults (log 64), the compaction chaos
               config (log 12, the window slides) and the bank chaos
               config (log 48) at B=4096 through run_fused to the halt,
               run equal to run_fused over the first 128 steps (the eager
               KV step is host-bound), four lanes equal to the CPU
               child's; the KV histories linearizable, every completed
               bank op's total the conserving 600; the poisoned bank
               replica crashing lanes with 501 or 102, its first 64
               lanes' verdicts the CPU's; each graph step's device ms and
               (bank_chaos) the eager step's handlers and invariant
               sections
  models_p9b   chain replication (workloads.chain_runtime: C=384, the
               reference's loss chaos) at B=16,384, and the streaming
               dataflow under mapper chaos, Percolator-lite at its
               defaults (C=256) and bench.py's sharded KV (three Raft
               groups, L=192, 48 node-state leaves; a cap of 512 steps,
               its client ops done by then printed) at B=4096, each
               through run_fused and run (equal over the first 128
               steps; the sharded KV's 32), four lanes equal to a CPU run
               (in a process of its own, `chip_smoke.py --p9b-cpu OUT`,
               started after fuzz_flagship; the sharded KV's at its cap,
               where the tier-1 tests hold its lanes 0 and 1 to the JAX
               package's), each step kernel its count a step (the sharded KV's raft_invariant three: one a
               group), no plain draw in an eager step: no crash (chain,
               ministream, sharded KV), every client done, every chain
               and sharded-KV history linearizable, every ministream
               epoch committed once; the red cells (chain's short master
               wait, ministream's overtaking barrier, Percolator's slow
               disk) and Percolator at its defaults (whose TTL hole
               crashes a few lanes with no fault injected, in the
               reference too) crashing the same lanes with the same
               codes as the CPU on their first 256 lanes; steps to halt,
               the graph step's device ms, kernels a step and busy share,
               seed-events/s, and (chain) the eager step's sections
               (the other cells' eager sections: `chip_smoke.py
               --p9b-profile`, a run of its own)
  kernel       each kernel against its plain version, exactly equal
               (the kernel's time is device time: launches captured in a
               CUDA graph and replayed between events):
               sched_pick on edge-case tables (B=100,000; B=1;
               B=100,003; C=33 and C=256 with N=32; C=257, 288, 320
               and 384 at B=4096, the wide instantiations; warp tiles
               that mix
               nudged, halted, tied, one-candidate, empty and parked
               lanes, also at C=384; every lane halted; tables not
               16-byte aligned, which the kernel copies 4 bytes at a
               time, also at C=384), each also with its occupancy output
               (the profiler's), and on tables captured from the
               flagship at steps 0, 512, 2048, from wal_kv at B=100,000,
               C=256, step 40, from PCT's nudged run and from chain
               replication at B=16,384, C=384, step 512 (timed too), with
               its registers a thread and resident blocks an SM (the
               occupancy API) beside its time as a graph replay and inside
               the profiled flagship graph; emit_write on edge-case
               operands at C=96, 256, 257, 288, 320 and 384 (full tables,
               masked
               emissions, clogged links, loss 0 and 1, jitter, skew, disk
               delay, a wrapping ring) and on operands captured from the
               traced flagship at steps 0 and 512, from wal_kv at step
               40 (32 golden lanes, and B=100,000) and from chain
               replication at step 512 (timed too), kernel and plain
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
               then read 4 bytes an access) or one lane off; the KV and
               bank log lengths 12, 48, 64, 96 and 192 with five and six
               field columns, with and without a slid window, and at 64
               and 192 one element off), and on the KV and bank cells'
               operands at step 512 (config 4 at B=100,000; kv_default,
               kv_snapshot, bank_chaos at B=4096), each timed beside its
               bound;
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
               and the handlers' two split_randint) timed together;
               lane_take, lane_put and lane_diff (run right after the
               detsan phase) on the traced flagship's final state at
               B=100,000 and on edge cases (B=1, a non-power-of-two T,
               repeated take indices, a leaf one element and one byte off
               a 16-byte boundary, zero-size, bool, uint32 and float32
               leaves), each timed as one launch replayed in a graph
               against its bytes and its plain version;
               obs_fold (K8) at the plane flagship's step-1024 operands
               and on edge cases (counters at int32 max, latencies at
               every power of two and its neighbours, both gates off, one
               plane compiled out, no complete_kinds, N=7, strided
               operands with plane leaves one element off a 16-byte
               boundary, B=1), timed as a graph of 20 calls each on its
               own copy of the plane leaves; emit_write with the plane
               columns (ev_root_t, tr_qlen, tr_lat, the delay sum) at
               those operands and on edge cases, beside its plane-off
               time; plane_sums and lane_p99 (K10) on the plane
               flagship's final state and on edge cases (counters near
               int32 max at B=100,000, negative words, masks off, a leaf
               of 300 columns, B=1, sparse histograms, an unaligned
               histogram), each against its plain version on the card
               and lane_p99 also against its plain version on the CPU;
               then obs_fold with its sketch, series and span groups at
               the all-planes flagship's step-1024 operands and on
               FOLD_PLANE_CASES (saturation, window boundaries and the
               clamp, every gate off, sketch_every=1, empty spans, the
               groups without the profiler and latency planes, strided
               and unaligned operands, B=1), emit_write with the span
               columns (ev_span, tr_qw) there and on edge cases,
               plane_sums with its max and or leaves on the series and
               attribution digests of the final state and on
               SERIES_DIGEST_CASES, and lane_burst (K10) on the final
               sr_lat and those cases, on the card and on the CPU
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
  kernels      one line naming every kernel with its numbers (K14
               lane_take also as lane_take_fork, the 100,000-repeat
               take of seed_batch_from, and lane_take_lane, the one-lane
               take of checkpoint_lane)

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
SAME_B, SAME_STEPS = 203, 128   # flagship_same_on_both
# the saturating campaign run on the card and on the CPU (bench.py's
# search A/B shape); dry_rounds past max_rounds: every round runs
SAT = dict(max_steps=1500, batch=128, max_rounds=6, chunk=256, rng_seed=7)
EDGE_B = 4096
STEP_KERNELS = ("emit_write", "sched_pick", "raft_invariant", "apply_super")
DET_B = 4096
DET_EAGER_STEPS = FLAG_CHUNK   # the eager determinism passes (host-bound)
PROF_STEPS = 16
PROF_PLAIN_STEPS = 4  # the flagship profiles of the plain K1/K4, K3/K11 paths
PROF_WINDOWS = 3     # traced windows at most, when records go missing
PROF_SETTLE_STEPS = 8  # traced steps before the window, left out of it
SETTLE_RANGE = "chip_smoke.settle"
HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory (data sheet)
# H100 SXM float32 peak outside the tensor cores (data sheet), taken as
# the rate of the kernels' 32-bit integer operations: the card's int32
# rate is no higher, so the bound it gives is a true lower bound
INT32_OPS_PER_S = 67e12


_T0 = time.perf_counter()


def emit(**obj):
    """One JSON line; a phase's line also carries the seconds since the
    script started (`t_s`)."""
    if "phase" in obj:
        obj["t_s"] = time.perf_counter() - _T0
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
    if isinstance(x, dict):
        return {k: clone_layout(v) for k, v in x.items()}
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


def emit_bound(tables, em, lane, ring, n_sends, use_jitter, delay=False):
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
      eight-word ring row;
    - with the plane columns: every lane's ev_root (and each written
      row's root word), its span_new words (and each written row's six
      ev_span words), its delay sum (delay), and for each recording
      lane the tr_qlen / tr_lat / tr_qw operand and word.
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
        plane_cols = sum(ring["cols"].get(k) is not None
                         and ring["cols"][k].shape[1] > 0
                         for k in ("tr_qlen", "tr_lat", "tr_qw"))
        nbytes += rec * 8 * plane_cols
    root = tables.get("ev_root_t")
    if E > 0 and root is not None and root.shape[1] > 0:
        nbytes += B * 4 + written * 4
    span = tables.get("ev_span")
    if E > 0 and span is not None and span.shape[1] > 0:
        nbytes += B * 24 + written * 24
    if E > 0 and delay:
        nbytes += B * 4
    return nbytes, ops


def emit_write_ms(kernel, plain, ops, pairs=2) -> dict:
    """The emission write's device ms on `ops` (in place, so each timed
    call restores the table and ring columns first; the restore alone is
    subtracted) beside its bound: `pairs` kernel timings as CUDA-graph
    replays of 20 calls (`ms`) and `pairs` of the plain version's eager
    calls (`plain_ms`), in turns; the restore's own ms, the kernel's
    eager launch, and emit_bound's bytes and operations with the bound
    they give."""
    from madsim_tpu_torch.ops.emit_write import RING_COLS, TABLE_COLS
    live = clone_tree(ops)
    restores = [(live[0][k], ops[0][k]) for k in TABLE_COLS]
    if ops[3] is not None:
        restores += [(live[3]["cols"][k], ops[3]["cols"][k])
                     for k in RING_COLS]

    def restore():
        for dst, src in restores:
            dst.copy_(src)

    ks, ps = [], []
    for _ in range(pairs):
        ks.append(graph_ms(lambda: (restore(), kernel(*live)), 20)
                  - graph_ms(restore, 20))
        ps.append(cuda_ms(lambda: (restore(), plain(*live)), 5)
                  - cuda_ms(restore, 5))
    nbytes, nops = emit_bound(*ops)
    b_ms = nbytes / HBM_BYTES_PER_S * 1e3
    o_ms = nops / INT32_OPS_PER_S * 1e3
    return dict(ms=ks, plain_ms=ps, restore_ms=graph_ms(restore, 20),
                eager_launch_ms=(cuda_ms(lambda: (restore(), kernel(*live)),
                                         20) - cuda_ms(restore, 20)),
                bound_bytes=nbytes, bound_operations=nops,
                bound_ms=max(b_ms, o_ms),
                bound_by="bytes" if b_ms >= o_ms else "operations")


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


def per_step_of(names) -> dict:
    """{step kernel: launches a step} of `names`: a list of kernels each
    launched once a step, or such a dict (sharded KV checks each of its
    three Raft groups with one raft_invariant launch)."""
    return dict(names) if isinstance(names, dict) else {k: 1 for k in names}


def check_once_per_step(what, launches, steps, names, per_step):
    """Each step kernel of `names` launched once a step (or as many times
    as `names` gives, a dict), every other step kernel (the Raft check,
    on a workload with no Raft) never; each K1/K4 kernel `per_step[k]`
    times a step (`step_launches`): those of ON_EVERY_STEP at least once,
    the rest where the path's step draws with them. Returns the K1/K4
    kernels the path ran."""
    each = per_step_of(names)
    for k in STEP_KERNELS:
        want = steps * each.get(k, 0)
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


def profile_steps(run, state, batch, expect, steps=PROF_STEPS):
    """Trace `steps` steps of `run(state, n)` with torch.profiler:
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
    More events than launches is never set aside: it fails the run. On
    the plain K3/K11 path the trace's first step lacked its first
    `step_keys` and `sched_pick` records in every window, whatever its
    length (F13), so each trace opens with PROF_SETTLE_STEPS steps in a
    range of their own, synchronized, and only host events after that
    range and device events from the window's first step on
    (`window_start`: not the copies the runner makes of its input first)
    count; `device_busy_ms_per_step_with_copies` is the same window
    counted from the end of the settle range, copies included (the
    reading of the profiles before the settle range)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    state = run(state, steps)                     # warm
    short = []
    for _ in range(PROF_WINDOWS):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            # the trace's first steps can lack device records (F13): a
            # settle range of PROF_SETTLE_STEPS steps, synchronized,
            # comes first, and only what starts after it is the window
            with record_function(SETTLE_RANGE):
                state = run(state, PROF_SETTLE_STEPS)
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            state = run(state, steps)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        after = max(e.time_range.end for e in prof.events()
                    if e.name == SETTLE_RANGE and e.device_type
                    == torch.autograd.DeviceType.CPU)
        dev_after = window_start(prof, after)
        dev_events = [e for e in prof.events()
                      if e.device_type == torch.autograd.DeviceType.CUDA
                      and not is_range(e.name) and e.name != SETTLE_RANGE
                      and e.time_range.start >= dev_after]
        traced = {k: sum(k in e.name for e in dev_events) for k in expect}
        want = {k: steps * n for k, n in expect.items()}
        check(all(traced[k] <= want[k] for k in expect),
              f"profile: traced launches {traced} in {steps} steps")
        if not dev_events or traced == want:
            break
        # which launches the trace lacks: each counted kernel's device
        # start times (us after the window's first device event)
        t_first = min(e.time_range.start for e in dev_events)
        short.append(dict(traced, steps=steps, starts_us={
            k: [round(e.time_range.start - t_first, 1) for e in dev_events
                if k in e.name][:4] for k in expect if expect[k]}))
    launches = [e for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CPU
                and "LaunchKernel" in e.name and e.time_range.start >= after]
    if not dev_events:
        return dict(steps=steps, batch=batch,
                    wall_ms_per_step=wall_us / steps / 1e3,
                    device_busy_share=None, device_kernels_per_step=None,
                    host_launches_per_step=len(launches) / steps,
                    kernel_launches=None)
    by_name: dict = {}
    for e in dev_events:     # a device event's span is its kernel time
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    busy_us = sum(by_name.values())
    copies_us = sum(e.time_range.elapsed_us() for e in prof.events()
                    if e.device_type == torch.autograd.DeviceType.CUDA
                    and not is_range(e.name) and e.name != SETTLE_RANGE
                    and after <= e.time_range.start < dev_after)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]

    def kernel_ms(tag):
        return sum(t for n, t in by_name.items() if tag in n) \
            / steps / 1e3

    # the eager step's ranges (a graph replay has none: the ranges are
    # host-side and a replay runs no host code)
    sections, handler_split, outside = section_split(prof, steps, after,
                                                     dev_after)
    return dict(
        steps=steps, batch=batch, short_windows=short,
        wall_ms_per_step=wall_us / steps / 1e3,
        device_busy_ms_per_step=busy_us / steps / 1e3,
        device_busy_ms_per_step_with_copies=(busy_us + copies_us) / steps
        / 1e3,
        device_busy_share=busy_us / wall_us,
        device_kernels_per_step=len(dev_events) / steps,
        host_launches_per_step=len(launches) / steps,
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
        top_kernels_ms_per_step=[[n[:80], t / steps / 1e3]
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


SECTIONS = ("select", "dup", "super", "spans", "handlers", "scatter",
            "emit", "stats", "obs", "invariant", "end")


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
               "threefry_draw", "node_gather", "put_rows", "obs_fold")


def window_start(prof, after):
    """Where the window's device work starts (the trace's clock, us): the
    device-side annotation of its first step's select range (the eager
    step), else its first `step_keys` kernel (a graph replay has no
    annotation), among the device events after `after`. The runners'
    copies of their input before the first step are not the steps'
    work."""
    import torch
    dev = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA
           and e.time_range.start >= after]
    starts = [e.time_range.start for e in dev
              if e.name == STEP_RANGE + "select"]
    if not starts:
        starts = [e.time_range.start for e in dev if "step_keys" in e.name]
    return min(starts) if starts else after


def section_split(prof, steps, after=None, dev_after=None):
    """(sections, handler split, outside): device ms a step of each
    section of the step (`live_step.<name>` profiler ranges, core/step.py)
    and of each handler range inside the handlers section
    (`live_handler.<name>`): the summed device time of the kernels the ops
    inside each range launched (the ranges' `device_time_total`), and of
    each hand-written kernel in the range whose device-side annotation,
    the innermost one, spans the kernel's start. A hand-written kernel
    that no annotation spans goes to the last annotation begun before it;
    `outside` counts those. None where the trace holds no range (a graph
    replay). With `after` (and `dev_after` for device events), only
    events that start at or after it (the trace's clock, us) count."""
    import torch
    out = {k: 0.0 for k in SECTIONS}
    sub: dict = {}
    notes, own = [], []
    ranges = 0
    if dev_after is None:
        dev_after = after
    for e in prof.events():
        first = (dev_after if e.device_type == torch.autograd.DeviceType.CUDA
                 else after)
        if first is not None and e.time_range.start < first:
            continue
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


def plain_draws_in_step(rt, state, skip=()):
    """({core/prng.py function: calls}, [shapes of the one-hot put_row
    writes of node_state, t_kind or t_deadline]) in one eager step of
    `state` (on a copy): every function of core/prng.py, wherever the
    port's modules bind it, and select.put_row are wrapped for the step.
    Node-state leaves named in `skip` are not counted (the fs leaves of
    the supervisor op's torn-write flush, plain PyTorch after the kernel:
    K3's queued remainder)."""
    import inspect
    import torch
    from madsim_tpu_torch.core import prng
    from madsim_tpu_torch.core.state import map_state
    from madsim_tpu_torch.ops import select as sel
    own = map_state(torch.clone, state)
    targets = {t.data_ptr() for t in [own.t_kind, own.t_deadline]
               + [v for k, v in own.node_state.items() if k not in skip]
               if t.numel()}
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


# ---- the harness phases (compacting, detsan, minimize, harness_misc) and
# ---- the lane kernels (K14 lane_take / lane_put, K15 lane_diff) ----------
COMPACT_STEPS = 4096     # every lane of compacting_runtime halts by ~2600
COMPACT_MIN_BATCH = 256
MIN_STEPS, MIN_CHUNK = 60_000, 16   # the minimize phase's runs
MIN_FUZZ = dict(batch=8, max_rounds=2, chunk=MIN_CHUNK)
STATE_AT_STEPS = (1, 37, 129)
DIVERGENCE_STEPS = 128
CKPT_B, CKPT_AT = 4096, 512
LANE_KERNELS = ("lane_take", "lane_put", "lane_diff")


# the d values a log2 bucket must place exactly: 0, every power of two
# and its neighbours, int32 max, and negatives (bucket 0)
def bucket_probes():
    vals = {0, -1, -5, 2**31 - 1}
    for j in range(31):
        vals |= {(1 << j) - 1, 1 << j, (1 << j) + 1}
    return sorted(v for v in vals if -2**31 <= v < 2**31)


FOLD_CASES = ("random", "int32_max", "buckets", "all_masked", "pf_only",
              "lh_only", "no_cpl", "n7", "strided_unaligned", "B1")
# the cases with the sketch, series and span groups compiled in too
FOLD_PLANE_CASES = ("planes_random", "planes_int32_max", "planes_windows",
                    "planes_every_1", "planes_masked", "planes_no_spans",
                    "planes_series_only", "planes_unaligned", "planes_B1")
FOLD_S, FOLD_W = 5, 6       # the edge cases' sketch slots and windows


def fold_edge_operands(dev, B, N, LB, seed, case="random"):
    """obs_fold operands for one edge case: (plan, planes, ops, has_cpl).
    random: counters below 1000, ~10% invalid lanes, gates ~80% on, acting
    nodes one either side of [0, N); int32_max: every counter within 3
    of int32 max and busy, delay and latencies up to int32 max; buckets:
    the latencies at every power of two and its neighbours; all_masked:
    both gates off; pf_only / lh_only: one plane compiled out; no_cpl:
    no complete_kinds; n7: N = 7; strided_unaligned: every [B] operand a
    view of stride 2 and every plane leaf one element off a 16-byte
    boundary (ROADMAP F19); B1: one lane. Those cases have the sketch,
    series and span groups compiled out (their operands are drawn after
    the others, so the other operands are those the profiler and
    latency fold alone were checked on). The planes_* cases compile
    them in (FOLD_S slots, FOLD_W windows): planes_random; planes_int32_max
    (every counter near int32 max); planes_windows (now on window
    boundaries, one tick either side, past the last window and
    negative); planes_every_1 (sketch_every = 1); planes_masked (every
    gate off); planes_no_spans (no completion: empty spans);
    planes_series_only (the sketch and series groups without the
    profiler and latency planes);
    planes_unaligned (strided operands, leaves off a 16-byte boundary);
    planes_B1."""
    import numpy as np
    import torch
    from madsim_tpu_torch.core.state import N_EV_KINDS
    from madsim_tpu_torch.ops.obs_fold import FoldPlan
    rng = np.random.default_rng(seed)
    K = N_EV_KINDS
    if case == "n7":
        N = 7
    if case in ("B1", "planes_B1"):
        B = 1
    I32 = 2**31 - 1
    new = case.startswith("planes_")
    S, W = (FOLD_S, FOLD_W) if new else (0, 0)

    def ints(lo, hi, shape):
        return torch.as_tensor(
            rng.integers(lo, hi, size=shape, dtype=np.int64)
            .astype(np.int32), device=dev)

    def bools(p, shape):
        return torch.as_tensor(rng.random(shape) < p, device=dev)

    nP = 0 if case in ("lh_only", "planes_series_only") else N
    nL = 0 if case in ("pf_only", "planes_series_only") else N
    lo, hi = ((I32 - 3, I32 + 1) if case in ("int32_max", "planes_int32_max")
              else (0, 1000))
    planes = dict(
        pf_dispatch=ints(lo, hi, (B, nP, K)), pf_busy=ints(lo, hi, (B, nP)),
        pf_kill=ints(lo, hi, (B, nP)), pf_restart=ints(lo, hi, (B, nP)),
        pf_qmax=ints(0, 200, (B,)), pf_drop=ints(lo, hi, (B,)),
        pf_delay=ints(lo, hi, (B,)), lh_sojourn=ints(lo, hi, (B, nL, LB)),
        lh_e2e=ints(lo, hi, (B, nL, LB)), lh_slo_miss=ints(lo, hi, (B, nL)))
    big = I32 if case in ("int32_max", "planes_int32_max") else 1 << 20
    if case == "buckets":
        probes = np.asarray(bucket_probes(), np.int64)
        lat = [torch.as_tensor(rng.choice(probes, B).astype(np.int32),
                               device=dev) for _ in range(2)]
    else:
        lat = [ints(0, big, (B,)) for _ in range(2)]
    valid = bools(0.9, (B,))
    ops = dict(
        valid=valid, pf_on=bools(0.8, (B,)), lh_on=bools(0.8, (B,)),
        reset_mask=bools(0.4, (B,)), dropped=bools(0.2, (B,)),
        is_complete=bools(0.5, (B,)) & valid,
        act_node=ints(-1, N + 1, (B,)), cpl_node=ints(0, N, (B,)),
        ev_kind=ints(0, K, (B,)), op=ints(0, 20, (B,)),
        now_delta=ints(0, big, (B,)), occ_disp=ints(0, 97, (B,)),
        high_water=ints(0, 97, (B,)), delivered_drop=ints(0, 9, (B,)),
        delay_acc=ints(0, big, (B,)), lat_sojourn=lat[0], lat_e2e=lat[1],
        slo_target=ints(0, 1 << 16, (B,)))
    # the sketch, series and span groups' leaves and operands
    span = new and nL > 0
    nS, nW_L = (N if span else 0), (W if nL else 0)
    planes.update(
        cov_sketch=ints(-2**31, 2**31, (B, S)),
        sr_dispatch=ints(lo, hi, (B, W, N)), sr_busy=ints(lo, hi, (B, W, N)),
        sr_qhw=ints(0, 200, (B, W)), sr_drop=ints(lo, hi, (B, W)),
        sr_dup=ints(lo, hi, (B, W)), sr_complete=ints(lo, hi, (B, W)),
        sr_slo_miss=ints(lo, hi, (B, W)),
        sr_lat=ints(lo, hi, (B, nW_L, LB if nL else 0)),
        sr_fault=ints(0, 128, (B, W)),
        sa_tail=ints(lo, hi, (B, nS, 4)), sa_bottleneck=ints(lo, hi, (B, nS)))
    every = ints(1, 9, (B,))
    wl = ints(1, 1000, (B,))
    ops.update(
        sr_on=bools(0.8, (B,)), sp_on=bools(0.8, (B,)),
        dup_fire=bools(0.3, (B,)) & valid,
        steps=ints(0, 3 * S * 9 + 2, (B,)), sketch_every=every,
        window_len=wl, now=ints(0, (W + 2) * 1000, (B,)),
        meas_sq=ints(0, big, (B,)), meas_sn=ints(0, big, (B,)),
        meas_sh=ints(0, 1 << 12, (B,)), meas_dnode=ints(-1, N + 2, (B,)),
        sched_hash=ints(-2**31, 2**31, (B, 2)))
    if new:
        # a third of the lanes on a sketch checkpoint exactly
        ck = ints(1, S + 2, (B,))
        on_ck = bools(0.35, (B,))
        ops["steps"] = torch.where(on_ck, ck * every, ops["steps"])
    if case == "planes_windows":
        k = ints(-1, W + 3, (B,))
        ops["now"] = k * wl + ints(-1, 2, (B,))
    if case == "planes_every_1":
        ops["sketch_every"] = torch.ones_like(every)
        ops["steps"] = ints(0, S + 3, (B,))
    if case in ("all_masked", "planes_masked"):
        for g in ("pf_on", "lh_on", "sr_on", "sp_on"):
            ops[g] = torch.zeros_like(ops[g])
    if case == "planes_no_spans":
        ops["is_complete"] = torch.zeros_like(ops["is_complete"])
    if case in ("strided_unaligned", "planes_unaligned"):
        ops = {k: (torch.stack([v, v], -1)[:, 0] if v.ndim == 1
                   else torch.stack([v, v], 1)[:, 0])
               for k, v in ops.items()}
        planes = {k: unaligned(v) for k, v in planes.items()}
    plan = FoldPlan(N, K, LB, dev, sketch_slots=S, windows=W, span=span)
    return (plan, planes, ops, case != "no_cpl")


DIGEST_CASES = ("random", "int32_max", "negative", "all_masked", "wide",
                "B1", "sparse")


def digest_edge_operands(dev, B, N, LB, seed, case="random"):
    """plane_sums and lane_p99 operands for one edge case: (leaves,
    masks, hist). The leaves stand for both digests' counters (the lane
    count, [B, N, 4], [B, N], [B], [B, N, LB] and [B, N] leaves under two
    masks); hist is an [B, N, LB] e2e histogram. random: counts below
    2^20 and ~half the lanes empty; int32_max: counters near int32 max
    (the hi sums wrap at B=100,000, as the JAX int32 sums do); negative:
    int32 values of either sign; all_masked: both masks off; wide: a
    leaf of 300 columns (more than a block's threads); B1: one lane;
    sparse: one sample in a few lanes (p99 at bucket 0 and 1)."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    if case == "B1":
        B = 1
    I32 = 2**31 - 1

    def ints(lo, hi, shape):
        return torch.as_tensor(
            rng.integers(lo, hi, size=shape, dtype=np.int64)
            .astype(np.int32), device=dev)

    lo, hi = {"int32_max": (I32 - 1000, I32 + 1),
              "negative": (-2**31, 2**31)}.get(case, (0, 1 << 20))
    masks = tuple(torch.as_tensor(rng.random(B) < 0.7, device=dev)
                  for _ in range(2))
    if case == "all_masked":
        masks = tuple(torch.zeros_like(m) for m in masks)
    leaves = [(None, 0), (ints(lo, hi, (B, N, 4)), 0),
              (ints(lo, hi, (B, N)), 0), (ints(lo, hi, (B,)), 0),
              (None, 1), (ints(lo, hi, (B, N, LB)), 1),
              (ints(lo, hi, (B, N)), 1)]
    if case == "wide":
        leaves.append((ints(lo, hi, (B, 300)), 1))
    if case == "sparse":
        hist = torch.zeros((B, N, LB), dtype=torch.int32, device=dev)
        lanes = rng.choice(B, max(1, B // 50), replace=False)
        hist[torch.as_tensor(lanes, device=dev),
             torch.as_tensor(rng.integers(0, N, len(lanes)), device=dev),
             torch.as_tensor(rng.integers(0, 2, len(lanes)), device=dev)] = 1
    else:
        hist = ints(lo, hi, (B, N, LB)) if case != "random" else ints(
            0, 4, (B, N, LB)) * (ints(0, 2, (B, 1, 1)))
        if case == "negative":
            hist = hist.abs()
    return leaves, masks, hist


SERIES_DIGEST_CASES = ("random", "negative", "int32_max", "all_masked",
                       "B1", "sparse", "unaligned")


def series_digest_operands(dev, B, W, N, LB, seed, case="random"):
    """plane_sums operands of the series and attribution digests with
    their max and or leaves, and a lane_burst histogram, for one edge
    case: (leaves, masks, sr_lat). The leaves stand for
    parallel/stats.py `_series_digest` (mask 0: the lane count,
    window_len max, six [B, W(, N)] sums, sr_qhw max, sr_fault or,
    sr_lat [B, W, LB]) and `_attribution_digest` (mask 1: the lane
    count, slo_target max, sa_tail [B, N, 4], sa_bottleneck [B, N]).
    random: counters below 2^20, ~half the windows empty; negative:
    int32 words of either sign (the max of where(mask, x, 0) and the OR
    of sign bits); int32_max: counters near int32 max; all_masked: both
    masks off; B1: one lane; sparse: one completion in a few lanes
    (p99 at buckets 0 and 1); unaligned: every leaf one element off a
    16-byte boundary (lane_burst's 4-byte copy)."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    if case == "B1":
        B = 1
    I32 = 2**31 - 1

    def ints(lo, hi, shape):
        return torch.as_tensor(
            rng.integers(lo, hi, size=shape, dtype=np.int64)
            .astype(np.int32), device=dev)

    lo, hi = {"int32_max": (I32 - 1000, I32 + 1),
              "negative": (-2**31, 2**31)}.get(case, (0, 1 << 20))
    masks = tuple(torch.as_tensor(rng.random(B) < 0.7, device=dev)
                  for _ in range(2))
    if case == "all_masked":
        masks = tuple(torch.zeros_like(m) for m in masks)
    if case == "sparse":
        lat = torch.zeros((B, W, LB), dtype=torch.int32, device=dev)
        lanes = rng.choice(B, max(1, B // 50), replace=False)
        lat[torch.as_tensor(lanes, device=dev),
            torch.as_tensor(rng.integers(0, W, len(lanes)), device=dev),
            torch.as_tensor(rng.integers(0, 2, len(lanes)), device=dev)] = 1
    elif case in ("int32_max", "negative"):
        lat = ints(lo, hi, (B, W, LB)).abs()
    else:
        lat = ints(0, 4, (B, W, LB)) * ints(0, 2, (B, W, 1))
    leaves = [(None, 0), (ints(lo, hi, (B,)), 0, "max"),
              (ints(lo, hi, (B, W, N)), 0), (ints(lo, hi, (B, W, N)), 0),
              (ints(lo, hi, (B, W)), 0), (ints(lo, hi, (B, W)), 0),
              (ints(lo, hi, (B, W)), 0), (ints(lo, hi, (B, W)), 0),
              (ints(lo, hi, (B, W)), 0, "max"),
              (ints(lo, hi, (B, W)) if case == "negative"
               else ints(0, 128, (B, W)), 0, "or"),
              (lat, 0), (None, 1), (ints(lo, hi, (B,)), 1, "max"),
              (ints(lo, hi, (B, N, 4)), 1), (ints(lo, hi, (B, N)), 1)]
    if case == "unaligned":
        leaves = [(None,) + lf[1:] if lf[0] is None
                  else (unaligned(lf[0]),) + lf[1:] for lf in leaves]
        lat = unaligned(lat)
    return leaves, masks, lat


def minimize_workload(device):
    """The JAX package's tests/test_minimize.py:24-40 red case: the
    unsynced-WAL wal_kv (2 clients, 12 ops, wal_cap 64) under six
    kill/restart pairs of its server; seed 0 loses an acknowledged
    write."""
    from madsim_tpu_torch import Scenario, ms
    from madsim_tpu_torch.models.wal_kv import make_wal_kv_runtime
    sc = Scenario()
    for t in range(6):
        sc.at(ms(150) + ms(250) * t).kill(0)
        sc.at(ms(210) + ms(250) * t).restart(0)
    return make_wal_kv_runtime(n_clients=2, n_ops=12, wal_cap=64,
                               sync_wal=False, scenario=sc, device=device)


def minimize_on(device):
    """The minimize phase's work on one device: minimize_scenario of seed
    0 and a short fuzz(minimize=True) campaign on minimize_workload, with
    their seconds."""
    import torch
    from madsim_tpu_torch.harness.minimize import minimize_scenario
    from madsim_tpu_torch.search import fuzz
    rt = minimize_workload(device)
    sync = torch.cuda.synchronize if device != "cpu" else (lambda: None)
    t0 = time.perf_counter()
    minimal, info = minimize_scenario(rt, 0, MIN_STEPS, MIN_CHUNK)
    sync()
    t1 = time.perf_counter()
    res = fuzz(rt, max_steps=MIN_STEPS, minimize=True, **MIN_FUZZ)
    sync()
    return dict(script=minimal.describe(), info=info, fuzz=res,
                scenario_s=t1 - t0, fuzz_s=time.perf_counter() - t1)


def minimize_cpu_main(out_path) -> int:
    """`chip_smoke.py --minimize-cpu OUT`: the minimize phase's CPU half,
    run beside the card's phases (it touches no card); its result is
    pickled to OUT for the main process, which wrote this file."""
    import pickle
    import torch
    torch.set_num_threads(2)
    res = minimize_on("cpu")
    with open(out_path, "wb") as f:
        pickle.dump(res, f)
    return 0


def state_equal(a, b) -> bool:
    """Every leaf of two states equal in dtype, shape and value."""
    import torch
    from madsim_tpu_torch.interop import state_leaves
    la, lb = state_leaves(a), state_leaves(b)
    return list(la) == list(lb) and all(
        x.dtype == y.dtype and x.shape == y.shape and torch.equal(x, y)
        for x, y in zip(la.values(), lb.values()))


def lane_leaves(state):
    from madsim_tpu_torch.interop import state_leaves
    return list(state_leaves(state).values())


def lane_rows_bytes(state, T) -> int:
    """The bytes a take or put of T lanes of `state` must move: each
    lane's row of every leaf read once and written once, and the int64
    index read once."""
    B = state.now.shape[0]
    row = sum(t.numel() // B * t.element_size() for t in lane_leaves(state))
    return 2 * T * row + 8 * T


def lane_diff_bytes(leaves) -> int:
    """The bytes a diff of two states must move: both read once, one flag
    byte a leaf and lane written."""
    B = leaves[0].shape[0]
    return 2 * sum(t.numel() * t.element_size() for t in leaves) \
        + len(leaves) * B


def lane_rows_ms(kernel, src, idx, put, dst=None, n=20):
    """Device ms of one lane_rows launch over every non-empty leaf of
    `src` (one parameter block, captured n times in a graph): a take of
    lanes idx into fresh rows, or (put) src's rows into dst at idx."""
    import torch
    from madsim_tpu_torch.ops.lane_rows import MAX_LEAVES, rows_params
    dev = src.now.device
    ls = lane_leaves(src)
    T = len(idx)
    if put:
        ld_ = lane_leaves(dst)
        B = ld_[0].shape[0]
    else:
        B = ls[0].shape[0]
        ld_ = [torch.empty((T,) + tuple(t.shape[1:]), dtype=t.dtype,
                           device=dev) for t in ls]
    pairs = [(s, d) for s, d in zip(ls, ld_) if s.numel()]
    check(len(pairs) <= MAX_LEAVES, f"lane_rows: {len(pairs)} leaves")
    ix = torch.as_tensor(idx, dtype=torch.int64, device=dev)
    p = rows_params(pairs, ix, T, B, put)
    return graph_ms(lambda: kernel._launch(p, dev), n)


def lane_diff_ms(kernel, a, b, n=20):
    """Device ms of one lane_diff launch over every leaf pair of two
    states (one parameter block, captured n times in a graph)."""
    import torch
    from madsim_tpu_torch.ops.lane_diff import MAX_LEAVES, diff_params
    la, lb = lane_leaves(a), lane_leaves(b)
    B = la[0].shape[0]
    check(len(la) <= MAX_LEAVES, f"lane_diff: {len(la)} leaves")
    flags = torch.empty((len(la), B), dtype=torch.uint8, device=la[0].device)
    p = diff_params(list(zip(la, lb)), flags, B)
    return graph_ms(lambda: kernel._launch(p, la[0].device), n)


def lane_kernel_phase(wrappers, a, b, moved, perm, launches, dev):
    """K14 and K15 against their plain versions, exactly, on the traced
    flagship's final state `a` at B=100,000 (b: the detsan run's permuted
    final state; moved: `a` with .now moved in three lanes) and on edge
    cases: B=1, a non-power-of-two T, repeated take indices, a leaf one
    element and one byte off a 16-byte boundary, zero-size leaves, bool,
    uint32 and float32 leaves (the state has them all); then each
    kernel's device time against its bound and its plain version's time.
    Returns {kernel: kernels-line numbers}."""
    import numpy as np
    import torch
    from madsim_tpu_torch.core.state import map_state
    from madsim_tpu_torch.ops.lane_diff import lane_diff_plain
    from madsim_tpu_torch.ops.lane_rows import lane_put_plain, \
        lane_take_plain
    take, put, diff = (wrappers[k] for k in LANE_KERNELS)
    B = a.now.shape[0]
    rng = np.random.default_rng(12)
    align = np.argsort(perm)
    pay_in = a.replace(t_payload=unaligned(a.t_payload))
    halt_in = a.replace(halted=unaligned(a.halted))
    one = slice_lanes(a, 1)
    odd = B * 7 // 9             # 77,777 at B=100,000: no power of two
    small = min(4099, B - 2)     # a tile's worth and a few lanes
    err = {k: 0 for k in LANE_KERNELS}
    names = {k: [] for k in LANE_KERNELS}

    def ix(i):
        return torch.as_tensor(i, dtype=torch.int64, device=dev)

    take_cases = {
        "flagship_align": (b, align),
        "flagship_repeated": (a, rng.integers(0, B, B)),
        f"flagship_T_{odd}": (a, rng.choice(B, odd, replace=False)),
        "flagship_keep_live_then_halted": (a, np.concatenate(
            [np.arange(1, B, 2), np.arange(0, B, 2)[:small]])),
        "B1_taken_thrice": (one, np.zeros(3, np.int64)),
        "payload_one_element_in": (pay_in, rng.permutation(B)[:small]),
        "halted_one_byte_in": (halt_in, rng.permutation(B)[:small + 2]),
    }
    for name, (st, i) in take_cases.items():
        out_k = take(st, i)
        out_p = lane_take_plain(st, ix(i))
        torch.cuda.synchronize()
        err["lane_take"] = max(err["lane_take"], check_equal(
            f"lane_take on {name}", lane_leaves(out_k), lane_leaves(out_p)))
        names["lane_take"].append(name)

    order = rng.permutation(B)
    put_cases = {
        # the merge of a compaction: a batch allocated once, two parts
        "flagship_merge": (map_state(torch.empty_like, a),
                           [order[:B // 3], order[B // 3:]], a),
        f"flagship_T_{odd}_into_a_copy": (map_state(torch.clone, moved),
                                          [order[:odd]], a),
        "into_payload_one_element_in": (
            a.replace(t_payload=unaligned(torch.zeros_like(a.t_payload))),
            [order[:small]], a),
        "from_halted_one_byte_in": (map_state(torch.clone, a),
                                    [order[:small + 2]], halt_in),
        "B1": (map_state(torch.empty_like, one), [np.zeros(1, np.int64)],
               one),
    }
    for name, (out0, parts, src) in put_cases.items():
        ok, op = clone_layout_state(out0), clone_layout_state(out0)
        for i in parts:
            part = lane_take_plain(src, ix(i))
            check(put(ok, i, part) is ok, f"lane_put on {name}: the "
                  f"result is not its output batch")
            lane_put_plain(op, ix(i), part)
        torch.cuda.synchronize()
        err["lane_put"] = max(err["lane_put"], check_equal(
            f"lane_put on {name}", lane_leaves(ok), lane_leaves(op)))
        names["lane_put"].append(name)
        if name == "flagship_merge":
            check(state_equal(ok, a), "lane_put: the merged batch is not "
                  "the state its parts came from")
    try:
        put(map_state(torch.clone, one), np.zeros(2, np.int64),
            slice_lanes(lane_take_plain(a, ix([0, 0])), 2))
        refused = False
    except ValueError:
        refused = True
    check(refused, "lane_put: repeated indices were not refused")

    la = a.replace(loss=a.loss.clone())
    lf = a.replace(loss=a.loss.clone())
    la.loss[0], lf.loss[0] = -0.0, 0.0
    la.loss[1], lf.loss[1] = float("nan"), float("nan")
    lf.loss[2] = float("nan")
    pay_moved = pay_in.replace(t_payload=unaligned(pay_in.t_payload))
    pay_moved.t_payload[small, 95, 7] += 1
    diff_cases = {
        "flagship_detsan": (a, lane_take_plain(b, ix(align))),
        "flagship_moved": (a, moved),
        "flagship_float_planted": (la, lf),
        "payload_one_element_in": (pay_in, pay_moved),
        "halted_one_byte_in": (halt_in, a),
        "B1": (one, slice_lanes(moved, 1)),
    }
    for name, (x, y) in diff_cases.items():
        lx, ly = lane_leaves(x), lane_leaves(y)
        out_k = diff(lx, ly)
        out_p = lane_diff_plain(lx, ly)
        torch.cuda.synchronize()
        err["lane_diff"] = max(err["lane_diff"], check_equal(
            f"lane_diff on {name}", out_k, out_p))
        names["lane_diff"].append(name)
        if name == "payload_one_element_in":
            check(int(out_k.sum()) == 1, "lane_diff: the planted payload "
                  "word was not the one difference")

    # times on the main operands: the detsan un-permute (a take of every
    # lane), its put back, and the detsan diff
    ix_align, ix_order = ix(align), ix(order)
    part = lane_take_plain(b, ix_align)
    out = map_state(torch.empty_like, a)
    times = {
        "lane_take": (lambda: lane_rows_ms(take, b, align, False),
                      lambda: lane_take_plain(b, ix_align),
                      lane_rows_bytes(b, B), "flagship_align"),
        "lane_put": (lambda: lane_rows_ms(put, part, order, True, out),
                     lambda: lane_put_plain(out, ix_order, part),
                     lane_rows_bytes(part, B), "flagship_put_every_lane"),
        "lane_diff": (lambda: lane_diff_ms(diff, a, part),
                      lambda: lane_diff_plain(lane_leaves(a),
                                              lane_leaves(part)),
                      lane_diff_bytes(lane_leaves(a)), "flagship_detsan"),
    }
    res = {}
    for k, (kern, plain, nbytes, main_case) in times.items():
        k_ms, p_ms, k_ms2, p_ms2 = kern(), cuda_ms(plain, 3), kern(), \
            cuda_ms(plain, 3)
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        res[k] = dict(ms=min(k_ms, k_ms2), plain_ms=min(p_ms, p_ms2),
                      bound_ms=bound, bound_by="bytes",
                      max_abs_err=err[k], library_ms=None)
        emit(phase="kernel", name=k, cases=names[k], main_case=main_case,
             batch=B, exact=True, max_abs_err=err[k],
             launches_on_main_path=launches[k], ms=[k_ms, k_ms2],
             plain_ms=[p_ms, p_ms2], bound_bytes=nbytes, bound_ms=bound,
             bound_by="bytes",
             library="none (one index_select / index_copy_ / ne().any() "
                     "a leaf)")
    return res


def zero_counts(wrappers):
    for w in wrappers.values():
        w.launches = 0
        w.captured = 0


def counts_of(wrappers):
    return {k: w.launches for k, w in wrappers.items()}


def compacting_phase(wrappers, dev):
    """The compacting phase; returns the lane kernels' launches in its
    run_compacting call."""
    import numpy as np
    import torch
    from madsim_tpu_torch import workloads
    from madsim_tpu_torch.ops.lane_diff import lane_diff, lane_diff_plain
    rt = workloads.compacting_runtime(device=dev)
    init = rt.init_batch(np.arange(FLAG_B, dtype=np.uint32))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ref = rt.run_fused(init, COMPACT_STEPS, chunk=FLAG_CHUNK)
    torch.cuda.synchronize()
    fused_wall = time.perf_counter() - t0
    fused_steps = rt.steps_run
    fused_peak = torch.cuda.max_memory_allocated()
    recs = []

    class Chunks:
        on_chunk = on_compact = on_done = staticmethod(recs.append)

    zero_counts(wrappers)
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = rt.run_compacting(init, COMPACT_STEPS, chunk=FLAG_CHUNK,
                            min_batch=COMPACT_MIN_BATCH, observer=Chunks())
    torch.cuda.synchronize()
    compact_wall = time.perf_counter() - t0
    # a capture at a new width releases the last graph and its pool: the
    # peak stays near the first width's graph plus the stash and output
    memory = dict(run_fused_peak=fused_peak, held_before=held,
                  run_compacting_peak=torch.cuda.max_memory_allocated(),
                  held_after=torch.cuda.memory_allocated(),
                  graphs_kept=len(rt._graphs))
    launch = counts_of(wrappers)
    cst = dict(rt.compact_stats)
    la, lb = lane_leaves(out), lane_leaves(ref)
    flags_k = lane_diff(la, lb)
    flags_p = lane_diff_plain(la, lb)
    halt_steps = out.steps.cpu().numpy()
    emit(phase="compacting", batch=FLAG_B, chunk=FLAG_CHUNK,
         min_batch=COMPACT_MIN_BATCH, max_steps=COMPACT_STEPS,
         widths=cst["widths"], repacks=cst["repacks"], chunks=cst["chunks"],
         steps=rt.steps_run, graph_captures=cst["captures"],
         stashed_lanes=cst["stashed_total"], stash_bytes=cst["stash_bytes"],
         launches={k: launch[k] for k in ("lane_take", "lane_put")},
         run_compacting_wall_s=compact_wall, run_fused_wall_s=fused_wall,
         run_fused_steps=fused_steps, memory_bytes=memory,
         chunk_records=[{k: r[k] for k in ("kind", "steps_done", "batch",
                                           "lanes_halted") if k in r}
                        for r in recs],
         events_when_halted_percentiles={
             str(q): float(np.percentile(halt_steps, q))
             for q in (0, 25, 50, 75, 90, 99, 100)},
         all_halted=bool(out.halted.all()),
         reference_all_halted=bool(ref.halted.all()),
         differing_flags_kernel=int(flags_k.sum()),
         differing_flags_plain=int(flags_p.sum()))
    check(bool(out.halted.all()) and bool(ref.halted.all()),
          "compacting: not every lane halted")
    check(int(flags_k.sum()) == 0 and int(flags_p.sum()) == 0,
          "compacting: run_compacting differs from run_fused")
    check(cst["repacks"] >= 1, "compacting: no repack")
    check(memory["graphs_kept"] == 1, "compacting: graphs of earlier widths "
          "kept")
    check(launch["lane_take"] == 2 * cst["repacks"]
          and launch["lane_put"] == cst["repacks"] + 1,
          f"compacting: lane_take / lane_put launched "
          f"{launch['lane_take']} / {launch['lane_put']} times for "
          f"{cst['repacks']} repacks")
    return launch


def detsan_phase(wrappers, dev, compact_launch):
    """The detsan phase, then the lane kernels' phase on its states;
    returns (the lane kernels' launches in its detsan_check call, their
    kernels-line numbers)."""
    import numpy as np
    import torch
    from madsim_tpu_torch import workloads
    from madsim_tpu_torch.harness.simtest import (DetSanFailure,
                                                  detsan_check, diff_states)
    from madsim_tpu_torch.ops.lane_diff import lane_diff, lane_diff_plain
    rt = workloads.flagship_runtime(device=dev, trace_cap=64)
    seeds = np.arange(FLAG_B, dtype=np.uint32)
    runs = []
    torch.cuda.synchronize()
    zero_counts(wrappers)
    t0 = time.perf_counter()
    with Spy(rt, "run_fused", after=runs.append) as spy:
        rep = detsan_check(rt, seeds, FLAG_STEPS, FLAG_CHUNK, fused=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launch = counts_of(wrappers)
    a, b = runs
    B = a.now.shape[0]
    moved_lanes = [11, 4242, B - 1]
    moved = a.replace(now=a.now.clone())
    moved.now[moved_lanes] += 1
    d_moved = diff_states(a, moved)
    la = a.replace(loss=a.loss.clone())
    lf = a.replace(loss=a.loss.clone())
    la.loss[0], lf.loss[0] = -0.0, 0.0
    la.loss[1], lf.loss[1] = float("nan"), float("nan")
    d_float_equal = diff_states(la, lf)
    lf.loss[2] = float("nan")
    d_float_nan = diff_states(la, lf)
    plain_agrees = all(
        torch.equal(lane_diff_plain(lane_leaves(x), lane_leaves(y)),
                    lane_diff(lane_leaves(x), lane_leaves(y)))
        for x, y in ((a, moved), (la, lf)))
    try:
        detsan_check(rt, seeds, FLAG_STEPS, FLAG_CHUNK, baseline_state=moved)
        raised = None
    except DetSanFailure as e:
        raised = e
    emit(phase="detsan", batch=B, steps=FLAG_STEPS, trace_cap=64,
         ok=rep["ok"], diffs=rep["diffs"], leaves=rep["leaves"],
         wall_s=wall, run_fused_wall_s=spy.seconds,
         launches={k: launch[k] for k in ("lane_take", "lane_diff")},
         planted_now=d_moved, planted_float_equal=d_float_equal,
         planted_float_nan=d_float_nan,
         baseline_failure_seed=None if raised is None else raised.seed,
         plain_agrees=plain_agrees)
    check(rep["ok"] and rep["diffs"] == [] and rep["batch"] == B,
          f"detsan: the traced flagship is not lane-independent: "
          f"{rep['diffs'][:4]}")
    check(launch["lane_diff"] == 1 and launch["lane_take"] == 1,
          f"detsan: lane_diff / lane_take launched {launch['lane_diff']} / "
          f"{launch['lane_take']} times, not once each")
    check(d_moved == [dict(leaf=".now", n_lanes=3, lanes=moved_lanes)],
          f"detsan: the moved clock gave {d_moved}")
    check(d_float_equal == [], f"detsan: -0.0 / 0.0 or NaN / NaN counted "
          f"as a difference: {d_float_equal}")
    check(d_float_nan == [dict(leaf=".loss", n_lanes=1, lanes=[2])],
          f"detsan: NaN against a number gave {d_float_nan}")
    check(plain_agrees, "detsan: lane_diff differs from its plain version")
    check(raised is not None and raised.seed == int(seeds[moved_lanes[0]]),
          "detsan: the moved baseline did not raise naming its seed")
    lane_k = lane_kernel_phase(
        wrappers, a, b, moved, np.asarray(rep["perm"]),
        dict(lane_take=compact_launch["lane_take"],
             lane_put=compact_launch["lane_put"],
             lane_diff=launch["lane_diff"]), dev)
    return launch, lane_k


def minimize_phase(wrappers, dev, cpu_job, cpu_path):
    """The minimize phase: the card's half here, the CPU's from the
    process `cpu_job`, which wrote `cpu_path`."""
    zero_counts(wrappers)
    card = minimize_on(dev)
    counts = counts_of(wrappers)
    cpu = wait_child(cpu_job, cpu_path, "minimize")
    fz_card, fz_cpu = card["fuzz"], cpu["fuzz"]
    mins = fz_card.get("minimized", {})
    emit(phase="minimize", seed=0, max_steps=MIN_STEPS, chunk=MIN_CHUNK,
         script=card["script"], info=card["info"],
         minimize_scenario_s_card=card["scenario_s"],
         minimize_scenario_s_cpu=cpu["scenario_s"],
         fuzz_s_card=card["fuzz_s"], fuzz_s_cpu=cpu["fuzz_s"],
         fuzz=MIN_FUZZ, crash_codes=sorted(fz_card["crash_repros"]),
         minimized={c: {k: v for k, v in m.items() if k != "knobs"}
                    for c, m in mins.items()},
         apply_knobs_launches=counts["apply_knobs"],
         script_equal=card["script"] == cpu["script"],
         info_equal=same_tree(card["info"], cpu["info"]),
         fuzz_equal=same_tree(fz_card, fz_cpu))
    check(card["info"]["crash_code"] == 301 and card["info"]["kept"] <= 6
          and card["info"]["dropped"] > 0, f"minimize: {card['info']}")
    check(card["script"] == cpu["script"]
          and same_tree(card["info"], cpu["info"]),
          "minimize: minimize_scenario differs between the card and the CPU")
    check(mins and all("script" in m for m in mins.values()),
          f"minimize: fuzz(minimize=True) minimized nothing: {mins}")
    check(same_tree(fz_card, fz_cpu),
          "minimize: fuzz(minimize=True) differs between the card and the "
          "CPU")


def harness_misc_phase(dev, tmp):
    """The harness_misc phase: time travel, divergence, checkpoints (the
    checkpoint file goes under `tmp`)."""
    import numpy as np
    from madsim_tpu_torch import workloads
    from madsim_tpu_torch.harness.determinism import find_divergence
    from madsim_tpu_torch.runtime import checkpoint
    rt = workloads.flagship_runtime(device=dev)
    t0 = time.perf_counter()
    at_equal = {}
    for k in STATE_AT_STEPS:
        got = rt.state_at(0, k)
        direct, _ = rt.run(rt.init_single(0), k, chunk=k)
        at_equal[k] = state_equal(got, direct)
    state_at_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    div = find_divergence(rt, 0, DIVERGENCE_STEPS)
    div_s = time.perf_counter() - t0
    s0 = rt.init_batch(np.arange(CKPT_B, dtype=np.uint32))
    straight = rt.run_fused(s0, FLAG_STEPS, chunk=FLAG_CHUNK)
    half = rt.run_fused(s0, CKPT_AT, chunk=FLAG_CHUNK)
    path = os.path.join(tmp, "ckpt.npz")
    t0 = time.perf_counter()
    checkpoint.save(path, half)
    t1 = time.perf_counter()
    loaded = checkpoint.load(path, rt.init_batch(np.arange(
        CKPT_B, dtype=np.uint32)))
    t2 = time.perf_counter()
    resumed = rt.run_fused(loaded, FLAG_STEPS - CKPT_AT, chunk=FLAG_CHUNK)
    same_fp = bool((rt.fingerprints(resumed)
                    == rt.fingerprints(straight)).all())
    loaded_equal = state_equal(loaded, half)
    emit(phase="harness_misc", state_at_steps=list(STATE_AT_STEPS),
         state_at_equal={str(k): v for k, v in at_equal.items()},
         state_at_and_direct_s=state_at_s, divergence=div,
         divergence_max_steps=DIVERGENCE_STEPS, divergence_s=div_s,
         checkpoint_batch=CKPT_B, checkpoint_at=CKPT_AT,
         checkpoint_bytes=os.path.getsize(path), save_s=t1 - t0,
         load_s=t2 - t1, loaded_equal=loaded_equal,
         resumed_fingerprints_equal=same_fp)
    check(all(at_equal.values()), f"harness_misc: state_at {at_equal}")
    check(div is None, f"harness_misc: find_divergence found {div}")
    check(loaded_equal and same_fp,
          "harness_misc: the checkpoint did not resume to the straight run")


def slo_phase(dev):
    """`harness.slo.slo_invariant` as a Runtime invariant on the card: a
    2-node pingpong whose every lane misses a 1-tick p99 (the JAX
    package's tests/test_latency.py case) at B=4096 through run_fused
    (the check captured in the graph) and run: every leaf equal, every
    lane crashed with CRASH_SLO, and lanes 0..7 equal to a CPU run."""
    import numpy as np
    import torch
    import madsim_tpu_torch as P
    from madsim_tpu_torch import interop
    from madsim_tpu_torch.core.types import CRASH_SLO
    from madsim_tpu_torch.harness.slo import slo_invariant
    from madsim_tpu_torch.models.pingpong import PingPong, state_spec

    def runtime(device):
        cfg = P.SimConfig(n_nodes=2, time_limit=P.sec(5), latency_hist=24,
                          complete_kinds=((P.EV_MSG, 1),),
                          net=P.NetConfig(send_latency_min=P.ms(1),
                                          send_latency_max=P.ms(4)))
        return P.Runtime(cfg, [PingPong(2, target=40)], state_spec(),
                         invariant=slo_invariant(p99_le=1, min_count=4),
                         device=device)
    seeds = np.arange(EDGE_B, dtype=np.uint32)
    rt = runtime(dev)
    t0 = time.perf_counter()
    f = rt.run_fused(rt.init_batch(seeds), 256, chunk=64)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    e, _ = rt.run(rt.init_batch(seeds), 256, chunk=64)
    cpu_rt = runtime("cpu")
    c, _ = cpu_rt.run(cpu_rt.init_batch(seeds[:8]), 256, chunk=64)
    lanes = interop.state_to_numpy(state_lanes(f, list(range(8))))
    cpu = interop.state_to_numpy(c)
    differ = [k for k in cpu if not (cpu[k] == lanes[k]).all()]
    codes = f.crash_code.cpu().numpy()
    emit(phase="slo", batch=EDGE_B, steps=256, run_fused_s=t1 - t0,
         run_equals_run_fused=state_equal(f, e),
         crash_slo_lanes=int((codes == CRASH_SLO).sum()),
         crash_steps=[int(np.min(f.steps.cpu().numpy())),
                      int(np.max(f.steps.cpu().numpy()))],
         cpu_leaves_differ=differ)
    check(state_equal(f, e), "slo: run and run_fused differ")
    check((codes == CRASH_SLO).all(), "slo: a lane did not crash CRASH_SLO")
    check(not differ, f"slo: lanes 0..7 differ from the CPU in {differ}")


def clone_layout_state(state):
    """map_state of clone_layout: a copy of every leaf laid out as the
    original is (an offset leaf stays off its boundary)."""
    from madsim_tpu_torch.core.state import map_state
    return map_state(clone_layout, state)


# ---- the observation planes (the profiler and latency planes, K8 obs_fold,
# ---- K10 plane_sums / lane_p99, K5's plane columns) ------------------------
# lanes of the plane flagship that a CPU run (a process of its own) repeats
PLANE_CPU_LANES = (0, 1, 4099, 99_999)
PLANE_CPU_STEPS = 1024      # the CPU lanes' step
PLANE_EAGER_STEPS = 512     # where run = run_fused (the eager step is
                            # host-bound)
                            # is checked (the eager runner is host-bound)


def planes_cpu_main(out_path) -> int:
    """`chip_smoke.py --planes-cpu OUT`: the CPU half of the planes and
    planes_all phases, the PLANE_CPU_LANES seeds of the plane flagship
    and of the all-planes flagship for PLANE_CPU_STEPS steps each on the
    CPU, run beside the card's phases (it touches no card); their leaves
    are pickled to OUT for the main process ({"planes": ...,
    "planes_all": ...})."""
    import pickle
    import numpy as np
    import torch
    from madsim_tpu_torch import interop, workloads
    torch.set_num_threads(2)
    out = {}
    for name, build in (("planes", workloads.plane_flagship_runtime),
                        ("planes_all",
                         workloads.all_planes_flagship_runtime)):
        rt = build(device="cpu")
        s, _ = rt.run(rt.init_batch(np.asarray(PLANE_CPU_LANES, np.uint32)),
                      PLANE_CPU_STEPS, chunk=FLAG_CHUNK)
        out[name] = interop.state_to_numpy(s)
    with open(out_path, "wb") as f:
        pickle.dump(out, f)
    return 0


def state_lanes(state, lanes):
    """The given lanes of a state (a gather: new tensors)."""
    import torch
    from madsim_tpu_torch.core.state import map_state
    idx = torch.as_tensor(lanes, dtype=torch.int64, device=state.now.device)
    return map_state(lambda t: t[idx], state)


def planes_phase(wrappers, dev, names, every, flag_fp, prof_off, cpu_job,
                 cpu_path, counts):
    """The plane flagship (workloads.plane_flagship_runtime: the flagship
    with profile=True, latency_hist=24, e2e from the leader's propose
    timer to its append replies, trace_cap=64) at B=100,000 for 2048
    steps through run_fused and the eager run: every leaf equal, the
    fingerprints the plane-off flagship's (`flag_fp`), obs_fold launched
    once a step, lanes PLANE_CPU_LANES at step 1024 equal to the CPU run
    of `cpu_job`, the digests sane (every lane counted, completions, every
    dispatch counted once); a graph profile of the plane-on step beside
    the plane-off one (`prof_off`). `counts` is (reset, read) of the
    launch counters. Returns what the kernel phase needs."""
    import numpy as np
    import torch
    import madsim_tpu_torch.core.step as step_mod
    from madsim_tpu_torch import interop, workloads
    from madsim_tpu_torch.parallel import stats
    reset_counts, read_counts = counts
    plane_every = list(every) + ["obs_fold"]
    rt = workloads.plane_flagship_runtime(device=dev)
    init = rt.init_batch(np.arange(FLAG_B, dtype=np.uint32))
    per = step_launches(wrappers, rt, init)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    s = rt.run_fused(init, PLANE_CPU_STEPS, chunk=FLAG_CHUNK)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    launches = fused_launches(rt, read_counts(), plane_every)
    steps_run = rt.steps_run
    warm = rt.fused_stats["warmup_steps"]
    half = interop.state_to_numpy(state_lanes(s, PLANE_CPU_LANES))
    fold_ops = step_operands(rt, s, step_mod, "obs_fold")
    emit_ops = step_operands(rt, s, step_mod, "emit_write")
    torch.cuda.synchronize()
    reset_counts()
    t2 = time.perf_counter()
    mid = s       # run's reference (run_fused leaves its input as it was)
    s = rt.run_fused(s, FLAG_STEPS - PLANE_CPU_STEPS, chunk=FLAG_CHUNK)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    more = fused_launches(rt, read_counts(), plane_every)
    launches = {k: launches[k] + more[k] for k in plane_every}
    steps_run += rt.steps_run
    check(steps_run == FLAG_STEPS, f"planes: {steps_run} steps")
    check_once_per_step("planes run_fused", launches, steps_run + warm,
                        names, per)
    check(launches["obs_fold"] == steps_run + warm,
          f"planes run_fused: obs_fold launched {launches['obs_fold']} "
          f"times in {steps_run + warm} steps")
    peak = torch.cuda.max_memory_allocated()
    # the eager runner on the same seeds
    reset_counts()
    t4 = time.perf_counter()
    e, _ = rt.run(init, PLANE_EAGER_STEPS, chunk=FLAG_CHUNK)
    torch.cuda.synchronize()
    t5 = time.perf_counter()
    eager = read_counts()
    check_once_per_step("planes run", eager, rt.steps_run, names, per)
    check(eager["obs_fold"] == rt.steps_run,
          f"planes run: obs_fold launched {eager['obs_fold']} times in "
          f"{rt.steps_run} steps")
    same_runners = state_equal(
        rt.run_fused(init, PLANE_EAGER_STEPS, chunk=FLAG_CHUNK), e)
    del e, init, mid
    fps = fingerprints_once(rt, s, "planes")
    same_fp = bool((fps == flag_fp).all())
    # the CPU run of a few lanes
    cpu_all = wait_child(cpu_job, cpu_path, "planes")
    cpu = cpu_all["planes"]
    cpu_diff = [k for k in half if not (half[k].shape == cpu[k].shape
                                        and (half[k] == cpu[k]).all())]
    # the digests (K10)
    reset_counts()
    pc = stats.profile_counters(s)
    lc = stats.latency_counters(s)
    p99 = stats.lane_e2e_p99(s)
    brief = stats.latency_brief(s)
    torch.cuda.synchronize()
    digest_launch = {k: wrappers[k].launches
                     for k in ("plane_sums", "lane_p99")}
    completions = int(lc["e2e_hist"].sum())
    dispatched = int(pc["dispatch"].sum())
    expect = dict({k: 1 for k in names}, **per, obs_fold=1)
    prof = profile_steps(lambda st, n: rt.run_fused(st, n, chunk=n), s,
                         FLAG_B, expect)
    # the eager plane-on step split by section, from a fresh batch (the
    # profile phase's plane-off window: steps 16-32)
    prof_e = profile_steps(lambda st, n: rt.run(st, n, chunk=n)[0],
                           rt.init_batch(np.arange(FLAG_B, dtype=np.uint32)),
                           FLAG_B, expect)
    # the profiler's pre-pop queue depth, an output of sched_pick: the
    # select with and without it, and the plain count it replaces, at the
    # step-2048 operands
    from madsim_tpu_torch.ops.sched_pick import sched_pick
    sel = select_inputs(s)
    occ_ms = dict(
        sched_pick=[graph_ms(lambda: sched_pick(*sel), 20)
                    for _ in range(2)],
        sched_pick_with_occupancy=[graph_ms(
            lambda: sched_pick(*sel, True), 20) for _ in range(2)],
        plain_count=graph_ms(
            lambda: (sel[0] != 0).sum(-1, dtype=torch.int32), 20))
    emit(phase="planes", runner="run_fused and run", batch=FLAG_B,
         steps=steps_run, chunk=FLAG_CHUNK, trace_cap=64,
         config=dict(profile=True, latency_hist=24,
                     complete_kinds="(EV_MSG, AER)",
                     root_kinds="(EV_TIMER, T_PROPOSE)"),
         launches=launches, eager_launches={k: eager[k] for k in
                                            plane_every},
         warmup_steps=warm, first_half_s=t1 - t0,
         steady_s=t3 - t2,
         ms_per_step=(t3 - t2) / (FLAG_STEPS - PLANE_CPU_STEPS) * 1e3,
         eager_ms_per_step=(t5 - t4) / PLANE_EAGER_STEPS * 1e3,
         eager_compared_at=PLANE_EAGER_STEPS,
         max_memory_allocated=peak,
         run_equals_run_fused=same_runners,
         fingerprints_equal_plane_off=same_fp,
         cpu_lanes=list(PLANE_CPU_LANES), cpu_steps=PLANE_CPU_STEPS,
         cpu_leaves_differ=cpu_diff, digest_launches=digest_launch,
         profiled_lanes=pc["lanes"], latency_lanes=lc["lanes"],
         dispatches=dispatched, steps_sum=pc["steps_sum"],
         completions=completions, e2e_p50=lc["e2e_p50"],
         e2e_p99=lc["e2e_p99"], e2e_p999=lc["e2e_p999"],
         sojourn_p99=lc["sojourn_p99"], slo_miss=lc["slo_miss"],
         lane_p99_max=int(p99.max()), lane_p99_zero=int((p99 == 0).sum()),
         queue_max=pc["qmax_max"], kills=int(pc["kill"].sum()),
         brief=brief)
    check(same_runners, "planes: run and run_fused differ")
    check(same_fp, "planes: fingerprints differ from the plane-off "
          "flagship's (the planes changed another leaf)")
    check(not cpu_diff, f"planes: lanes {PLANE_CPU_LANES} differ from the "
          f"CPU run in {cpu_diff}")
    check(pc["lanes"] == FLAG_B and lc["lanes"] == FLAG_B,
          f"planes: digests over {pc['lanes']} / {lc['lanes']} lanes")
    check(completions > 0 and lc["e2e_p99"] > 0, "planes: no completion")
    # a dispatch whose acting node is out of range (an op with no
    # target) is in no node's count
    check(0 < dispatched <= pc["steps_sum"],
          f"planes: {dispatched} dispatches counted, {pc['steps_sum']} "
          f"steps taken")
    check(p99.shape == (FLAG_B,) and (p99 > 0).any(),
          "planes: lane_e2e_p99 is empty")
    check(digest_launch == {"plane_sums": 4, "lane_p99": 1},
          f"planes: digest launches {digest_launch}")
    emit(phase="planes_profile", runner="run_fused", batch=FLAG_B,
         plane_on=prof, plane_off_device_busy_ms_per_step=prof_off.get(
             "device_busy_ms_per_step"),
         plane_on_device_busy_ms_per_step=prof.get(
             "device_busy_ms_per_step"),
         with_copies=dict(plane_off=prof_off.get(
             "device_busy_ms_per_step_with_copies"), plane_on=prof.get(
             "device_busy_ms_per_step_with_copies")),
         obs_fold_ms_per_step=prof["kernel_ms_per_step"]["obs_fold"]
         if prof["kernel_ms_per_step"] else None,
         emit_write_ms_per_step=dict(plane_on=prof.get(
             "emit_write_ms_per_step"), plane_off=prof_off.get(
             "emit_write_ms_per_step")), occ_disp_ms=occ_ms,
         eager_plane_on=dict(
             (k, prof_e.get(k)) for k in (
                 "device_busy_ms_per_step", "device_kernels_per_step",
                 "section_ms_per_step", "sections_ms_per_step",
                 "kernel_ms_per_step", "kernel_launches")))
    for what, pr in (("graph", prof), ("eager", prof_e)):
        check(pr["kernel_launches"] is None or pr["kernel_launches"]
              == {k: pr["steps"] * n for k, n in expect.items()},
              f"planes profile ({what}): traced launches "
              f"{pr['kernel_launches']} in {pr['steps']} steps")
    busy = prof_e.get("device_busy_ms_per_step")
    check(busy is None or abs(prof_e["sections_ms_per_step"] - busy)
          <= 0.02 * busy, f"planes profile (eager): the sections hold "
          f"{prof_e.get('sections_ms_per_step')} of {busy} device ms")
    return dict(launches=launches, digest_launch=digest_launch,
                fold_ops=fold_ops, emit_ops=emit_ops, state=s, prof=prof,
                cpu_all=cpu_all["planes_all"])


# the all-planes flagship: the plane flagship with the sketch, series and
# span planes too (workloads.all_planes_flagship_runtime)
RETUNE_STEPS = 64
RETUNE_WINDOW = 100_000       # ticks a window after the retune (100 ms)


def planes_all_phase(wrappers, dev, names, every, flag_fp, prof_off, cpu,
                     counts):
    """The all-planes flagship at B=100,000 for 2048 steps through
    run_fused and the eager run: every leaf equal, the fingerprints the
    plane-off flagship's (`flag_fp`), obs_fold once a step, lanes
    PLANE_CPU_LANES at step 1024 equal to the CPU child's run (`cpu`),
    the series, attribution and sketch digests over every lane with
    plane_sums and lane_burst launched their counts, `summarize`, and a
    set_window_len between two run_fused calls changing what the captured
    graph records (no new capture; equal to the eager run); a graph and
    an eager profile of the all-planes step beside the plane-off one
    (`prof_off`). Returns what the kernel phase needs."""
    import numpy as np
    import torch
    import madsim_tpu_torch.core.step as step_mod
    from madsim_tpu_torch import interop, workloads
    from madsim_tpu_torch.parallel import stats
    reset_counts, read_counts = counts
    plane_every = list(every) + ["obs_fold"]
    t_phase = time.perf_counter()
    rt = workloads.all_planes_flagship_runtime(device=dev)
    init = rt.init_batch(np.arange(FLAG_B, dtype=np.uint32))
    per = step_launches(wrappers, rt, init)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    s = rt.run_fused(init, PLANE_CPU_STEPS, chunk=FLAG_CHUNK)
    launches = fused_launches(rt, read_counts(), plane_every)
    steps_run = rt.steps_run
    warm = rt.fused_stats["warmup_steps"]
    half = interop.state_to_numpy(state_lanes(s, PLANE_CPU_LANES))
    fold_ops = step_operands(rt, s, step_mod, "obs_fold")
    emit_ops = step_operands(rt, s, step_mod, "emit_write")
    torch.cuda.synchronize()
    reset_counts()
    t2 = time.perf_counter()
    mid = s       # run's reference (run_fused leaves its input as it was)
    s = rt.run_fused(s, FLAG_STEPS - PLANE_CPU_STEPS, chunk=FLAG_CHUNK)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    more = fused_launches(rt, read_counts(), plane_every)
    launches = {k: launches[k] + more[k] for k in plane_every}
    steps_run += rt.steps_run
    check(steps_run == FLAG_STEPS, f"planes_all: {steps_run} steps")
    check_once_per_step("planes_all run_fused", launches, steps_run + warm,
                        names, per)
    check(launches["obs_fold"] == steps_run + warm,
          f"planes_all run_fused: obs_fold launched {launches['obs_fold']} "
          f"times in {steps_run + warm} steps")
    peak = torch.cuda.max_memory_allocated()
    reset_counts()
    t4 = time.perf_counter()
    e, _ = rt.run(init, PLANE_EAGER_STEPS, chunk=FLAG_CHUNK)
    torch.cuda.synchronize()
    t5 = time.perf_counter()
    eager = read_counts()
    check_once_per_step("planes_all run", eager, rt.steps_run, names, per)
    check(eager["obs_fold"] == rt.steps_run,
          f"planes_all run: obs_fold launched {eager['obs_fold']} times in "
          f"{rt.steps_run} steps")
    same_runners = state_equal(
        rt.run_fused(init, PLANE_EAGER_STEPS, chunk=FLAG_CHUNK), e)
    del e, mid
    fps = fingerprints_once(rt, s, "planes_all")
    same_fp = bool((fps == flag_fp).all())
    cpu_diff = [k for k in half if not (half[k].shape == cpu[k].shape
                                        and (half[k] == cpu[k]).all())]
    # the digests (K10): two confirmed plane_sums launches a digest, one
    # lane_burst
    reset_counts()
    sc = stats.series_counters(s)
    ac = stats.attribution_counters(s)
    burst = stats.lane_burst(s)
    torch.cuda.synchronize()
    digest_launch = {k: wrappers[k].launches
                     for k in ("plane_sums", "lane_burst")}
    div = stats.divergence_profile(s)
    summary = stats.summarize(rt, s)
    completions = int(sum(sc["complete"]))
    misses = int(sum(sc["slo_miss"]))
    # set_window_len between two run_fused calls: the same captured graph
    # records the new windows (F7)
    a = rt.run_fused(init, RETUNE_STEPS, chunk=FLAG_CHUNK)
    b = rt.run_fused(rt.set_window_len(a, RETUNE_WINDOW), RETUNE_STEPS,
                     chunk=FLAG_CHUNK)
    recaptured = rt.fused_stats["warmup_steps"]
    c = rt.run_fused(a, RETUNE_STEPS, chunk=FLAG_CHUNK)
    d, _ = rt.run(rt.set_window_len(a, RETUNE_WINDOW), RETUNE_STEPS,
                  chunk=FLAG_CHUNK)
    retune_changed = bool((b.sr_dispatch != c.sr_dispatch).any())
    retune_eager_equal = state_equal(b, d)
    retune_windows = int((b.window_len == RETUNE_WINDOW).sum())
    del a, b, c, d, init
    expect = dict({k: 1 for k in names}, **per, obs_fold=1)
    prof = profile_steps(lambda st, n: rt.run_fused(st, n, chunk=n), s,
                         FLAG_B, expect)
    prof_e = profile_steps(lambda st, n: rt.run(st, n, chunk=n)[0],
                           rt.init_batch(np.arange(FLAG_B, dtype=np.uint32)),
                           FLAG_B, expect)
    leaf_bytes = {k: getattr(s, k).element_size() * getattr(s, k).numel()
                  for k in ("ev_span", "sr_lat", "sr_dispatch", "sr_busy",
                            "sr_qhw", "sr_drop", "sr_dup", "sr_complete",
                            "sr_slo_miss", "sr_fault", "tr_qw",
                            "cov_sketch", "sa_tail", "sa_bottleneck")}
    emit(phase="planes_all", runner="run_fused and run", batch=FLAG_B,
         steps=steps_run, chunk=FLAG_CHUNK, trace_cap=64,
         config=dict(profile=True, latency_hist=24, sketch_slots=32,
                     sketch_every=64, series_windows=16,
                     window_len=workloads.all_planes_config()["window_len"],
                     span_attr=True,
                     slo_target=workloads.ALL_PLANES_SLO),
         launches=launches, eager_launches={k: eager[k] for k in
                                            plane_every},
         warmup_steps=warm, steady_s=t3 - t2,
         ms_per_step=(t3 - t2) / (FLAG_STEPS - PLANE_CPU_STEPS) * 1e3,
         eager_ms_per_step=(t5 - t4) / PLANE_EAGER_STEPS * 1e3,
         eager_compared_at=PLANE_EAGER_STEPS,
         max_memory_allocated=peak, new_leaf_bytes=leaf_bytes,
         run_equals_run_fused=same_runners,
         fingerprints_equal_plane_off=same_fp,
         cpu_lanes=list(PLANE_CPU_LANES), cpu_steps=PLANE_CPU_STEPS,
         cpu_leaves_differ=cpu_diff, digest_launches=digest_launch,
         series_lanes=sc["lanes"], attribution_lanes=ac["lanes"],
         completions=completions, slo_miss=misses,
         miss_share=misses / max(completions, 1),
         series_qhw_peak=max(sc["qhw"]), fault_windows=sc["fault"],
         e2e_p99_by_window=sc.get("e2e_p99_by_window"),
         tails=int(ac["tail"][:, 0].sum()),
         bottleneck=ac["bottleneck"], burst_max=int(burst.max()),
         burst_zero=int((burst == 0).sum()), divergence=div,
         summary={k: summary[k] for k in (
             "halted", "crashed", "distinct_outcomes", "distinct_schedules",
             "first_divergence", "series", "attribution")},
         retune=dict(steps=RETUNE_STEPS, window_len=RETUNE_WINDOW,
                     changed=retune_changed, recaptured_warmup=recaptured,
                     equals_eager=retune_eager_equal),
         phase_s=time.perf_counter() - t_phase)
    check(same_runners, "planes_all: run and run_fused differ")
    check(same_fp, "planes_all: fingerprints differ from the plane-off "
          "flagship's (a plane changed another leaf)")
    check(not cpu_diff, f"planes_all: lanes {PLANE_CPU_LANES} differ from "
          f"the CPU run in {cpu_diff}")
    check(sc["lanes"] == FLAG_B and ac["lanes"] == FLAG_B,
          f"planes_all: digests over {sc['lanes']} / {ac['lanes']} lanes")
    check(0 < misses < completions, f"planes_all: {misses} of "
          f"{completions} completions miss the SLO (want some, not all)")
    check(int(ac["tail"][:, 0].sum()) == misses,
          "planes_all: the tails are not the series plane's misses")
    check(burst.shape == (FLAG_B,) and (burst > 0).any(),
          "planes_all: lane_burst is empty")
    check(div is not None and div["batch"] == FLAG_B,
          f"planes_all: divergence profile {div}")
    check(digest_launch == {"plane_sums": 4, "lane_burst": 1},
          f"planes_all: digest launches {digest_launch}")
    check(retune_changed and recaptured == 0 and retune_eager_equal
          and retune_windows == FLAG_B,
          "planes_all: set_window_len did not reach the captured graph")
    emit(phase="planes_all_profile", runner="run_fused", batch=FLAG_B,
         plane_off_device_busy_ms_per_step=prof_off.get(
             "device_busy_ms_per_step"),
         all_planes_device_busy_ms_per_step=prof.get(
             "device_busy_ms_per_step"),
         with_copies=dict(plane_off=prof_off.get(
             "device_busy_ms_per_step_with_copies"), all_planes=prof.get(
             "device_busy_ms_per_step_with_copies")),
         all_planes_kernels_per_step=prof.get("device_kernels_per_step"),
         plane_off_kernels_per_step=prof_off.get("device_kernels_per_step"),
         obs_fold_ms_per_step=prof["kernel_ms_per_step"]["obs_fold"]
         if prof["kernel_ms_per_step"] else None,
         emit_write_ms_per_step=prof.get("emit_write_ms_per_step"),
         eager=dict((k, prof_e.get(k)) for k in (
             "device_busy_ms_per_step", "device_kernels_per_step",
             "section_ms_per_step", "sections_ms_per_step",
             "kernel_ms_per_step", "kernel_launches")))
    for what, pr in (("graph", prof), ("eager", prof_e)):
        check(pr["kernel_launches"] is None or pr["kernel_launches"]
              == {k: pr["steps"] * n for k, n in expect.items()},
              f"planes_all profile ({what}): traced launches "
              f"{pr['kernel_launches']} in {pr['steps']} steps")
    busy = prof_e.get("device_busy_ms_per_step")
    check(busy is None or abs(prof_e["sections_ms_per_step"] - busy)
          <= 0.02 * busy, f"planes_all profile (eager): the sections hold "
          f"{prof_e.get('sections_ms_per_step')} of {busy} device ms")
    return dict(launches=launches, digest_launch=digest_launch,
                fold_ops=fold_ops, emit_ops=emit_ops, state=s, prof=prof)


# recovery_runtime's recipes: (fault, the invariant's arguments, which
# lanes crash: "all", "some" or "none")
RECOVERY_RECIPES = {
    "heal": ("heal", dict(qhw_le=3, within=2), "all"),
    "noheal": ("noheal", dict(p99_le=400_000, within=2, min_count=2),
               "all"),
    # the heal judged at the queue high-water its healed windows reach
    "healed": ("heal", dict(qhw_le=4, within=2), "none"),
    # the p99 judged only in windows of 9 completions or more, which
    # some lanes' windows reach and some do not
    "noheal_some": ("noheal", dict(p99_le=400_000, within=2, min_count=9),
                    "some")}


def recovery_runtime(recipe, device):
    """bench.py `_make_recovery_runtime`'s two recipes on a 2-node
    pingpong at a fifth of their time scale (tests/test_torch_series.py
    `_recovery_rt`): windows of 125 ms, the fault at 240 ms in window 1;
    heal: clog node 0, unclog it at 520 ms; noheal: set_latency(30, 60
    ms) never healed; each judged as RECOVERY_RECIPES[recipe] says (p99
    thresholds in ticks of 1 us)."""
    import madsim_tpu_torch as P
    from madsim_tpu_torch.harness.recovery import recovery_invariant
    from madsim_tpu_torch.models.pingpong import PingPong, state_spec
    fault, inv, _ = RECOVERY_RECIPES[recipe]
    sc = P.Scenario()
    if fault == "heal":
        sc.at(P.ms(240)).clog_node(0)
        sc.at(P.ms(520)).unclog_node(0)
    else:
        sc.at(P.ms(240)).set_latency(P.ms(30), P.ms(60))
    inv = recovery_invariant(**inv)
    cfg = P.SimConfig(n_nodes=2, time_limit=P.sec(2), latency_hist=24,
                      series_windows=8, window_len=P.ms(125),
                      complete_kinds=((P.EV_MSG, 1),),
                      net=P.NetConfig(send_latency_min=P.ms(1),
                                      send_latency_max=P.ms(4)))
    return P.Runtime(cfg, [PingPong(2, target=1200)], state_spec(),
                     scenario=sc, invariant=inv, device=device)


RECOVERY_STEPS = 256
RECOVERY_EAGER_STEPS = 128   # where run = run_fused (host-bound)


def recovery_phase(dev):
    """`harness.recovery.recovery_invariant` as a Runtime invariant on the
    card, on the two pingpong recipes (`recovery_runtime`) at B=4096
    through run_fused (the check captured in the graph) and run: every
    leaf equal, CRASH_RECOVERY on every lane, some or none as the
    recipe says, and lanes 0..7 equal to a CPU run."""
    import numpy as np
    import torch
    from madsim_tpu_torch import interop
    from madsim_tpu_torch.core.types import CRASH_RECOVERY
    seeds = np.arange(EDGE_B, dtype=np.uint32)
    out = {}
    for recipe, (_, _, crashes) in RECOVERY_RECIPES.items():
        rt = recovery_runtime(recipe, dev)
        t0 = time.perf_counter()
        f = rt.run_fused(rt.init_batch(seeds), RECOVERY_STEPS, chunk=128)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        e, _ = rt.run(rt.init_batch(seeds), RECOVERY_EAGER_STEPS, chunk=128)
        same = state_equal(rt.run_fused(rt.init_batch(seeds),
                                        RECOVERY_EAGER_STEPS, chunk=128), e)
        cpu_rt = recovery_runtime(recipe, "cpu")
        c, _ = cpu_rt.run(cpu_rt.init_batch(seeds[:8]), RECOVERY_STEPS,
                          chunk=128)
        lanes = interop.state_to_numpy(state_lanes(f, list(range(8))))
        cpu = interop.state_to_numpy(c)
        differ = [k for k in cpu if not (cpu[k] == lanes[k]).all()]
        codes = f.crash_code.cpu().numpy()
        rec = codes == CRASH_RECOVERY
        steps = f.steps.cpu().numpy()
        out[recipe] = dict(
            run_fused_s=t1 - t0, run_equals_run_fused=same,
            crash_recovery_lanes=int(rec.sum()),
            crash_steps=([int(steps[rec].min()), int(steps[rec].max())]
                         if rec.any() else None),
            other_codes=sorted({int(x) for x in codes[~rec]}),
            cpu_leaves_differ=differ)
        check(same, f"recovery {recipe}: run and run_fused differ")
        check({"all": rec.all(), "some": rec.any() and not rec.all(),
               "none": not rec.any()}[crashes], f"recovery {recipe}: "
              f"{int(rec.sum())} of {rec.size} lanes crashed "
              f"CRASH_RECOVERY (want {crashes})")
        check(not differ, f"recovery {recipe}: lanes 0..7 differ from the "
              f"CPU in {differ}")
    emit(phase="recovery", batch=EDGE_B, steps=RECOVERY_STEPS, **out)


def fold_bound(planes, ops, has_cpl, plan=None) -> int:
    """The bytes the fold must move for these operands: every lane's 18
    operands of the profiler and latency groups (6 bytes of bools, 12
    int32) read once, and for each counter element it changes (this
    data's recording lanes and completions) the word read and written;
    pf_qmax, pf_drop and pf_delay of a profiled lane count as changed.
    With the plan's sketch, series and span groups: their operands too
    (steps, sketch_every and the two sched_hash words; sr_on, dup_fire,
    window_len and now; sp_on and the four meas words), each sketch
    checkpoint's word written, and each series and span word a
    recording lane changes read and written."""
    B = ops["valid"].shape[0]
    nbytes = B * (6 + 4 * 12)
    if plan is not None:
        nbytes += _fold_plane_bytes(plan, ops, has_cpl and (
            planes["lh_sojourn"].shape[1] > 0))
    pf = planes["pf_busy"].shape[1] > 0
    lh = planes["lh_sojourn"].shape[1] > 0
    N = planes["pf_busy"].shape[1] or planes["lh_sojourn"].shape[1]
    act_ok = (ops["act_node"] >= 0) & (ops["act_node"] < N)
    words = 0
    if pf:
        rec = ops["valid"] & ops["pf_on"]
        rm, op = ops["reset_mask"], ops["op"]
        words += int((rec & act_ok).sum()) * 2 + 3 * int(rec.sum())
        words += int((rec & act_ok & rm & ((op == 2) | (op == 3))).sum())
        words += int((rec & act_ok & rm & ((op == 1) | (op == 3))).sum())
    if lh:
        words += int((ops["valid"] & ops["lh_on"] & act_ok).sum())
        if has_cpl:
            done = ops["is_complete"] & ops["lh_on"]
            words += int(done.sum())
            words += int((done & (ops["slo_target"] > 0)
                          & (ops["lat_e2e"] > ops["slo_target"])).sum())
    return nbytes + 8 * words


def _fold_plane_bytes(plan, ops, has_cpl) -> int:
    """fold_bound's share for the sketch, series and span groups."""
    import torch
    B = ops["valid"].shape[0]
    valid = ops["valid"]
    nbytes = 0
    if plan.S > 0:
        period = torch.clamp(ops["sketch_every"], min=1)
        ck = torch.div(ops["steps"], period, rounding_mode="floor")
        at = valid & (ops["steps"] == ck * period) & (ck >= 1) \
            & (ck <= plan.S)
        nbytes += B * 16 + 4 * int(at.sum())
    if plan.W > 0:
        nbytes += B * 10
        rec = valid & ops["sr_on"]
        wl = torch.clamp(ops["window_len"], min=1)
        w_ok = torch.div(ops["now"], wl, rounding_mode="floor") >= 0
        rec = rec & w_ok
        act_ok = (ops["act_node"] >= 0) & (ops["act_node"] < plan.N)
        words = 2 * int((rec & act_ok).sum()) + 2 * int(rec.sum())
        words += int((rec & ops["dup_fire"]).sum())
        from madsim_tpu_torch.ops.obs_fold import fault_bits
        words += int((rec & (fault_bits(ops["op"], ops["reset_mask"])
                             != 0)).sum())
        if has_cpl:
            done = rec & ops["is_complete"]
            miss = done & (ops["slo_target"] > 0) \
                & (ops["lat_e2e"] > ops["slo_target"])
            words += 2 * int(done.sum()) + int(miss.sum())
        nbytes += 8 * words
    if plan.span:
        nbytes += B * 17
        tail = (ops["is_complete"] & ops["sp_on"] & (ops["slo_target"] > 0)
                & (ops["lat_e2e"] > ops["slo_target"]))
        cpl_ok = (ops["cpl_node"] >= 0) & (ops["cpl_node"] < plan.N)
        words = 4 * int((tail & cpl_ok).sum())
        words += int((tail & (ops["meas_dnode"] >= 0)).sum())
        nbytes += 8 * words
    return nbytes


def fold_ms(args, n=20, reps=3):
    """Device ms of one obs_fold launch (in place): n calls captured as
    one CUDA graph, each on its own copy of the plane leaves, the copies
    restored outside the timed replay; the least of `reps` replays."""
    import torch
    from madsim_tpu_torch.ops.obs_fold import obs_fold
    plan, planes, ops, has_cpl = args
    ops = {k: v.contiguous() for k, v in ops.items()}
    copies = [{k: v.clone() for k, v in planes.items()} for _ in range(n)]

    def restore():
        for c in copies:
            for k, v in c.items():
                v.copy_(planes[k])
    obs_fold(plan, copies[0], ops, has_cpl)          # warm: build, load
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for c in copies:
            obs_fold(plan, c, ops, has_cpl)
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(reps + 1):           # the first replay warms the graph
        restore()
        torch.cuda.synchronize()
        t0.record()
        graph.replay()
        t1.record()
        torch.cuda.synchronize()
        times.append(t0.elapsed_time(t1) / n)
    del graph
    return min(times[1:])


def digest_leaves(state):
    """Both digests' plane_sums leaves and masks of a plane state, as
    parallel/stats.py hands them to the kernel (one launch here)."""
    return ([(None, 0), (state.pf_dispatch, 0), (state.pf_busy, 0),
             (state.pf_kill, 0), (state.pf_restart, 0), (state.pf_drop, 0),
             (state.pf_delay, 0), (state.now, 0), (state.steps, 0),
             (None, 1), (state.lh_sojourn, 1), (state.lh_e2e, 1),
             (state.lh_slo_miss, 1)], (state.pf_on, state.lh_on))


def emit_plane_operands(args, seed, span=False):
    """An emit_write edge case with the plane columns added (a copy):
    random ev_root_t rows and ev_root, occ_disp and lat_ring operands
    (-1 in a third of the lanes) and the tr_qlen / tr_lat ring columns,
    with the delay sum on; with `span` the span plane's columns too:
    random ev_span rows and span_new (a dispatch's span vector), the
    tr_qw ring column and its lat_sojourn operand."""
    import numpy as np
    import torch
    tables, em, lane, ring, n_sends, jit = clone_tree(args)[:6]
    rng = np.random.default_rng(seed)
    B, C = tables["t_kind"].shape
    dev = tables["t_kind"].device

    def ints(lo, hi, shape):
        return torch.as_tensor(rng.integers(lo, hi, shape).astype(np.int32),
                               device=dev)
    tables["ev_root_t"] = ints(-1, 1 << 20, (B, C))
    lat = ints(0, 1 << 20, (B,))
    lane.update(ev_root=ints(-1, 1 << 20, (B,)), occ_disp=ints(0, C + 1,
                                                                (B,)),
                lat_ring=torch.where(ints(0, 3, (B,)) == 0, -1, lat))
    if ring is not None:
        TC = ring["cols"]["tr_now"].shape[1]
        ring["cols"]["tr_qlen"] = ints(0, 100, (B, TC))
        ring["cols"]["tr_lat"] = ints(-1, 100, (B, TC))
    if span:
        tables["ev_span"] = ints(-1, 1 << 20, (B, C, 6))
        lane.update(span_new=ints(-1, 1 << 20, (B, 6)),
                    lat_sojourn=ints(0, 1 << 20, (B,)))
        if ring is not None:
            ring["cols"]["tr_qw"] = ints(0, 100, (B, TC))
    return (tables, em, lane, ring, n_sends, jit, True)


def plane_kernel_phase(wrappers, dev, planes_out, emit_off_ms):
    """K8 obs_fold, K5 emit_write with its plane columns and K10
    plane_sums / lane_p99 against their plain versions, exactly: at the
    plane flagship's step-1024 operands and its final state (B=100,000),
    and on edge cases (fold: counters at int32 max, latencies at every
    power of two and its neighbours, both gates off, one plane compiled
    out, no complete_kinds, N=7, strided operands and plane leaves one
    element off a 16-byte boundary, B=1; digests: counters near int32
    max (the hi sums wrap at B=100,000), negative words, masks off, a
    leaf of 300 columns, B=1, sparse histograms; emit_write's edge cases
    with random plane columns). The fold and the write run on copies
    (F21). Returns each kernel's numbers for the kernels line."""
    import torch
    from madsim_tpu_torch.ops.emit_write import (emit_write,
                                                 emit_write_plain)
    from madsim_tpu_torch.ops.obs_fold import obs_fold, obs_fold_plain
    from madsim_tpu_torch.ops.plane_digest import (lane_p99,
                                                   lane_p99_plain,
                                                   plane_sums,
                                                   plane_sums_plain)
    state = planes_out["state"]
    # ---- K8 obs_fold
    fold_cases = {"plane_flagship_step_1024": planes_out["fold_ops"]}
    for i, case in enumerate(FOLD_CASES):
        fold_cases[case] = fold_edge_operands(dev, FLAG_B if case ==
                                              "int32_max" else EDGE_B, 5,
                                              24, 100 + i, case)
    err_f = 0
    for name, (plan, planes, ops, has_cpl) in fold_cases.items():
        a, b = clone_layout(planes), clone_layout(planes)
        obs_fold(plan, a, ops, has_cpl)
        obs_fold_plain(plan, b, ops, has_cpl)
        torch.cuda.synchronize()
        err_f = max(err_f, check_equal(f"obs_fold on {name}", a, b))
    main_f = fold_cases["plane_flagship_step_1024"]
    fk, fk2 = fold_ms(main_f), fold_ms(main_f)
    live = clone_tree(main_f[1])
    fp_ms = cuda_ms(lambda: obs_fold_plain(main_f[0], live, main_f[2],
                                           main_f[3]), 5)
    f_bytes = fold_bound(*main_f[1:])
    fold = dict(ms=min(fk, fk2), plain_ms=fp_ms,
                bound_ms=f_bytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
                max_abs_err=err_f, library_ms=None)
    emit(phase="kernel", name="obs_fold", cases={
        k: int(v[2]["valid"].shape[0]) for k, v in fold_cases.items()},
         exact=True, max_abs_err=err_f,
         launches_on_main_path=planes_out["launches"]["obs_fold"],
         ms=[fk, fk2], plain_ms=fp_ms, bound_bytes=f_bytes,
         bound_ms=fold["bound_ms"], bound_by="bytes",
         ms_in_plane_graph=planes_out["prof"]["kernel_ms_per_step"][
             "obs_fold"] if planes_out["prof"]["kernel_ms_per_step"]
         else None, library="none")
    del fold_cases, live
    # ---- K5 emit_write with the plane columns
    emit_cases = {"plane_flagship_step_1024": planes_out["emit_ops"]}
    for C_e, E_e, ns_e, jit_e in ((96, 12, 7, True), (96, 0, 0, False),
                                  (256, 5, 0, True), (288, 9, 4, False),
                                  (384, 12, 7, True)):
        base = emit_edge_operands(dev, 4096, C_e, 5, 8, E_e, ns_e, jit_e,
                                  True, True, seed=C_e + E_e)
        emit_cases[f"edges_C{C_e}_E{E_e}_planes"] = emit_plane_operands(
            base, C_e + E_e)
    err_e = 0
    for name, args in emit_cases.items():
        a, b = clone_tree(args), clone_tree(args)
        out_k = emit_write(*a)
        out_p = emit_write_plain(*b)
        torch.cuda.synchronize()
        check("delay_acc" in out_k[1], f"emit_write on {name}: no delay")
        err_e = max(err_e, check_equal(f"emit_write (planes) on {name}",
                                       (a[0], a[3], out_k),
                                       (b[0], b[3], out_p)))
    main_e = emit_cases["plane_flagship_step_1024"]
    live = clone_tree(main_e)
    restores = [(live[0][k], main_e[0][k]) for k in main_e[0]] + [
        (live[3]["cols"][k], main_e[3]["cols"][k]) for k in main_e[3]["cols"]]

    def restore():
        for dst, src in restores:
            dst.copy_(src)
    ek = [graph_ms(lambda: (restore(), emit_write(*live)), 20)
          - graph_ms(restore, 20) for _ in range(2)]
    e_bytes, e_ops = emit_bound(*main_e)
    emit(phase="kernel", name="emit_write", planes=True,
         cases=sorted(emit_cases), exact=True, max_abs_err=err_e,
         ms=ek, plane_off_ms=emit_off_ms, bound_bytes=e_bytes,
         bound_ms=max(e_bytes / HBM_BYTES_PER_S, e_ops / INT32_OPS_PER_S)
         * 1e3, launches_on_main_path=planes_out["launches"]["emit_write"])
    del emit_cases, live, restores
    # ---- K10 plane_sums and lane_p99
    leaves, masks = digest_leaves(state)
    sum_cases = {"plane_flagship_step_2048": (leaves, masks)}
    p99_cases = {"plane_flagship_step_2048": state.lh_e2e}
    for i, case in enumerate(DIGEST_CASES):
        B = FLAG_B if case in ("int32_max", "random") else EDGE_B
        lv, ms_, hist = digest_edge_operands(dev, B, 5, 24, 200 + i, case)
        sum_cases[case] = (lv, ms_)
        p99_cases[case] = hist
    p99_cases["unaligned"] = unaligned(state.lh_e2e)
    err_s = err_p = 0
    for name, (lv, ms_) in sum_cases.items():
        err_s = max(err_s, check_equal(f"plane_sums on {name}",
                                       plane_sums(lv, ms_),
                                       plane_sums_plain(lv, ms_)))
    for name, hist in p99_cases.items():
        err_p = max(err_p, check_equal(f"lane_p99 on {name}", lane_p99(hist),
                                       lane_p99(hist.cpu()).to(dev)))
        err_p = max(err_p, check_equal(
            f"lane_p99 on {name} (plain on the card)", lane_p99(hist),
            lane_p99_plain(hist, lane_p99.q(dev))))
    sk = [graph_ms(lambda: plane_sums(leaves, masks), 20) for _ in range(2)]
    sp = cuda_ms(lambda: plane_sums_plain(leaves, masks), 5)
    s_bytes = sums_bound(leaves, masks)
    hist = state.lh_e2e
    pk = [graph_ms(lambda: lane_p99(hist), 20) for _ in range(2)]
    q = lane_p99.q(dev)
    pp = cuda_ms(lambda: lane_p99_plain(hist, q), 5)
    p_bytes = hist.numel() * 4 + hist.shape[0] * 4
    sums = dict(ms=min(sk), plain_ms=sp,
                bound_ms=s_bytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
                max_abs_err=err_s, library_ms=None)
    p99 = dict(ms=min(pk), plain_ms=pp,
               bound_ms=p_bytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
               max_abs_err=err_p, library_ms=None)
    emit(phase="kernel", name="plane_sums", cases=sorted(sum_cases),
         exact=True, max_abs_err=err_s, leaves=len(leaves), ms=sk,
         plain_ms=sp, bound_bytes=s_bytes, bound_ms=sums["bound_ms"],
         bound_by="bytes", launches_on_main_path=planes_out[
             "digest_launch"]["plane_sums"], library="none")
    emit(phase="kernel", name="lane_p99", cases=sorted(p99_cases),
         exact=True, max_abs_err=err_p, ms=pk, plain_ms=pp,
         bound_bytes=p_bytes, bound_ms=p99["bound_ms"], bound_by="bytes",
         launches_on_main_path=planes_out["digest_launch"]["lane_p99"],
         library="none")
    return dict(obs_fold=fold, plane_sums=sums, lane_p99=p99)


def sums_bound(leaves, masks) -> int:
    """The bytes plane_sums must move: each leaf and each mask read once,
    a sum leaf's [2, M] int32 output and a max or or leaf's [M] written
    once."""
    B = masks[0].shape[0]
    nbytes = sum(m.numel() for m in masks if m is not None)
    for lf in leaves:
        x = lf[0]
        M = 1 if x is None else x.numel() // B
        nbytes += (8 if len(lf) == 2 or lf[2] == "sum" else 4) * M
        nbytes += 0 if x is None else x.numel() * 4
    return nbytes


SPAN_WORDS = 6    # ev_span's words a row (core/step.py)


def span_capture_bytes(B: int) -> int:
    """The bytes the step's plain `spans` section must move a step: each
    lane's popped ev_span row read (SPAN_WORDS int32), the scalars it
    reads (valid, is_super and inherit: 1 byte each; root_raw, dmin, the
    sojourn, the reset target, ev_node and now: 4 each), the carried
    vector it writes (SPAN_WORDS) and the five measured words the
    completion reads."""
    return B * (4 * SPAN_WORDS + 3 + 6 * 4 + 4 * SPAN_WORDS + 5 * 4)


def plain_reductions_phase(state):
    """The digests' reductions still plain PyTorch (ROADMAP K10) on the
    all-planes flagship's final state (B=100,000): `_masked_lane_pcts`
    (a sort of a [B] metric; library: one torch.sort and three
    torch.kthvalue calls), `_hist_quantiles` of the merged [N, LB] e2e
    histogram, `_consensus_modal` of the [B, S] sketch (library:
    torch.mode over the lanes), `_lane_burst_qhw` (one amax of [B, W]),
    each beside its byte bound (inputs read once, outputs written once);
    and the bound of the plain `spans` section (span_capture_bytes),
    whose eager time is planes_all_profile's `spans` section."""
    import torch
    from madsim_tpu_torch.parallel import stats
    B = state.now.shape[0]
    on = state.pf_on
    n = int(on.sum())
    x = state.steps
    masked = torch.where(on, x, stats.I32_MAX)
    ks = [min(max((max(n, 1) - 1) * q // 100, 0), B - 1) + 1
          for q in (50, 90, 100)]
    e2e = state.lh_e2e.to(torch.int64).sum(0).float()       # [N, LB]
    sk = state.cov_sketch
    qhw = state.sr_qhw

    def kth():
        for k in ks:
            torch.kthvalue(masked, k)

    # name: (input, plain version, library call or None, bound bytes,
    # extra numbers)
    rows = {
        "masked_lane_pcts": (
            x, lambda: stats._masked_lane_pcts(x, on, n),
            lambda: torch.sort(masked), B * (4 + 1) + 3 * 4,
            dict(kthvalue_ms=cuda_ms(kth, 5))),
        "hist_quantiles": (
            e2e, lambda: stats._hist_quantiles(e2e, stats._LAT_QS), None,
            e2e.numel() * 4 + e2e.shape[0] * len(stats._LAT_QS) * 4, {}),
        "consensus_modal": (
            sk, lambda: stats._consensus_modal(sk),
            lambda: torch.mode(sk, 0), sk.numel() * 4 + sk.shape[1] * 8, {}),
        "lane_burst_qhw": (
            qhw, lambda: stats._lane_burst_qhw(qhw), None,
            qhw.numel() * qhw.element_size() + B * 4, {}),
    }
    out = {}
    for name, (inp, plain, lib, nbytes, more) in rows.items():
        out[name] = dict(
            plain_ms=min(cuda_ms(plain, 5), cuda_ms(plain, 5)),
            library_ms=cuda_ms(lib, 5) if lib else None,
            bound_bytes=nbytes, bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
            shape=list(inp.shape), **more)
    sb = span_capture_bytes(B)
    emit(phase="plain_reductions", batch=B, profiled_lanes=n, **out,
         spans_section=dict(bound_bytes=sb,
                            bound_ms=sb / HBM_BYTES_PER_S * 1e3))


def planes_all_kernel_phase(wrappers, dev, pa):
    """K8 obs_fold with its sketch, series and span groups, K5 emit_write
    with the span columns, K10 plane_sums with its max and or leaves and
    the new lane_burst, against their plain versions, exactly: at the
    all-planes flagship's step-1024 operands and its final state
    (B=100,000), and on edge cases (fold: FOLD_PLANE_CASES, saturation,
    window boundaries and the clamp, every lane masked, sketch_every=1,
    empty spans; emit_write: the edge cases with span columns; digests:
    SERIES_DIGEST_CASES). Returns each kernel's numbers for the kernels
    line."""
    import torch
    from madsim_tpu_torch.ops.emit_write import (emit_write,
                                                 emit_write_plain)
    from madsim_tpu_torch.ops.obs_fold import obs_fold, obs_fold_plain
    from madsim_tpu_torch.ops.plane_digest import (lane_burst,
                                                   lane_burst_plain,
                                                   lane_p99, plane_sums,
                                                   plane_sums_plain)
    state = pa["state"]
    # ---- K8 obs_fold, every group
    fold_cases = {"all_planes_step_1024": pa["fold_ops"]}
    for i, case in enumerate(FOLD_PLANE_CASES):
        fold_cases[case] = fold_edge_operands(
            dev, FLAG_B if case == "planes_int32_max" else EDGE_B, 5, 24,
            300 + i, case)
    err_f = 0
    for name, (plan, planes, ops, has_cpl) in fold_cases.items():
        a, b = clone_layout(planes), clone_layout(planes)
        obs_fold(plan, a, ops, has_cpl)
        obs_fold_plain(plan, b, ops, has_cpl)
        torch.cuda.synchronize()
        err_f = max(err_f, check_equal(f"obs_fold (all planes) on {name}",
                                       a, b))
    main_f = fold_cases["all_planes_step_1024"]
    fk = [fold_ms(main_f) for _ in range(2)]
    live = clone_tree(main_f[1])
    fp_ms = cuda_ms(lambda: obs_fold_plain(main_f[0], live, main_f[2],
                                           main_f[3]), 5)
    f_bytes = fold_bound(*main_f[1:], main_f[0])
    fold = dict(ms=min(fk), plain_ms=fp_ms,
                bound_ms=f_bytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
                max_abs_err=err_f, library_ms=None)
    emit(phase="kernel", name="obs_fold", planes="all", cases={
        k: int(v[2]["valid"].shape[0]) for k, v in fold_cases.items()},
         exact=True, max_abs_err=err_f,
         launches_on_main_path=pa["launches"]["obs_fold"], ms=fk,
         plain_ms=fp_ms, bound_bytes=f_bytes, bound_ms=fold["bound_ms"],
         bound_by="bytes", ms_in_all_planes_graph=pa["prof"][
             "kernel_ms_per_step"]["obs_fold"]
         if pa["prof"]["kernel_ms_per_step"] else None, library="none")
    del fold_cases, live
    # ---- K5 emit_write with the span columns
    emit_cases = {"all_planes_step_1024": pa["emit_ops"]}
    for C_e, E_e, ns_e, jit_e in ((96, 12, 7, True), (96, 0, 0, False),
                                  (256, 5, 0, True), (320, 6, 2, True),
                                  (384, 12, 7, False)):
        base = emit_edge_operands(dev, 4096, C_e, 5, 8, E_e, ns_e, jit_e,
                                  True, True, seed=C_e + E_e + 1)
        emit_cases[f"edges_C{C_e}_E{E_e}_spans"] = emit_plane_operands(
            base, C_e + E_e + 1, span=True)
    err_e = 0
    for name, args in emit_cases.items():
        a, b = clone_tree(args), clone_tree(args)
        out_k = emit_write(*a)
        out_p = emit_write_plain(*b)
        torch.cuda.synchronize()
        err_e = max(err_e, check_equal(f"emit_write (spans) on {name}",
                                       (a[0], a[3], out_k),
                                       (b[0], b[3], out_p)))
    main_e = emit_cases["all_planes_step_1024"]
    check(main_e[0]["ev_span"].shape[1] > 0,
          "emit_write: the all-planes operands carry no ev_span")
    live = clone_tree(main_e)
    restores = [(live[0][k], main_e[0][k]) for k in main_e[0]] + [
        (live[3]["cols"][k], main_e[3]["cols"][k]) for k in main_e[3]["cols"]]

    def restore():
        for dst, src in restores:
            dst.copy_(src)
    ek = [graph_ms(lambda: (restore(), emit_write(*live)), 20)
          - graph_ms(restore, 20) for _ in range(2)]
    e_bytes, e_ops = emit_bound(*main_e)
    emit(phase="kernel", name="emit_write", planes="all",
         cases=sorted(emit_cases), exact=True, max_abs_err=err_e, ms=ek,
         bound_bytes=e_bytes, bound_ms=max(e_bytes / HBM_BYTES_PER_S,
                                           e_ops / INT32_OPS_PER_S) * 1e3,
         launches_on_main_path=pa["launches"]["emit_write"],
         ms_in_all_planes_graph=pa["prof"].get("emit_write_ms_per_step"))
    del emit_cases, live, restores
    # ---- K10 plane_sums (sum, max, or) and lane_burst
    from madsim_tpu_torch.parallel.stats import (attribution_leaves,
                                                 series_leaves)
    series, s_masks = series_leaves(state)
    attribution, a_masks = attribution_leaves(state)
    sum_cases = {"series_step_2048": (series, s_masks),
                 "attribution_step_2048": (attribution, a_masks)}
    burst_cases = {"all_planes_step_2048": state.sr_lat,
                   "unaligned_step_2048": unaligned(state.sr_lat)}
    for i, case in enumerate(SERIES_DIGEST_CASES):
        B = FLAG_B if case in ("int32_max", "random") else EDGE_B
        lv, ms_, lat = series_digest_operands(dev, B, 16, 5, 24, 400 + i,
                                              case)
        sum_cases[case] = (lv, ms_)
        burst_cases[case] = lat
    err_s = err_b = 0
    for name, (lv, ms_) in sum_cases.items():
        err_s = max(err_s, check_equal(f"plane_sums (ops) on {name}",
                                       plane_sums(lv, ms_),
                                       plane_sums_plain(lv, ms_)))
    q = lane_p99.q(dev)
    for name, lat in burst_cases.items():
        err_b = max(err_b, check_equal(f"lane_burst on {name}",
                                       lane_burst(lat),
                                       lane_burst_plain(lat, q)))
        err_b = max(err_b, check_equal(f"lane_burst on {name} (the CPU)",
                                       lane_burst(lat),
                                       lane_burst(lat.cpu()).to(dev)))
    sk = [graph_ms(lambda: plane_sums(series, s_masks), 20)
          for _ in range(2)]
    ak = [graph_ms(lambda: plane_sums(attribution, a_masks), 20)
          for _ in range(2)]
    sp = cuda_ms(lambda: plane_sums_plain(series, s_masks), 5)
    s_bytes = sums_bound(series, s_masks)
    a_bytes = sums_bound(attribution, a_masks)
    lat = state.sr_lat
    bk = [graph_ms(lambda: lane_burst(lat), 20) for _ in range(2)]
    bp = cuda_ms(lambda: lane_burst_plain(lat, q), 5)
    b_bytes = lat.numel() * 4 + lat.shape[0] * 4
    sums = dict(ms=min(sk), plain_ms=sp,
                bound_ms=s_bytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
                max_abs_err=err_s, library_ms=None)
    burst = dict(ms=min(bk), plain_ms=bp,
                 bound_ms=b_bytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
                 max_abs_err=err_b, library_ms=None)
    emit(phase="kernel", name="plane_sums", planes="series and attribution",
         cases=sorted(sum_cases), exact=True, max_abs_err=err_s,
         series_leaves=len(series), ms=sk, plain_ms=sp, bound_bytes=s_bytes,
         bound_ms=sums["bound_ms"], attribution_ms=ak,
         attribution_bound_ms=a_bytes / HBM_BYTES_PER_S * 1e3,
         bound_by="bytes", launches_on_main_path=pa["digest_launch"][
             "plane_sums"], library="none")
    emit(phase="kernel", name="lane_burst", cases=sorted(burst_cases),
         exact=True, max_abs_err=err_b, ms=bk, plain_ms=bp,
         bound_bytes=b_bytes, bound_ms=burst["bound_ms"], bound_by="bytes",
         launches_on_main_path=pa["digest_launch"]["lane_burst"],
         library="none")
    plain_reductions_phase(state)
    return dict(obs_fold=fold, plane_sums=sums, lane_burst=burst)


# ---- time travel and the first net-layer models ----------------------------
TT_EVERY = 1024              # timetravel_flagship: a harvest every 1024
FORK_LANE = 4099             # the lane the prefix fork clones
TT_SMALL_B, TT_SMALL_EVERY = 4096, 256   # run against run_fused harvests
TT_SMALL_STEPS = 512         # steps of that comparison (eager: host-bound)
TT_SEEDS = 24                # timetravel_explain: the JAX test's 24 seeds
TT_STEPS, TT_CHUNK, TT_CKPT = 30_000, 16, 32
TT_KNOB_SHIFT = 20_000       # ticks the knob pair's lane B moves its rows
TT_NUDGE = 12345
ECHO_B, ECHO_STEPS, ECHO_CHUNK = 50_000, 20_000, 512
ECHO_LANES = (0, 1, 25_000, 49_999)
MODEL_B, MODEL_CHUNK = 16_384, 512
MODEL_LANES = (0, 1, 8_191, 16_383)
MODEL_EAGER_STEPS = 256      # run = run_fused over this prefix
BUG_CPU_LANES = 512          # lanes of the 2PC bug variant the CPU runs


def tpc_runtime(device, bug=False):
    """The JAX package's tests/test_two_phase_commit.py:40 (10% loss, two
    coordinator kill/restarts, 30 s) or, with `bug`, :55
    (early_decide_quorum=2, p_yes 0.6, 15% loss, 30 s)."""
    from madsim_tpu_torch import NetConfig, Scenario, SimConfig, ms, sec
    from madsim_tpu_torch.models.two_phase_commit import make_tpc_runtime
    cfg = SimConfig(n_nodes=5, event_capacity=128, time_limit=sec(30),
                    net=NetConfig(packet_loss_rate=0.15 if bug else 0.1,
                                  send_latency_min=ms(1),
                                  send_latency_max=ms(10)))
    if bug:
        return make_tpc_runtime(5, 6, early_decide_quorum=2, p_yes=0.6,
                                cfg=cfg, device=device)
    sc = Scenario()
    sc.at(ms(100)).kill(0)
    sc.at(ms(600)).restart(0)
    sc.at(ms(900)).kill(0)
    sc.at(ms(1400)).restart(0)
    return make_tpc_runtime(5, 6, scenario=sc, cfg=cfg, device=device)


def gossip_runtime(device):
    """The JAX package's tests/test_gossip.py:27: 8 nodes, 20% loss, the
    origin cut off at t=0 and healed at 2 s."""
    from madsim_tpu_torch import NetConfig, Scenario, SimConfig, ms, sec
    from madsim_tpu_torch.models.gossip import make_gossip_runtime
    cfg = SimConfig(n_nodes=8, event_capacity=192, time_limit=sec(20),
                    net=NetConfig(packet_loss_rate=0.2))
    sc = Scenario()
    sc.at(ms(0)).partition([0])
    sc.at(sec(2)).heal()
    return make_gossip_runtime(n_nodes=8, n_rumors=4, scenario=sc, cfg=cfg,
                               device=device)


# name: (runtime maker, max_steps), the tpc_gossip phase's three runtimes
MODEL_CASES = {
    "tpc_coordinator_crash": (lambda d: tpc_runtime(d), 60_000),
    "tpc_early_decide_bug": (lambda d: tpc_runtime(d, bug=True), 60_000),
    "gossip_partition_heal": (gossip_runtime, 40_000),
}


def knob_pair(rt):
    """The divergence microscope's knob vector: every scenario row of the
    base plan TT_KNOB_SHIFT ticks later."""
    from madsim_tpu_torch.search.mutate import KnobPlan
    kb = KnobPlan.from_runtime(rt).base_knobs()
    return dict(kb, row_time=kb["row_time"] + TT_KNOB_SHIFT)


def tt_explain_on(device, tmp) -> dict:
    """The timetravel_explain phase's work on one device: the crash-rich
    wal_kv with a 4-slot ring (the JAX package's tests/test_timetravel.py
    specimen) over TT_SEEDS seeds through run(ckpt_every=TT_CKPT), then
    explain_crash(replay=True) of its first wrap-truncated crash with the
    window trace, divergence_report on a knob pair and a nudge pair with
    their pair traces, and that lane's checkpoint saved and loaded. Times
    under `seconds`; every other entry is compared across devices."""
    import numpy as np
    import torch
    from madsim_tpu_torch import (CheckpointLog, LaneCheckpoint, interop,
                                  workloads)
    from madsim_tpu_torch.obs import divergence_report, explain_crash
    sync = torch.cuda.synchronize if device != "cpu" else (lambda: None)
    secs = {}
    rt = workloads.crashrich_wal_kv_runtime(device=device, trace_cap=4)
    log = CheckpointLog()
    t0 = time.perf_counter()
    s, _ = rt.run(rt.init_batch(np.arange(TT_SEEDS, dtype=np.uint32)),
                  TT_STEPS, TT_CHUNK, ckpt_every=TT_CKPT, ckpt_log=log)
    sync()
    secs["run"] = time.perf_counter() - t0
    steps = s.steps.cpu().numpy()
    lane = live = None
    for b in np.nonzero(s.crashed.cpu().numpy())[0]:
        exp = explain_crash(s, int(b))
        if exp["truncated"] and steps[b] > 40:
            lane, live = int(b), exp
            break
    out = dict(lane=lane, live=live, snapshots=len(log),
               fingerprints=rt.fingerprints(s),
               lane_steps=log.lane_steps(lane) if lane is not None else None)
    if lane is None:
        return dict(out, seconds=secs)
    path = os.path.join(tmp, f"window_{device}.json")
    t0 = time.perf_counter()
    full = explain_crash(s, lane, replay=True, rt=rt, ckpts=log,
                         chunk=TT_CHUNK, export_trace=path)
    sync()
    secs["explain_replay"] = time.perf_counter() - t0
    full.pop("trace_path")
    with open(path, "rb") as f:
        out["window_trace"] = f.read()
    out["full"] = full
    again = explain_crash(s, lane, replay=True, rt=rt, ckpts=log,
                          chunk=TT_CHUNK)
    out["again_equal"] = again["chain"] == full["chain"]
    for shape, args in (("knobs", dict(knobs_b=knob_pair(rt))),
                        ("nudge", dict(nudge_b=TT_NUDGE))):
        p = os.path.join(tmp, f"pair_{shape}_{device}.json")
        t0 = time.perf_counter()
        r = divergence_report(rt, 3, max_steps=2048, chunk=64,
                              export_trace=p, **args)
        sync()
        secs[f"divergence_{shape}"] = time.perf_counter() - t0
        r.pop("trace_path")
        with open(p, "rb") as f:
            out[f"divergence_{shape}"] = (r, f.read())
    ck = log.nearest(lane)
    p = os.path.join(tmp, f"lane_{device}.npz")
    ck.save(p)
    back = LaneCheckpoint.load(p, rt)
    out["ckpt"] = (ck.steps, back.steps, back.signature,
                   interop.state_to_numpy(back.state),
                   interop.state_to_numpy(ck.state))
    return dict(out, seconds=secs)


def models_cpu_lanes() -> dict:
    """The CPU halves of the echo and tpc_gossip phases: config 3's
    ECHO_LANES seeds, each model case's MODEL_LANES seeds, and the 2PC
    bug variant's first BUG_CPU_LANES seeds (its crash verdicts)."""
    import numpy as np
    from madsim_tpu_torch import interop, workloads
    out = {}
    rt = workloads.echo_config3_runtime(device="cpu")
    s, _ = rt.run(rt.init_batch(np.asarray(ECHO_LANES, np.uint32)),
                  ECHO_STEPS, ECHO_CHUNK)
    out["echo"] = interop.state_to_numpy(s)
    for name, (build, max_steps) in MODEL_CASES.items():
        rt = build("cpu")
        s, _ = rt.run(rt.init_batch(np.asarray(MODEL_LANES, np.uint32)),
                      max_steps, MODEL_CHUNK)
        out[name] = interop.state_to_numpy(s)
    rt = MODEL_CASES["tpc_early_decide_bug"][0]("cpu")
    s, _ = rt.run(rt.init_batch(np.arange(BUG_CPU_LANES, dtype=np.uint32)),
                  MODEL_CASES["tpc_early_decide_bug"][1], MODEL_CHUNK)
    out["bug_verdicts"] = (s.crashed.numpy(), s.crash_code.numpy())
    return out


def tt_cpu_main(out_path) -> int:
    """`chip_smoke.py --tt-cpu OUT`: the CPU halves of the
    timetravel_explain, echo and tpc_gossip phases, run beside the card's
    phases (it touches no card); pickled to OUT for the main process."""
    import pickle
    import tempfile
    import torch
    torch.set_num_threads(1)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_tt_") as tmp:
        out = dict(explain=tt_explain_on("cpu", tmp))
    out.update(models=models_cpu_lanes())
    with open(out_path, "wb") as f:
        pickle.dump(out, f)
    return 0


def wait_child(job, path, what):
    """The pickled result of a CPU child (`job` writing `path`)."""
    import pickle
    log, _ = job.communicate(timeout=900)
    check(job.returncode == 0,
          f"{what}: the CPU child failed ({job.returncode}):\n"
          f"{log[-4000:]}")
    with open(path, "rb") as f:
        return pickle.load(f)


def numpy_lanes(state, lanes) -> dict:
    from madsim_tpu_torch import interop
    return interop.state_to_numpy(state_lanes(state, lanes))


def numpy_equal(a: dict, b: dict) -> list:
    """The leaves of two {path: array} dicts that differ (dtype, shape or
    value)."""
    import numpy as np
    return [k for k in a if k not in b or a[k].dtype != b[k].dtype
            or a[k].shape != b[k].shape or not np.array_equal(a[k], b[k])]


def one_lane_bytes(state) -> int:
    B = state.now.shape[0]
    return sum(t.numel() // B * t.element_size() for t in lane_leaves(state))


def timetravel_flagship_phase(wrappers, dev, names, every, flag_fp, counts):
    """The flagship at B=100,000 through run_fused(FLAG_STEPS,
    ckpt_every=TT_EVERY): the plane-off fingerprints, two snapshots (steps
    0 and 1024) with each harvest's host seconds and bytes; FORK_LANE's
    checkpoint at 1024 through seed_batch_from(ck, B) (one lane_take, held
    to its plain version on the same operands) and run_fused for the
    last 1024 steps: every lane on FORK_LANE's parent fingerprint, and
    its lane checkpoint at 2048 (checkpoint_lane on the card) equal to
    the parent's; and at B=4096 run(ckpt_every=512) and
    run_fused(ckpt_every=512) harvesting equal snapshots. Returns the
    K14 rows for the kernels line."""
    import numpy as np
    import torch
    from madsim_tpu_torch import (checkpoint_lane, seed_batch_from,
                                  workloads)
    from madsim_tpu_torch.core.state import map_state, packed_copy
    from madsim_tpu_torch.obs.timetravel import CheckpointLog
    from madsim_tpu_torch.ops.lane_rows import lane_take_plain
    reset_counts, read_counts = counts
    take = wrappers["lane_take"]

    class TimedLog(CheckpointLog):
        """A CheckpointLog that times each harvest (the device work
        before it finished first) and counts its bytes."""

        def __init__(self, **kw):
            super().__init__(**kw)
            self.seconds, self.nbytes = [], []

        def harvest(self, state, steps_done=None):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            super().harvest(state, steps_done)
            self.seconds.append(time.perf_counter() - t0)
            self.nbytes.append(sum(t.numel() * t.element_size()
                                   for t in lane_leaves(state)))

    rt = workloads.flagship_runtime(device=dev)
    s0 = rt.init_batch(np.arange(FLAG_B, dtype=np.uint32))
    per = step_launches(wrappers, rt, s0)
    log = TimedLog()
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    out = rt.run_fused(s0, FLAG_STEPS, chunk=FLAG_CHUNK, ckpt_every=TT_EVERY,
                       ckpt_log=log)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = fused_launches(rt, read_counts(), every)
    steps = rt.steps_run + rt.fused_stats["warmup_steps"]
    check(rt.steps_run == FLAG_STEPS,
          f"timetravel_flagship: {rt.steps_run} steps")
    check_once_per_step("timetravel_flagship", launches, steps, names, per)
    fp = rt.fingerprints(out)
    same_fp = bool((fp == flag_fp).all())
    done = [sn["steps_done"] for sn in log.snaps]
    check(same_fp, "timetravel_flagship: the harvested run's fingerprints "
          "differ from the plane-off flagship's")
    check(done == [0, TT_EVERY], f"timetravel_flagship: snapshots at {done}")
    ck = log.nearest(FORK_LANE)
    check(ck is not None and ck.steps == TT_EVERY,
          f"timetravel_flagship: lane {FORK_LANE}'s checkpoint is at step "
          f"{None if ck is None else ck.steps}")
    # the fork: one lane_take of B repeats of the checkpointed lane
    del s0
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    child = seed_batch_from(ck, FLAG_B, rt=rt)
    torch.cuda.synchronize()
    fork_s = time.perf_counter() - t0
    fork_launch = read_counts()["lane_take"]
    check(fork_launch == 1, f"timetravel_flagship: seed_batch_from launched "
          f"lane_take {fork_launch} times")
    one = map_state(lambda t: t.unsqueeze(0), packed_copy(ck.state, dev))
    ix0 = np.zeros(FLAG_B, np.int64)
    ix0_t = torch.as_tensor(ix0, device=dev)
    plain = lane_take_plain(one, ix0_t)
    err = check_equal("lane_take fork", lane_leaves(child),
                      lane_leaves(plain))
    owns = all(t.stride(0) != 0 for t in lane_leaves(child) if t.numel())
    del plain
    check(owns, "timetravel_flagship: a forked leaf has a stride-0 lane "
          "axis")
    fork_bytes = FLAG_B * (one_lane_bytes(child) + 8) + one_lane_bytes(child)
    fork_ms = [lane_rows_ms(take, one, ix0, False) for _ in range(2)]
    fork_plain = [cuda_ms(lambda: lane_take_plain(one, ix0_t), 3)
                  for _ in range(2)]
    reset_counts()
    t0 = time.perf_counter()
    child = rt.run_fused(child, FLAG_STEPS - TT_EVERY, chunk=FLAG_CHUNK)
    torch.cuda.synchronize()
    child_wall = time.perf_counter() - t0
    child_launch = fused_launches(rt, read_counts(), every)
    check_once_per_step("timetravel_flagship fork", child_launch,
                        rt.steps_run + rt.fused_stats["warmup_steps"], names,
                        per)
    child_fp = rt.fingerprints(child)
    on_parent = int((child_fp == flag_fp[FORK_LANE]).sum())
    check(on_parent == FLAG_B, f"timetravel_flagship: {on_parent} of "
          f"{FLAG_B} forked lanes end on lane {FORK_LANE}'s fingerprint")
    # a lane checkpoint on the card: the fork's lane 0 against the parent's
    reset_counts()
    ck_child = checkpoint_lane(child, 0)
    ck_parent = checkpoint_lane(out, FORK_LANE)
    lane_launch = read_counts()["lane_take"]
    check(lane_launch == 2, f"timetravel_flagship: checkpoint_lane launched "
          f"lane_take {lane_launch} times for two checkpoints")
    check(state_equal(ck_child.state, ck_parent.state),
          "timetravel_flagship: the fork's lane 0 at step 2048 differs "
          "from its parent lane")
    ix1 = torch.as_tensor([FORK_LANE], device=dev)
    err1 = check_equal("lane_take one lane",
                       lane_leaves(map_state(lambda t: t.unsqueeze(0),
                                             ck_parent.state)),
                       [t.cpu() for t in lane_leaves(
                           lane_take_plain(out, ix1))])
    lane_bytes = lane_rows_bytes(out, 1)
    lane_ms = [lane_rows_ms(take, out, [FORK_LANE], False)
               for _ in range(2)]
    lane_plain = [cuda_ms(lambda: lane_take_plain(out, ix1), 3)
                  for _ in range(2)]
    emit(phase="timetravel_flagship", batch=FLAG_B, steps=FLAG_STEPS,
         ckpt_every=TT_EVERY, run_fused_wall_s=wall,
         fingerprints_equal_plane_off=same_fp, snapshots_at=done,
         harvest_s=log.seconds, harvest_bytes=log.nbytes,
         harvest_gb_per_s=[b / s / 1e9 for b, s in
                           zip(log.nbytes, log.seconds)],
         fork_lane=FORK_LANE, fork_seed_batch_from_s=fork_s,
         fork_lane_take_launches=fork_launch, fork_run_fused_wall_s=
         child_wall, fork_lanes_on_parent=on_parent,
         fork_leaves_own_memory=owns, lane_take_fork_ms=fork_ms,
         lane_take_fork_plain_ms=fork_plain, lane_take_fork_bytes=fork_bytes,
         lane_take_fork_bound_ms=fork_bytes / HBM_BYTES_PER_S * 1e3,
         checkpoint_lane_launches=lane_launch, lane_take_one_ms=lane_ms,
         lane_take_one_plain_ms=lane_plain, lane_take_one_bytes=lane_bytes,
         launches=launches)
    rows = {
        "fork": dict(ms=min(fork_ms), plain_ms=min(fork_plain),
                     bound_ms=fork_bytes / HBM_BYTES_PER_S * 1e3,
                     bound_by="bytes", max_abs_err=err, library_ms=None,
                     launches=fork_launch),
        "lane": dict(ms=min(lane_ms), plain_ms=min(lane_plain),
                     bound_ms=lane_bytes / HBM_BYTES_PER_S * 1e3,
                     bound_by="bytes", max_abs_err=err1, library_ms=None,
                     launches=lane_launch)}
    del out, child, one, ck, log

    # run and run_fused harvest the same snapshots
    s0 = rt.init_batch(np.arange(TT_SMALL_B, dtype=np.uint32))
    logs = {}
    for runner in ("run", "run_fused"):
        logs[runner] = CheckpointLog()
        t0 = time.perf_counter()
        if runner == "run":
            end, _ = rt.run(s0, TT_SMALL_STEPS, chunk=TT_SMALL_EVERY,
                            ckpt_every=TT_SMALL_EVERY,
                            ckpt_log=logs[runner])
        else:
            end = rt.run_fused(s0, TT_SMALL_STEPS, chunk=TT_SMALL_EVERY,
                               ckpt_every=TT_SMALL_EVERY,
                               ckpt_log=logs[runner])
        torch.cuda.synchronize()
        logs[runner + "_s"] = time.perf_counter() - t0
        logs[runner + "_end"] = end
    a, b = logs["run"], logs["run_fused"]
    done_a = [sn["steps_done"] for sn in a.snaps]
    done_b = [sn["steps_done"] for sn in b.snaps]
    equal = [state_equal(x["state"], y["state"])
             for x, y in zip(a.snaps, b.snaps)]
    ends = state_equal(logs["run_end"], logs["run_fused_end"])
    emit(phase="timetravel_flagship", batch=TT_SMALL_B,
         steps=TT_SMALL_STEPS,
         ckpt_every=TT_SMALL_EVERY, run_snapshots_at=done_a,
         run_fused_snapshots_at=done_b, snapshots_equal=equal,
         final_states_equal=ends, run_s=logs["run_s"],
         run_fused_s=logs["run_fused_s"])
    check(done_a == done_b
          == list(range(0, TT_SMALL_STEPS, TT_SMALL_EVERY)),
          f"timetravel_flagship: snapshots at {done_a} and {done_b}")
    check(all(equal) and ends, "timetravel_flagship: run and run_fused "
          "harvested different snapshots")
    return rows


def timetravel_explain_phase(dev, tmp, cpu):
    """explain_crash(replay=True), divergence_report on a knob pair and a
    nudge pair and a LaneCheckpoint save/load on the crash-rich wal_kv
    (tt_explain_on) on the card, each equal to the CPU child's, record
    for record, and the traces byte for byte."""
    got = tt_explain_on(dev, tmp)
    want = cpu["explain"]
    secs = got.pop("seconds")
    want.pop("seconds")
    check(got["lane"] is not None, "timetravel_explain: no wrap-truncated "
          "crash among the seeds")
    full = got["full"]
    ck_steps, back_steps, sig, back, orig = got["ckpt"]
    ckpt_ok = (ck_steps == back_steps and not numpy_equal(orig, back)
               and not numpy_equal(want["ckpt"][3], back))
    diff = [k for k in want if k != "ckpt" and not same_tree(got[k],
                                                               want[k])]
    emit(phase="timetravel_explain", seeds=TT_SEEDS, lane=got["lane"],
         snapshots=got["snapshots"], replayed=full["replayed"],
         truncated=full["truncated"], chain=len(full["chain"]),
         live_chain=len(got["live"]["chain"]), from_step=full["from_step"],
         replay_again_equal=got["again_equal"],
         divergence_first={k: got[f"divergence_{k}"][0]["first"]
                           for k in ("knobs", "nudge")},
         window_trace_bytes=len(got["window_trace"]),
         ckpt_steps=ck_steps, ckpt_roundtrip_equal=ckpt_ok,
         differs_from_cpu=diff, seconds=secs)
    check(full["replayed"] and not full["truncated"],
          "timetravel_explain: the replayed chain is truncated")
    check(got["again_equal"], "timetravel_explain: a second replay gave "
          "another chain")
    check(all(got[f"divergence_{k}"][0]["first"] is not None
              for k in ("knobs", "nudge")),
          "timetravel_explain: a pair named no first divergent dispatch")
    check(ckpt_ok, "timetravel_explain: the lane checkpoint did not come "
          "back equal from its file")
    check(not diff, f"timetravel_explain: the card differs from the CPU in "
          f"{diff}")


def handlers_bytes(rt, state) -> int:
    """The bytes a step's handlers section must move (ROADMAP K16): each
    lane's acting node's state row read once and its new row written
    once, its event's payload row and its tag, source, node and time
    read once, and the effects it stages for the emission write (the
    next step of `state`'s `em` operand) written once."""
    B, N = state.alive.shape
    row = sum(t.numel() // (B * N) * t.element_size()
              for t in state.node_state.values())
    em = emit_operands(rt, state)[1]
    staged = sum(t.numel() * t.element_size() for t in em.values())
    return B * (2 * row + 4 * rt.cfg.payload_words + 16) + staged


def model_phase(wrappers, dev, names, every, counts, name, build, max_steps,
                batch, chunk, lanes, cpu_lanes, profile_eager=True,
                eager_steps=None, prof_steps=PROF_STEPS):
    """One model runtime at `batch` lanes through run_fused and run: every
    leaf equal, each step kernel launched its count a step, `lanes` equal
    to the CPU's (at the halt, or at `max_steps` where the run is capped
    short of it); the graph step's device ms and the eager step's
    handlers and invariant sections (profile_steps). With `eager_steps`
    the eager run and a second run_fused stop after that many steps and
    are compared there (the whole run is run_fused's alone). Returns
    (final state, numbers)."""
    import numpy as np
    import torch
    reset_counts, read_counts = counts
    rt = build(dev)
    s0 = rt.init_batch(np.arange(batch, dtype=np.uint32))
    per = step_launches(wrappers, rt, s0)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    f = rt.run_fused(s0, max_steps, chunk=chunk)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = fused_launches(rt, read_counts(), every)
    steps_fused = rt.steps_run
    on = check_once_per_step(f"{name} run_fused", launches,
                             steps_fused + rt.fused_stats["warmup_steps"],
                             names, per)
    ref = f
    if eager_steps is not None:
        ref = rt.run_fused(s0, eager_steps, chunk=min(chunk, eager_steps))
    reset_counts()
    t0 = time.perf_counter()
    e, _ = rt.run(s0, eager_steps or max_steps,
                  chunk=min(chunk, eager_steps or chunk))
    torch.cuda.synchronize()
    eager_wall = time.perf_counter() - t0
    steps_eager = rt.steps_run
    on |= check_once_per_step(f"{name} run", read_counts(), steps_eager,
                              names, per)
    same = state_equal(ref, e)
    del ref
    check(same, f"{name}: run_fused and run differ")
    diff = numpy_equal(cpu_lanes, numpy_lanes(f, lanes))
    check(not diff, f"{name}: lanes {lanes} differ from the CPU's in "
          f"{diff[:4]}")
    expect = dict(per_step_of(names), **per)
    prof = profile_steps(lambda st, n: rt.run_fused(st, n, chunk=n), s0,
                         batch, expect, steps=prof_steps)
    nums = dict(batch=batch, steps_run=steps_fused, wall_s=wall,
                eager_steps_run=steps_eager, eager_wall_s=eager_wall,
                eager_compared_at=eager_steps or "halt",
                cpu_compared_at=("halt" if bool(f.halted.all())
                                 else steps_fused),
                steps_to_halt=int(f.steps.max()),
                seed_events_per_s=batch * steps_fused / wall,
                dispatched_events_per_s=int(f.steps.sum()) / wall,
                k1k4_per_step=per, launches=launches,
                run_fused_equal_run=same, cpu_lanes=list(lanes),
                graph_device_ms_per_step=prof.get("device_busy_ms_per_step"),
                graph_device_busy_share=prof.get("device_busy_share"),
                graph_kernels_per_step=prof.get("device_kernels_per_step"),
                graph_kernel_ms_per_step=prof.get("kernel_ms_per_step"))
    hb = handlers_bytes(rt, s0)
    nums.update(handlers_bound_bytes=hb,
                handlers_bound_ms=hb / HBM_BYTES_PER_S * 1e3)
    if profile_eager:
        pe = profile_steps(lambda st, n: rt.run(st, n, chunk=n)[0], s0,
                           batch, expect)
        sec = pe.get("section_ms_per_step") or {}
        nums.update(eager_device_ms_per_step=pe.get(
            "device_busy_ms_per_step"),
            handlers_ms_per_step=sec.get("handlers"),
            invariant_ms_per_step=sec.get("invariant"),
            eager_section_ms_per_step=sec)
    return f, nums, on


def echo_phase(wrappers, dev, names, every, counts, cpu):
    """BASELINE.md config 3 (workloads.echo_config3_runtime) at ECHO_B
    seeds, ECHO_STEPS steps at most: run_fused = run, ECHO_LANES equal to
    the CPU's, no lane crashed, every client acked 10, every lane at its
    6 s limit; the graph runner's seed-events/s, its steps to halt and
    its device ms a step."""
    import numpy as np
    from madsim_tpu_torch import sec, workloads
    f, nums, on = model_phase(
        wrappers, dev, names, every, counts, "echo",
        workloads.echo_config3_runtime, ECHO_STEPS, ECHO_B, ECHO_CHUNK,
        ECHO_LANES, cpu["models"]["echo"])
    crashed = int(f.crashed.sum())
    acked = f.node_state["acked"][:, 1:].cpu().numpy()
    at_limit = bool((f.now == sec(6)).all())
    emit(phase="echo", config="BASELINE.md config 3", crashed=crashed,
         clients_acked_10=int((acked == 10).all(1).sum()),
         all_at_time_limit=at_limit, **nums)
    check(crashed == 0, f"echo: {crashed} lanes crashed")
    check(bool((acked == 10).all()), "echo: a client did not ack 10 calls")
    check(at_limit and bool(f.halted.all()),
          "echo: a lane did not halt at its 6 s limit")
    return on


def tpc_gossip_phase(wrappers, dev, names, every, counts, cpu):
    """MODEL_CASES at MODEL_B lanes through run_fused and run, leaf for
    leaf, MODEL_LANES equal to the CPU's; the 2PC cases atomic, the bug
    variant crashing with the reference's codes on the same lanes as the
    CPU (its first BUG_CPU_LANES lanes), gossip fully disseminated."""
    import numpy as np
    from madsim_tpu_torch.models import two_phase_commit as tpc
    on = set()
    for name, (build, max_steps) in MODEL_CASES.items():
        f, nums, on_case = model_phase(
            wrappers, dev, names, every, counts, name, build, max_steps,
            MODEL_B, MODEL_CHUNK, MODEL_LANES, cpu["models"][name],
            eager_steps=MODEL_EAGER_STEPS)
        on |= on_case
        crashed = f.crashed.cpu().numpy()
        codes = f.crash_code.cpu().numpy()
        extra = {}
        if name == "tpc_early_decide_bug":
            want_c, want_code = cpu["models"]["bug_verdicts"]
            n = len(want_c)
            same = (np.array_equal(crashed[:n], want_c)
                    and np.array_equal(codes[:n], want_code))
            extra = dict(crashed=int(crashed.sum()),
                         crash_codes=sorted(set(codes[crashed].tolist())),
                         cpu_lanes_compared=n, same_verdicts_as_cpu=same)
            check(crashed.any() and set(codes[crashed].tolist()) <= {
                tpc.CRASH_DIVERGED, tpc.CRASH_NO_VOTE_COMMIT},
                f"{name}: crashes {extra}")
            check(same, f"{name}: crash verdicts differ from the CPU's on "
                  f"lanes 0..{n - 1}")
        elif name.startswith("tpc"):
            dec = f.node_state["decided"][:, 1:].cpu().numpy()
            both = ((dec == tpc.COMMIT).any(1)
                    & (dec == tpc.ABORT).any(1)).any()
            extra = dict(crashed=int(crashed.sum()), atomic=not both)
            check(not crashed.any() and not both,
                  f"{name}: {extra}")
        else:
            have = f.node_state["have"].cpu().numpy()
            extra = dict(crashed=int(crashed.sum()),
                         all_infected=bool((have == 15).all()))
            check(not crashed.any() and bool((have == 15).all()),
                  f"{name}: {extra}")
        check(bool(f.halted.all()), f"{name}: a lane did not halt")
        if name.startswith("tpc"):
            # tpc_invariant (K17): the [B, N, TX] decisions read once,
            # the verdict (a bool and a code) written once
            nb = f.node_state["decided"].numel() * 4 + MODEL_B * 5
            extra.update(invariant_bound_bytes=nb,
                         invariant_bound_ms=nb / HBM_BYTES_PER_S * 1e3)
        emit(phase="tpc_gossip", case=name, **nums, **extra)
    return on


KV4_B, KV4_STEPS, KV4_CHUNK = 100_000, 60_000, 512   # config 4's own
KV4_SMALL_B = 4096           # run_compacting against run_fused
KV4_LANES = (0, 1, 2, 3)     # config 4's lanes the CPU child runs
KV4_OPERANDS_AT = 512        # K11's config-4 operands: this step's
KV_B, KV_STEPS, KV_CHUNK = 4096, 60_000, 512
KV_LANES = (0, 1, 2047, 4095)
KV_EAGER_STEPS = 128         # run = run_fused over this prefix: the eager
                             # KV step is host-bound (~40 ms at B=4096)
LEAKY_CPU_LANES = 64         # lanes of the poisoned bank the CPU runs


def leaky_bank_runtime(device):
    """The JAX package's tests/test_bank.py:48-80 poisoned replica: 3
    servers and 2 clients of 6 ops, log 32, the fifth appended entry's
    amount inflated by 7 on the node that appends it, the conservation
    invariant in its pairwise form; its lanes crash with 501 (money
    leak) or 102 (log mismatch)."""
    import numpy as np
    import torch
    from madsim_tpu_torch import Runtime, SimConfig, sec
    from madsim_tpu_torch.models import bank
    from madsim_tpu_torch.ops.select import put_row, take1

    class Leaky(bank.RaftBank):
        def _extra_message(self, ctx, st, src, tag, payload):
            super()._extra_message(ctx, st, src, tag, payload)
            four = torch.full_like(st["log_len"], 4)
            bad = (st["log_len"] == 5) & (take1(st["log_op"], four)
                                          == bank.OP_TRANSFER)
            st["log_amt"] = put_row(st["log_amt"], four,
                                    take1(st["log_amt"], four) + 7, bad)

    n_raft, n_clients = 3, 2
    n = n_raft + n_clients
    cfg = SimConfig(n_nodes=n, event_capacity=96, payload_words=13,
                    time_limit=sec(20))
    return Runtime(cfg, [Leaky(n, 6, 100, 32, n_peers=n_raft),
                         bank.BankClient(n_raft, 6, 6)],
                   bank.bank_state_spec(n, 32, 6),
                   node_prog=np.asarray([0] * n_raft + [1] * n_clients),
                   invariant=bank.bank_invariant(n, 32, n_raft, 6, 100),
                   persist=bank.bank_persist_spec(),
                   halt_when=bank.all_clients_done(n_raft, 6),
                   device=device)


def kv_cases():
    """name: (runtime maker, servers, clients, ops, whether the eager
    step is profiled by section) of the kv_bank phase's three cells."""
    from madsim_tpu_torch import workloads
    return {"kv_default": (workloads.kv_default_runtime, 5, 3, 12, False),
            "kv_snapshot": (workloads.kv_snapshot_runtime, 5, 3, 10, False),
            "bank_chaos": (workloads.bank_chaos_runtime, 5, 3, 8, True)}


def search_cpu_main(out_path) -> int:
    """`chip_smoke.py --search-cpu OUT`: the CPU half of the
    search_same_on_both phase, the saturating campaign (SAT) through
    `fuzz` on the CPU, run beside the card's phases (it touches no
    card); its result, corpus entries, wall seconds and the kernel
    wrappers' launch counts (all zero on the CPU), pickled to OUT."""
    import pickle
    import numpy as np
    import torch
    from madsim_tpu_torch import workloads
    from madsim_tpu_torch.ops import kernels
    from madsim_tpu_torch.search import Corpus, KnobPlan, fuzz
    torch.set_num_threads(1)
    rt = workloads.saturating_runtime(device="cpu")
    corpus = Corpus(KnobPlan.from_runtime(rt),
                    rng=np.random.default_rng(SAT["rng_seed"]))
    t0 = time.perf_counter()
    r = fuzz(rt, corpus=corpus, dry_rounds=SAT["max_rounds"] + 1, **SAT)
    out = dict(result=r, entries=corpus.entries,
               wall_s=time.perf_counter() - t0,
               counts={k: w.launches for k, w in kernels.wrappers().items()})
    with open(out_path, "wb") as f:
        pickle.dump(out, f)
    return 0


def kv_cpu_main(out_path) -> int:
    """`chip_smoke.py --kv-cpu OUT`: the CPU halves of the kv_config4 and
    kv_bank phases (config 4's KV4_LANES, each cell's KV_LANES, the
    poisoned bank's first LEAKY_CPU_LANES verdicts), run beside the
    card's phases (it touches no card); pickled to OUT."""
    import pickle
    import numpy as np
    import torch
    from madsim_tpu_torch import interop, workloads
    torch.set_num_threads(1)
    out = {}
    rt = workloads.kv_config4_runtime(device="cpu")
    s, _ = rt.run(rt.init_batch(np.asarray(KV4_LANES, np.uint32)),
                  KV4_STEPS, 64)
    out["kv_config4"] = interop.state_to_numpy(s)
    for name, (build, *_) in kv_cases().items():
        rt = build("cpu")
        s, _ = rt.run(rt.init_batch(np.asarray(KV_LANES, np.uint32)),
                      KV_STEPS, 64)
        out[name] = interop.state_to_numpy(s)
    rt = leaky_bank_runtime("cpu")
    s, _ = rt.run(rt.init_batch(np.arange(LEAKY_CPU_LANES,
                                          dtype=np.uint32)), KV_STEPS, 64)
    out["leaky_verdicts"] = (s.crashed.numpy(), s.crash_code.numpy())
    with open(out_path, "wb") as f:
        pickle.dump(out, f)
    return 0


def histories_linearizable(state, n_raft, n_clients):
    """(histories, linearizable, checker seconds) of a KV batch: every
    lane's client history extracted and checked on the host."""
    from madsim_tpu_torch.models.raft_kv import extract_histories
    from madsim_tpu_torch.native import check_kv_history
    t0 = time.perf_counter()
    hists = extract_histories(state, n_raft, n_clients)
    ok = sum(check_kv_history(h) for h in hists)
    return len(hists), ok, time.perf_counter() - t0


def kv_config4_phase(wrappers, dev, names, every, counts, cpu):
    """BASELINE.md config 4 (workloads.kv_config4_runtime) at KV4_B seeds
    in one batch through run_compacting: no crash, no oops, every client
    done, every history linearizable (the port's checker, on the host),
    KV4_LANES equal to the CPU child's, each step kernel its count a
    step (the graphs' replays and the warm-ups); at KV4_SMALL_B lanes
    run_compacting equal to run_fused. Returns (the K1/K4 kernels it
    ran, K11's operands at step KV4_OPERANDS_AT)."""
    import numpy as np
    import torch
    from madsim_tpu_torch import workloads
    from madsim_tpu_torch.runtime.runtime import FusedGraph
    reset_counts, read_counts = counts
    rt = workloads.kv_config4_runtime(device=dev)
    init = rt.init_batch(np.arange(KV4_B, dtype=np.uint32))
    per = step_launches(wrappers, rt, init)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    out = rt.run_compacting(init, KV4_STEPS, chunk=KV4_CHUNK)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    cst = dict(rt.compact_stats)
    got = read_counts()
    launches = {k: got[k] + cst["graph_launches"].get(k, 0) for k in every}
    steps = cst["graph_steps"] + cst["captures"] * FusedGraph.WARMUP_STEPS
    on = check_once_per_step("kv_config4 run_compacting", launches, steps,
                             names, per)
    crashed = int(out.crashed.sum())
    oops = int((out.oops != 0).sum())
    done = bool((out.node_state["c_opn"][:, 5:] >= 6).all())
    events = int(out.steps.sum())
    n_hist, n_lin, check_s = histories_linearizable(out, 5, 3)
    diff = numpy_equal(cpu["kv_config4"], numpy_lanes(out, KV4_LANES))
    # K11's operands mid-run, and the step's plain draws, at full width
    mid = rt.run_fused(init, KV4_OPERANDS_AT, chunk=KV4_OPERANDS_AT)
    ops = raft_operands(rt, mid)
    draws, onehot = plain_draws_in_step(rt, mid)
    prof = profile_steps(lambda st, n: rt.run_fused(st, n, chunk=n), init,
                         KV4_B, dict({k: 1 for k in names}, **per))
    del mid
    small = rt.init_batch(np.arange(KV4_SMALL_B, dtype=np.uint32))
    c_small = rt.run_compacting(small, KV4_STEPS, chunk=KV4_CHUNK)
    small_stats = dict(rt.compact_stats)
    f_small = rt.run_fused(small, KV4_STEPS, chunk=KV4_CHUNK)
    same_small = state_equal(c_small, f_small)
    emit(phase="kv_config4", config="BASELINE.md config 4", batch=KV4_B,
         chunk=KV4_CHUNK, steps_to_halt=int(out.steps.max()), wall_s=wall,
         seed_events_per_s=events / wall, events=events,
         checker_s=check_s, histories=n_hist, linearizable=n_lin,
         crashed=crashed, oops_lanes=oops, all_clients_done=done,
         all_halted=bool(out.halted.all()), widths=cst["widths"],
         repacks=cst["repacks"], graph_captures=cst["captures"],
         graph_steps=cst["graph_steps"], launches=launches,
         raft_invariant_launches=launches["raft_invariant"],
         k1k4_per_step=per, prng_calls=draws, onehot_put_rows=onehot,
         graph_device_ms_per_step=prof.get("device_busy_ms_per_step"),
         graph_device_busy_share=prof.get("device_busy_share"),
         graph_kernels_per_step=prof.get("device_kernels_per_step"),
         cpu_lanes=list(KV4_LANES), cpu_lanes_differ=diff[:4],
         small_batch=KV4_SMALL_B, small_widths=small_stats["widths"],
         small_run_compacting_equal_run_fused=same_small)
    check(crashed == 0 and oops == 0,
          f"kv_config4: {crashed} lanes crashed, {oops} overflowed")
    check(done and bool(out.halted.all()),
          "kv_config4: a client did not finish or a lane did not halt")
    check(n_hist == KV4_B and n_lin == KV4_B,
          f"kv_config4: {n_hist - n_lin} of {n_hist} histories are not "
          f"linearizable")
    check(not diff, f"kv_config4: lanes {KV4_LANES} differ from the CPU's "
          f"in {diff[:4]}")
    check(not draws and not onehot, f"kv_config4: an eager step on the "
          f"card drew with core/prng.py {draws} or wrote node_state with a "
          f"one-hot put_row {onehot}")
    check(same_small, "kv_config4: run_compacting differs from run_fused "
          f"at B={KV4_SMALL_B}")
    check(cst["repacks"] >= 1, "kv_config4: no repack")
    return on, ops


def kv_bank_phase(wrappers, dev, names, every, counts, cpu):
    """kv_cases() at KV_B lanes through model_phase (run_fused to the
    halt, run = run_fused over KV_EAGER_STEPS, KV_LANES equal to the CPU
    child's): no crash, every client done; the KV cells' histories
    linearizable, every completed bank op's total the conserving 600;
    the poisoned bank crashing lanes with 501 or 102, its first
    LEAKY_CPU_LANES verdicts the CPU's. Returns (the K1/K4 kernels it
    ran, K11's operands of each cell at step KV4_OPERANDS_AT)."""
    import numpy as np
    import torch
    from madsim_tpu_torch.models import bank
    on, ops = set(), {}
    for name, (build, n_raft, n_clients, n_ops, sections) in \
            kv_cases().items():
        f, nums, on_case = model_phase(
            wrappers, dev, names, every, counts, name, build, KV_STEPS,
            KV_B, KV_CHUNK, KV_LANES, cpu[name], profile_eager=sections,
            eager_steps=KV_EAGER_STEPS)
        on |= on_case
        crashed = int(f.crashed.sum())
        oops = int((f.oops != 0).sum())
        done = bool((f.node_state["c_opn"][:, n_raft:] >= n_ops).all())
        extra = dict(crashed=crashed, oops_lanes=oops, all_clients_done=done)
        if name.startswith("kv"):
            n_hist, n_lin, check_s = histories_linearizable(f, n_raft,
                                                            n_clients)
            extra.update(histories=n_hist, linearizable=n_lin,
                         checker_s=check_s)
            check(n_lin == n_hist == KV_B, f"{name}: {n_hist - n_lin} "
                  f"histories are not linearizable")
        else:
            tot = f.node_state["h_total"][:, n_raft:].cpu().numpy()
            resp = f.node_state["h_resp"][:, n_raft:].cpu().numpy()
            seen = tot[resp >= 0]
            # the conservation sum (K18): commit [B, N] and four [B, N, L]
            # log columns read once, the verdict written once (K11 reads
            # its own operands beside it)
            ns = f.node_state
            nb = (ns["commit"].numel() + sum(
                ns[c].numel() for c in ("log_op", "log_afrom", "log_ato",
                                        "log_amt"))) * 4 + KV_B * 5
            extra.update(completed_ops=int(seen.size),
                         conserving=int((seen == 600).sum()),
                         conservation_bound_bytes=nb,
                         conservation_bound_ms=nb / HBM_BYTES_PER_S * 1e3)
            check(seen.size > 0 and bool((seen == 600).all()),
                  f"{name}: a completed op saw a total other than 600")
        rt = build(dev)
        mid = rt.run_fused(rt.init_batch(np.arange(KV_B, dtype=np.uint32)),
                           KV4_OPERANDS_AT, chunk=KV4_OPERANDS_AT)
        ops[name] = raft_operands(rt, mid)
        del mid, rt
        emit(phase="kv_bank", case=name, **nums, **extra)
        check(crashed == 0 and oops == 0 and done
              and bool(f.halted.all()), f"{name}: {extra}")
    # the poisoned replica
    rt = leaky_bank_runtime(dev)
    s0 = rt.init_batch(np.arange(KV_B, dtype=np.uint32))
    f = rt.run_fused(s0, KV_STEPS, chunk=KV_CHUNK)
    torch.cuda.synchronize()
    crashed = f.crashed.cpu().numpy()
    codes = f.crash_code.cpu().numpy()
    want_c, want_code = cpu["leaky_verdicts"]
    n = len(want_c)
    same = (np.array_equal(crashed[:n], want_c)
            and np.array_equal(codes[:n], want_code))
    emit(phase="kv_bank", case="bank_poisoned", batch=KV_B,
         crashed=int(crashed.sum()),
         crash_codes=sorted(set(codes[crashed].tolist())),
         cpu_lanes_compared=n, same_verdicts_as_cpu=same)
    check(crashed.any() and set(codes[crashed].tolist()) <= {
        bank.CRASH_MONEY_LEAK, 102}, "bank_poisoned: crashes "
        f"{sorted(set(codes[crashed].tolist()))}")
    check(same, f"bank_poisoned: crash verdicts differ from the CPU's on "
          f"lanes 0..{n - 1}")
    return on, ops


CHAIN_B = 16_384             # chain replication's cell (C=384)
P9B_B = 4096                 # the other P9 models' cells
P9B_CHUNK = 512
P9B_STEPS = 60_000
P9B_EAGER_STEPS = 128        # run = run_fused over this prefix (host-bound)
CHAIN_LANES = (0, 1, 8_191, 16_383)
P9B_LANES = (0, 1, 2047, 4095)
P9B_RED_LANES = 256          # the first lanes whose verdicts the CPU runs
SHARD_STEPS = 512            # sharded KV's step cap, where its CPU lanes
                             # are held too (its clients finish at
                             # ~11,000-12,300 steps, ~15 simulated s)
SHARD_EAGER_STEPS = 32       # its run = run_fused prefix (~0.2 s an eager
                             # step: three Raft programs, 6,147 kernels)
SHARD_PROF_STEPS = 8         # its profiled graph steps (6,147 kernels each;
                             # one graph block: FUSED_BLOCK)
P9B_OPERANDS_AT = 512        # chain's kernel operands: this step's
K11_LEAVES = ("role", "term", "snap_len", "log_len", "commit",
              "snap_digest", "log_term", "log_op", "log_key", "log_val",
              "log_client", "log_rtag")   # the sharded KV's K11 operands


def p9b_cases():
    """name: (builder, batch, step cap, lanes the CPU runs, Raft groups,
    whether the eager step is profiled by section) of the models_p9b
    phase's green cells."""
    from madsim_tpu_torch import workloads
    return {
        "chain": (workloads.chain_runtime, CHAIN_B, P9B_STEPS, CHAIN_LANES,
                  0, True),
        "ministream": (workloads.ministream_runtime, P9B_B, P9B_STEPS,
                       P9B_LANES, 0, False),
        "percolator": (workloads.percolator_runtime, P9B_B, P9B_STEPS,
                       P9B_LANES, 0, False),
        "shard_kv": (workloads.shardkv_runtime, P9B_B, SHARD_STEPS,
                     P9B_LANES, 3, False)}


def p9b_step_launches(groups) -> dict:
    """{step kernel: launches a step} of a models_p9b cell with `groups`
    Raft groups: raft_invariant once a group (the sharded KV's
    compose_invariants), not at all without Raft; the others once."""
    out = {k: 1 for k in STEP_KERNELS if k != "raft_invariant"}
    if groups:
        out["raft_invariant"] = groups
    return out


def p9b_red_cases():
    """name: (builder, the crash code its oracle fires) of the models_p9b
    phase's red cells."""
    from madsim_tpu_torch import workloads
    from madsim_tpu_torch.models import chain, ministream, percolator
    return {
        "chain_buggy": (workloads.chain_buggy_runtime,
                        chain.CRASH_TWO_TAILS),
        "ministream_overtake": (workloads.ministream_overtake_runtime,
                                ministream.CRASH_STREAM_LOST_OR_DUP),
        "percolator_gray": (workloads.percolator_gray_runtime,
                            percolator.CRASH_SNAPSHOT)}


def p9b_cpu_main(out_path) -> int:
    """`chip_smoke.py --p9b-cpu OUT`: the CPU half of the models_p9b
    phase, run beside the card's phases (it touches no card): each green
    cell's lanes (to the halt, or to the cell's step cap), and the
    first P9B_RED_LANES verdicts of each red cell and of percolator (the
    lite design's TTL hole crashes a few of its lanes with no fault
    injected, in the reference too); pickled to OUT."""
    import pickle
    import numpy as np
    import torch
    from madsim_tpu_torch import interop, workloads
    torch.set_num_threads(1)
    out = {}
    for name, (build, _, cap, lanes, _, _) in p9b_cases().items():
        rt = build("cpu")
        s, _ = rt.run(rt.init_batch(np.asarray(lanes, np.uint32)), cap,
                      min(64, cap))
        out[name] = interop.state_to_numpy(s)
    verdicts = {k: b for k, (b, _) in p9b_red_cases().items()}
    verdicts["percolator"] = workloads.percolator_runtime
    for name, build in verdicts.items():
        rt = build("cpu")
        s, _ = rt.run(rt.init_batch(np.arange(P9B_RED_LANES,
                                              dtype=np.uint32)),
                      P9B_STEPS, 64)
        out[f"{name}_verdicts"] = (s.crashed.numpy(), s.crash_code.numpy())
    with open(out_path, "wb") as f:
        pickle.dump(out, f)
    return 0


def same_verdicts(state, want):
    """(crashed lanes, their codes, whether the first len(want) lanes'
    crash verdicts and codes equal `want`, the CPU's)."""
    import numpy as np
    crashed = state.crashed.cpu().numpy()
    codes = state.crash_code.cpu().numpy()
    want_c, want_code = want
    n = len(want_c)
    return crashed, codes, (np.array_equal(crashed[:n], want_c)
                            and np.array_equal(codes[:n], want_code))


def p9b_profile_main() -> int:
    """`chip_smoke.py --p9b-profile`: the eager step's sections (handlers,
    invariant) of the models_p9b cells the main run does not profile
    eager (ministream, percolator, the sharded KV), each from its
    step-P9B_OPERANDS_AT state at its cell's width, beside the handlers'
    byte bound (ROADMAP K16/K17). One JSON line a cell; needs a card."""
    import numpy as np
    import torch
    from madsim_tpu_torch.ops import kernels
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    wrappers = kernels.wrappers()
    kernels.build_all()
    for name, (build, batch, _, _, groups, sections) in \
            p9b_cases().items():
        if sections:
            continue
        rt = build(dev)
        mid = rt.run_fused(rt.init_batch(np.arange(batch, dtype=np.uint32)),
                           P9B_OPERANDS_AT, chunk=P9B_OPERANDS_AT)
        per = step_launches(wrappers, rt, mid)
        pe = profile_steps(lambda st, n: rt.run(st, n, chunk=n)[0], mid,
                           batch, dict(p9b_step_launches(groups), **per))
        sec = pe.get("section_ms_per_step") or {}
        hb = handlers_bytes(rt, mid)
        emit(phase="p9b_profile", case=name, batch=batch,
             from_step=P9B_OPERANDS_AT,
             eager_device_ms_per_step=pe.get("device_busy_ms_per_step"),
             handlers_ms_per_step=sec.get("handlers"),
             invariant_ms_per_step=sec.get("invariant"),
             eager_section_ms_per_step=sec,
             kernel_ms_per_step=pe.get("kernel_ms_per_step"),
             handler_split=pe.get("handler_split"),
             handlers_bound_bytes=hb,
             handlers_bound_ms=hb / HBM_BYTES_PER_S * 1e3,
             device=torch.cuda.get_device_name(0))
        del mid, rt
    return 0


def models_p9b_phase(wrappers, dev, every, counts, cpu):
    """The last P9 models without a new net layer, each through
    model_phase (run_fused to the halt or the step cap, run = run_fused
    over P9B_EAGER_STEPS, the CPU child's lanes equal; the sharded KV to
    its cap of SHARD_STEPS, the CPU's lanes there): chain replication
    at C=384 and B=CHAIN_B (the wide K2 and K5 instantiations on a main
    path), the streaming dataflow, Percolator-lite (C=256, its commit WAL
    through the fs flush) and the sharded KV (bench.py's config: three
    Raft groups, one raft_invariant launch each a step, L=192, K3 at its
    48-leaf limit) at P9B_B. Checks: no crash on chain, ministream and
    shard_kv; every client done (shard_kv: on every lane halted by the
    step cap, none by this cap); chain's and shard_kv's histories
    linearizable;
    ministream's every epoch committed once; no plain draw in an eager
    step on the card; the red cells' and percolator's crashed lanes and
    codes equal to the CPU child's on their first P9B_RED_LANES lanes.
    Returns (the K1/K4 kernels it ran, chain's K2 and K5 operands at step
    P9B_OPERANDS_AT, chain's launches of each)."""
    import numpy as np
    import torch
    from madsim_tpu_torch.fs import fs_state
    from madsim_tpu_torch.models import percolator
    on, chain_ops, chain_launch = set(), None, None
    fs_leaves = tuple(fs_state(1, 1))
    for name, (build, batch, cap, lanes, groups, sections) in \
            p9b_cases().items():
        t_cell = time.perf_counter()
        rt = build(dev)       # one runtime: one graph capture for the cell
        f, nums, on_case = model_phase(
            wrappers, dev, p9b_step_launches(groups), every, counts, name,
            lambda _: rt, cap, batch, P9B_CHUNK, lanes, cpu[name],
            profile_eager=sections,
            eager_steps=(SHARD_EAGER_STEPS if name == "shard_kv"
                         else P9B_EAGER_STEPS),
            prof_steps=SHARD_PROF_STEPS if name == "shard_kv" else PROF_STEPS)
        model_s = time.perf_counter() - t_cell
        on |= on_case
        # the step-P9B_OPERANDS_AT state (K2/K5 operands, the plain-draw
        # check): the capped cell's last state, else a replay of the
        # runtime's captured graph
        mid = (f if cap == P9B_OPERANDS_AT else rt.run_fused(
            rt.init_batch(np.arange(batch, dtype=np.uint32)),
            P9B_OPERANDS_AT, chunk=P9B_OPERANDS_AT))
        crashed = f.crashed.cpu().numpy()
        halted = f.halted.cpu().numpy()
        oops = int((f.oops != 0).sum())
        ns = f.node_state
        extra = dict(C=rt.cfg.event_capacity, n_nodes=rt.cfg.n_nodes,
                     node_state_leaves=len(ns), crashed=int(crashed.sum()),
                     oops_lanes=oops, halted=int(halted.sum()))
        draws, onehot = plain_draws_in_step(rt, mid, skip=fs_leaves)
        extra.update(prng_calls=draws, onehot_put_rows=onehot)
        check(not draws and not onehot, f"{name}: an eager step on the "
              f"card drew with core/prng.py {draws} or wrote node_state "
              f"with a one-hot put_row {onehot}")
        clients_base = None
        if name == "chain":
            chain_ops = dict(select=select_inputs(mid),
                             emit=emit_operands(rt, mid),
                             at=f"chain_B{batch}_step_{P9B_OPERANDS_AT}")
            chain_launch = nums["launches"]
            done = (ns["c_opn"][:, 4:] >= 20).all(1).cpu().numpy()
            clients_base = 4        # the KV store's history layout
            # chain_invariant (K17): r_pos, r_len, r_lease and alive
            # [B, N] and the clock read once, the verdict written once
            nb = (sum(ns[k].numel() * 4 for k in ("r_pos", "r_len",
                                                   "r_lease"))
                  + f.alive.numel() + batch * 4 + batch * 5)
            extra.update(invariant_bound_bytes=nb,
                         invariant_bound_ms=nb / HBM_BYTES_PER_S * 1e3)
        elif name == "shard_kv":
            done = (ns["c_opn"][:, 9:] >= 64).all(1).cpu().numpy()
            clients_base = 9
            # compose_invariants (K17; three K11 launches, one a group):
            # every node's K11 operands read once (each node is in one
            # group), the verdict written once
            nb = sum(ns[k].numel() * 4 for k in K11_LEAVES) + batch * 5
            extra.update(invariant_bound_bytes=nb,
                         invariant_bound_ms=nb / HBM_BYTES_PER_S * 1e3)
            opn = ns["c_opn"][:, 9:].sum(1).cpu().numpy()
            extra.update(step_cap=cap, halted_by_cap=int(halted.sum()),
                         client_ops_done_min=int(opn.min()),
                         client_ops_done_mean=float(opn.mean()),
                         sim_seconds_min=float(f.now.min()) / 1e6,
                         cfgs_max=int(ns["cfg_n"][:, :3].max()),
                         lanes_migrated=int((ns["out_num"][:, 3:9] >= 2)
                                            .any(-1).any(-1).sum()))
        elif name == "ministream":
            done = (ns["k_committed"][:, 3] == 4).cpu().numpy()
        else:
            done = (ns["c_done"][:, 2:] == 1).all(1).cpu().numpy()
        del mid
        extra.update(clients_done=int(done.sum()))
        if clients_base is not None:
            n_hist, n_lin, check_s = histories_linearizable(f, clients_base,
                                                            2)
            extra.update(histories=n_hist, linearizable=n_lin,
                         checker_s=check_s)
            check(n_hist == n_lin == batch, f"{name}: {n_hist - n_lin} of "
                  f"{n_hist} histories are not linearizable")
        if name == "percolator":
            # the lite design's TTL hole crashes a few lanes with no fault
            # injected (in the reference too): held to the CPU's verdicts
            _, codes, same = same_verdicts(f, cpu["percolator_verdicts"])
            extra.update(crash_codes=sorted(set(codes[crashed].tolist())),
                         cpu_lanes_compared=P9B_RED_LANES,
                         same_verdicts_as_cpu=same)
            check(set(codes[crashed].tolist()) <= {percolator.CRASH_SNAPSHOT}
                  and oops == 0 and same, f"{name}: {extra}")
            check(bool(done[~crashed].all()) and bool(halted.all()),
                  f"{name}: a client did not finish or a lane did not halt")
        elif name == "shard_kv":
            check(not crashed.any() and oops == 0, f"{name}: {extra}")
            # its lanes halt at ~11,000-12,300 steps (15 simulated s; the
            # JAX package on 16 seeds): by the cap, clients are mid-way
            check(bool(done[halted].all()) and int(opn.sum()) > 0,
                  f"{name}: no client op done by step {cap}, or a halted "
                  f"lane's client did not finish")
        else:
            check(not crashed.any() and oops == 0 and bool(done.all())
                  and bool(halted.all()), f"{name}: {extra}")
        emit(phase="models_p9b", case=name, **nums, **extra,
             model_phase_s=model_s, cell_s=time.perf_counter() - t_cell)
        del f, rt
    # the red cells: crashed lanes and codes against the CPU's
    for name, (build, code) in p9b_red_cases().items():
        rt = build(dev)
        s0 = rt.init_batch(np.arange(P9B_B, dtype=np.uint32))
        t0 = time.perf_counter()
        f = rt.run_fused(s0, P9B_STEPS, chunk=P9B_CHUNK)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        crashed, codes, same = same_verdicts(f, cpu[f"{name}_verdicts"])
        emit(phase="models_p9b", case=name, batch=P9B_B, wall_s=wall,
             steps_to_halt=int(f.steps.max()), crashed=int(crashed.sum()),
             crash_codes=sorted(set(codes[crashed].tolist())),
             cpu_lanes_compared=P9B_RED_LANES,
             cpu_crashed=int(cpu[f"{name}_verdicts"][0].sum()),
             same_verdicts_as_cpu=same)
        check(crashed.any() and set(codes[crashed].tolist()) <= {code},
              f"{name}: crashes {sorted(set(codes[crashed].tolist()))}")
        check(same, f"{name}: crash verdicts differ from the CPU's on "
              f"lanes 0..{P9B_RED_LANES - 1}")
        check(bool(f.halted.all()), f"{name}: a lane did not halt")
        del f, rt
    return on, chain_ops, chain_launch


def main() -> int:
    import torch
    if len(sys.argv) == 3 and sys.argv[1] == "--minimize-cpu":
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        return minimize_cpu_main(sys.argv[2])
    if len(sys.argv) == 3 and sys.argv[1] == "--planes-cpu":
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        return planes_cpu_main(sys.argv[2])
    if len(sys.argv) == 3 and sys.argv[1] == "--tt-cpu":
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        return tt_cpu_main(sys.argv[2])
    if len(sys.argv) == 3 and sys.argv[1] == "--kv-cpu":
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        return kv_cpu_main(sys.argv[2])
    if len(sys.argv) == 2 and sys.argv[1] == "--p9b-profile":
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        return p9b_profile_main()
    if len(sys.argv) == 3 and sys.argv[1] == "--p9b-cpu":
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        return p9b_cpu_main(sys.argv[2])
    if len(sys.argv) == 3 and sys.argv[1] == "--search-cpu":
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        return search_cpu_main(sys.argv[2])
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

    # the minimize phase's CPU half runs beside the card's phases, in a
    # process of its own that the main process waits for (or stops)
    import atexit
    import shutil
    import tempfile
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    cpu_min_path = os.path.join(tmp, "minimize_cpu.pkl")
    cpu_min = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--minimize-cpu",
         cpu_min_path], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    # and so does the planes phase's (a few lanes of the plane flagship)
    cpu_planes_path = os.path.join(tmp, "planes_cpu.pkl")
    cpu_planes = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--planes-cpu",
         cpu_planes_path], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)

    # and so do the time-travel and model phases' (their CPU results)
    cpu_tt_path = os.path.join(tmp, "tt_cpu.pkl")
    cpu_tt = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--tt-cpu",
         cpu_tt_path], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)

    # and so do the KV and bank phases, and search_same_on_both
    cpu_kv_path = os.path.join(tmp, "kv_cpu.pkl")
    cpu_kv = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--kv-cpu",
         cpu_kv_path], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    cpu_search_path = os.path.join(tmp, "search_cpu.pkl")
    cpu_search = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--search-cpu",
         cpu_search_path], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    # (the models_p9b phase's starts after the fuzz_flagship phase, whose
    # host half the six children together slowed)
    children = [cpu_min, cpu_planes, cpu_tt, cpu_kv, cpu_search]

    def stop_children():
        for child in children:
            if child.poll() is None:
                child.kill()
                child.wait()
        shutil.rmtree(tmp, ignore_errors=True)

    atexit.register(stop_children)

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
          == {k: prof_fused["steps"] * n
              for k, n in expect_tr.items()},
          f"profile run_fused: traced launches "
          f"{prof_fused['kernel_launches']} in {prof_fused['steps']} "
          "steps")
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
    cpu_p9b_path = os.path.join(tmp, "p9b_cpu.pkl")
    cpu_p9b = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--p9b-cpu",
         cpu_p9b_path], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    children.append(cpu_p9b)

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
    rt = workloads.saturating_runtime(device=dev)
    corpus = Corpus(KnobPlan.from_runtime(rt),
                    rng=np.random.default_rng(SAT["rng_seed"]))
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    with Spy(corpus_mod.Corpus, "schedule") as sched_spy:
        r = fuzz(rt, corpus=corpus, dry_rounds=SAT["max_rounds"] + 1,
                 **SAT)
    torch.cuda.synchronize()
    camp = dict(cuda=dict(result=r, entries=corpus.entries,
                          wall_s=time.perf_counter() - t0,
                          counts=read_counts(),
                          mutated=len(sched_spy.seconds)),
                cpu=wait_child(cpu_search, cpu_search_path,
                               "search_same_on_both"))
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

    # ---- the harness: compacting, detsan (and the lane kernels), minimize,
    # ---- harness_misc
    compact_launch = compacting_phase(wrappers, dev)
    detsan_launch, lane_k = detsan_phase(wrappers, dev, compact_launch)
    minimize_phase(wrappers, dev, cpu_min, cpu_min_path)
    harness_misc_phase(dev, tmp)

    # ---- planes: the profiler and latency planes on the flagship ----------
    planes_out = planes_phase(wrappers, dev, names, every, flag_fp,
                              prof_fused, cpu_planes, cpu_planes_path,
                              (reset_counts, read_counts))
    slo_phase(dev)
    # ---- planes_all: every observation plane on the flagship; recovery
    all_out = planes_all_phase(wrappers, dev, names, every, flag_fp,
                               prof_fused, planes_out.pop("cpu_all"),
                               (reset_counts, read_counts))
    recovery_phase(dev)

    # ---- time travel and the first net-layer models -----------------------
    tt_k = timetravel_flagship_phase(wrappers, dev, names, every, flag_fp,
                                     (reset_counts, read_counts))
    cpu_tt_out = wait_child(cpu_tt, cpu_tt_path, "timetravel_explain")
    timetravel_explain_phase(dev, tmp, cpu_tt_out)
    on_path |= echo_phase(wrappers, dev, no_raft, every,
                          (reset_counts, read_counts), cpu_tt_out)
    on_path |= tpc_gossip_phase(wrappers, dev, no_raft, every,
                                (reset_counts, read_counts), cpu_tt_out)
    del cpu_tt_out

    # ---- the replicated KV store and the bank on Raft ---------------------
    cpu_kv_out = wait_child(cpu_kv, cpu_kv_path, "kv_config4")
    on_kv, kv4_ops = kv_config4_phase(wrappers, dev, names, every,
                                      (reset_counts, read_counts),
                                      cpu_kv_out)
    on_path |= on_kv
    on_kv, kv_ops = kv_bank_phase(wrappers, dev, names, every,
                                  (reset_counts, read_counts), cpu_kv_out)
    on_path |= on_kv
    del cpu_kv_out

    # ---- the last P9 models with no new net layer ------------------------
    cpu_p9b_out = wait_child(cpu_p9b, cpu_p9b_path, "models_p9b")
    on_p9b, chain_ops, chain_launch = models_p9b_phase(
        wrappers, dev, every, (reset_counts, read_counts), cpu_p9b_out)
    on_path |= on_p9b
    del cpu_p9b_out

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
             # past 256 rows: the wide instantiations (C = 257 and 288
             # share one, so the wider follows the narrower), with nudged
             # and drawn lanes in every tile; EDGE_B lanes (a tile is 32)
             "C_257_N_6": edge_inputs(dev, EDGE_B, 257, 6, seed=7),
             "C_288_N_32": edge_inputs(dev, EDGE_B, 288, 32, seed=8),
             "C_320_N_6": edge_inputs(dev, EDGE_B, 320, 6, seed=9),
             "C_384_N_6": edge_inputs(dev, EDGE_B, 384, 6, seed=10),
             "mixed_tiles_C_384_N_32": mixed_tile_inputs(dev, EDGE_B, 384,
                                                         32, seed=11),
             "unaligned_C_384": tuple(
                 unaligned(a) if i < 5 else a
                 for i, a in enumerate(edge_inputs(dev, EDGE_B, 384, 6,
                                                   seed=12))),
             "every_lane_halted": tuple(every_halted),
             "unaligned_tables": tuple(unaligned(a) if i < 5 else a
                                       for i, a in enumerate(edges))}
    cases.update({f"flagship_step_{k}": v for k, v in captured.items()})
    cases[wal_case] = wal_select
    cases[f"pct_flagship_step_{PCT_STEPS // 2}"] = pct_select
    cases[chain_ops["at"]] = chain_ops["select"]
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
        # with the profiler's occupancy count (an optional output)
        occ_k = sched_pick(*args, True)
        occ_p = sched_pick_plain(*args, True)
        torch.cuda.synchronize()
        check(len(occ_k) == len(occ_p) == 10
              and all(torch.equal(a, b) for a, b in zip(occ_k, out_k))
              and torch.equal(occ_k[9], occ_p[9]),
              f"sched_pick with the occupancy on {name}: differs")
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
    # chain replication's step-512 operands (B=16,384, C=384): the wide
    # instantiation on its main path, timed the same way
    ch_args = chain_ops["select"]
    ch_k = [graph_ms(lambda: sched_pick(*ch_args), 50) for _ in range(2)]
    ch_p = [cuda_ms(lambda: sched_pick_plain(*ch_args), 5)
            for _ in range(2)]
    ch_bytes = bound_bytes(*ch_args)
    sp384 = dict(ms=min(ch_k), plain_ms=min(ch_p),
                 bound_ms=ch_bytes / HBM_BYTES_PER_S * 1e3,
                 max_abs_err=max_err)
    # registers a thread and resident blocks an SM, at the flagship's C,
    # wal_kv's and chain replication's
    occupancy = {f"C_{c}": sched_pick.occupancy(c)
                 for c in sorted({C, wal_select[0].shape[1],
                                  ch_args[0].shape[1]})}
    emit(phase="kernel", name="sched_pick", cases={
        k: list(v[0].shape) for k, v in sorted(cases.items())}, batch=B,
         C=C, N=N, exact=True, max_abs_err=max_err,
         launches_on_main_path=fused_launch["sched_pick"],
         launches_per_step=fused_launch["sched_pick"] / (FLAG_STEPS + warm),
         ms=[k_ms, k_ms2], eager_launch_ms=k_eager,
         ms_in_flagship_graph=prof_fused["sched_pick_ms_per_step"],
         occupancy=occupancy, plain_ms=[p_ms, p_ms2], bound_bytes=nbytes,
         bound_ms=sp_bound_ms, library="none",
         chain=dict(operands=chain_ops["at"], batch=ch_args[0].shape[0],
                    C=ch_args[0].shape[1], ms=ch_k, plain_ms=ch_p,
                    bound_bytes=ch_bytes, bound_ms=sp384["bound_ms"],
                    launches_on_main_path=chain_launch["sched_pick"]))
    del cases, captured, main_args, wal_select, pct_select, edges, \
        every_halted

    # ---- kernel: emit_write against its plain version -----------------------
    # ... and past 256 rows (the wide tables: chain replication's 384),
    # with and without jitter and ring
    for C_e, E_e, ns_e, jit_e, ring_e in ((96, 12, 7, True, True),
                                          (96, 0, 0, False, True),
                                          (256, 3, 1, False, True),
                                          (256, 5, 0, True, False),
                                          (256, 6, 6, False, False),
                                          (257, 4, 2, True, True),
                                          (288, 12, 7, False, False),
                                          (320, 0, 0, False, True),
                                          (384, 9, 6, False, True),
                                          (384, 5, 1, True, False),
                                          (384, 32, 16, True, True)):
        emit_cases[f"edges_C{C_e}_E{E_e}_sends{ns_e}"
                   f"{'_jitter' if jit_e else ''}"
                   f"{'_ring' if ring_e else ''}"] = emit_edge_operands(
            dev, 4096, C_e, 5, 8, E_e, ns_e, jit_e, ring_e, ring_e,
            seed=C_e + E_e)
    emit_cases[chain_ops["at"]] = chain_ops["emit"]
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
    et = emit_write_ms(emit_write, emit_write_plain, main_e)
    ew = dict(ms=min(et["ms"]), plain_ms=min(et["plain_ms"]),
              bound_ms=et["bound_ms"], max_abs_err=max_err_e,
              bound_by=et["bound_by"])
    # chain replication's step-512 operands (B=16,384, C=384)
    ch_e = chain_ops["emit"]
    ct = emit_write_ms(emit_write, emit_write_plain, ch_e)
    ew384 = dict(ms=min(ct["ms"]), plain_ms=min(ct["plain_ms"]),
                 bound_ms=ct["bound_ms"], max_abs_err=max_err_e,
                 bound_by=ct["bound_by"])
    emit(phase="kernel", name="emit_write", cases={
        k: list(v[0]["t_kind"].shape) for k, v in sorted(emit_cases.items())},
         batch=main_e[0]["t_kind"].shape[0],
         C=main_e[0]["t_kind"].shape[1], E=main_e[1]["m"].shape[1],
         n_sends=main_e[4], exact=True, max_abs_err=max_err_e,
         launches_on_main_path=fused_launch["emit_write"],
         launches_per_step=fused_launch["emit_write"] / (FLAG_STEPS + warm),
         ms_in_flagship_graph=prof_fused["emit_write_ms_per_step"],
         library="none", **et,
         chain=dict(operands=chain_ops["at"],
                    batch=ch_e[0]["t_kind"].shape[0],
                    C=ch_e[0]["t_kind"].shape[1], E=ch_e[1]["m"].shape[1],
                    n_sends=ch_e[4], **ct,
                    launches_on_main_path=chain_launch["emit_write"]))
    del emit_cases, main_e, chain_ops

    # ---- kernel: K8 obs_fold, K5's plane columns, K10 -----------------------
    plane_k = plane_kernel_phase(wrappers, dev, planes_out, ew["ms"])
    p99_launch = planes_out["digest_launch"]["lane_p99"]
    planes_out_launch = dict(
        obs_fold=planes_out["launches"]["obs_fold"],
        plane_sums=planes_out["digest_launch"]["plane_sums"])
    del planes_out
    all_k = planes_all_kernel_phase(wrappers, dev, all_out)
    # the pf + lh rows as PR 13 took them; the all-planes numbers in rows
    # of their own
    plane_k.update(obs_fold_all=all_k["obs_fold"],
                   plane_sums_series=all_k["plane_sums"],
                   lane_burst=all_k["lane_burst"])
    plane_launch = dict(
        obs_fold=planes_out_launch["obs_fold"],
        plane_sums=planes_out_launch["plane_sums"], lane_p99=p99_launch,
        obs_fold_all=all_out["launches"]["obs_fold"],
        plane_sums_series=all_out["digest_launch"]["plane_sums"],
        lane_burst=all_out["digest_launch"]["lane_burst"])
    del all_out

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
    # the KV and bank cells' operands at step KV4_OPERANDS_AT: config 4
    # (B=100,000, L=32, F=5), kv_default (L=64), kv_snapshot (L=12, the
    # pairwise form), bank_chaos (L=48, F=6); at B=4096 but config 4
    wide_cases = {f"kv_config4_step_{KV4_OPERANDS_AT}": kv4_ops}
    wide_cases.update({f"{k}_step_{KV4_OPERANDS_AT}": v
                       for k, v in kv_ops.items()})
    raft_cases.update(wide_cases)
    for k in list(raft_cases):     # the captured operands in both forms
        raft_cases[k + ("_adjacent" if raft_cases[k][-1] else
                        "_pairwise")] = raft_cases[k][:-1] + (
                            not raft_cases[k][-1],)
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
    # the KV and bank log lengths (K11's tiled form past 32 slots) with
    # their five and six entry fields, with and without a slid window
    for L_r in (12, 48, 64, 96, 192):
        for F_r in (5, 6):
            for snap in (False, True):
                ops = raft_edge_operands(dev, EDGE_B, 8, L_r, F_r,
                                         L_r + F_r, (1,) * 5 + (0,) * 3,
                                         snap)
                for ws in (False, True):
                    raft_cases[f"edges_kv_N8_L{L_r}_F{F_r}"
                               f"{'_snap' if snap else ''}"
                               f"_{'pairwise' if ws else 'adjacent'}"] = \
                        ops + (ws,)
    for L_r in (64, 192):          # the tiled rows 4 bytes an access
        ops = raft_edge_operands(dev, EDGE_B + 5, 5, L_r, 5, 91, None, True)
        moved = tuple(unaligned(t) for t in ops[:7]) + (
            tuple(unaligned(c) for c in ops[7]),) + ops[8:]
        for ws in (False, True):
            raft_cases[f"edges_B{EDGE_B + 5}_L{L_r}_one_element_in_"
                       f"{'pairwise' if ws else 'adjacent'}"] = moved + (ws,)
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
    # the KV and bank cells' operands, each in the form its runtime runs
    widths = {}
    for k, args in wide_cases.items():
        kk = graph_ms(lambda: raft_invariant_check(*args), 50)
        pp = cuda_ms(lambda: raft_invariant_plain(*args), 5)
        kk2 = graph_ms(lambda: raft_invariant_check(*args), 50)
        nb, no = raft_bound(*args)
        B_w, N_w = args[0].shape
        widths[k] = dict(B=B_w, N=N_w, L=args[6].shape[-1],
                         F=len(args[7]), window_slides=args[-1],
                         ms=min(kk, kk2), plain_ms=pp, bound_bytes=nb,
                         bound_ms=max(nb / HBM_BYTES_PER_S,
                                      no / INT32_OPS_PER_S) * 1e3)
    ri = dict(ms=min(k_ms, k_ms2), plain_ms=min(p_ms, p_ms2),
              bound_ms=max(b_ms, o_ms) * 1e3,
              bound_by="bytes" if b_ms >= o_ms else "operations",
              max_abs_err=err, library_ms=None, widths=widths)
    emit(phase="kernel", name="raft_invariant", cases={
        k: list(v[0].shape) for k, v in sorted(raft_cases.items())},
         main_case=f"flagship_step_{FLAG_CHUNK}", exact=True,
         max_abs_err=err, launches_on_main_path=fused_launch[
             "raft_invariant"], ms=[k_ms, k_ms2], plain_ms=[p_ms, p_ms2],
         ms_in_flagship_graph=prof_fused["raft_invariant_ms_per_step"],
         bound_bytes=nbytes, bound_operations=ops_n, bound_ms=ri["bound_ms"],
         bound_by=ri["bound_by"], library="none", rows_vec4=vec4,
         widths=widths)
    del raft_cases, main_r, wide_cases, kv4_ops, kv_ops

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
            dict({k: 1 for k in names}, **{k: 0 for k in K1K4}),
            steps=PROF_PLAIN_STEPS)
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
            expect_plain, steps=PROF_PLAIN_STEPS)
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
              == {k: prof["steps"] * n for k, n in want.items()},
              f"profile run ({what}): traced launches "
              f"{prof['kernel_launches']} in {prof['steps']} steps")
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
             bound_by=ew["bound_by"], library_ms=None),
        dict(name="sched_pick_C384", route="cuda",
             source="madsim_tpu_torch/csrc/sched_pick.cu",
             replaces="madsim_tpu/core/step.py:141",
             launches=chain_launch["sched_pick"], bound_by="bytes",
             library_ms=None, **sp384),
        dict(name="emit_write_C384", route="cuda",
             source="madsim_tpu_torch/csrc/emit_write.cu",
             replaces="madsim_tpu/core/step.py:476",
             launches=chain_launch["emit_write"], library_ms=None,
             **ew384)] + [
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
            ("put_rows_", "node_rows.cu", "madsim_tpu/ops/select.py:76"))] + [
        dict(name=k, route="cuda", source=f"madsim_tpu_torch/csrc/{src}",
             replaces=where, launches=n, **lane_k[k])
        for k, src, where, n in (
            ("lane_take", "lane_rows.cu", "madsim_tpu/runtime/runtime.py:703",
             compact_launch["lane_take"]),
            ("lane_put", "lane_rows.cu", "madsim_tpu/runtime/runtime.py:729",
             compact_launch["lane_put"]),
            ("lane_diff", "lane_diff.cu", "madsim_tpu/harness/simtest.py:138",
             detsan_launch["lane_diff"]))] + [
        dict(name=k, route="cuda", source="madsim_tpu_torch/csrc/"
             "lane_rows.cu", replaces=where, **tt_k[row])
        for k, row, where in (
            ("lane_take_fork", "fork", "madsim_tpu/core/state.py:849"),
            ("lane_take_lane", "lane", "madsim_tpu/core/state.py:678"))] + [
        dict(name=k, route="cuda", source=f"madsim_tpu_torch/csrc/{src}",
             replaces=where, launches=plane_launch[k], **plane_k[k])
        for k, src, where in (
            ("obs_fold", "obs_fold.cu", "madsim_tpu/core/step.py:673"),
            ("obs_fold_all", "obs_fold.cu", "madsim_tpu/core/step.py:770"),
            ("plane_sums", "plane_digest.cu",
             "madsim_tpu/parallel/stats.py:169"),
            ("plane_sums_series", "plane_digest.cu",
             "madsim_tpu/parallel/stats.py:509"),
            ("lane_p99", "plane_digest.cu",
             "madsim_tpu/parallel/stats.py:465"),
            ("lane_burst", "plane_digest.cu",
             "madsim_tpu/parallel/stats.py:609"))])
    emit(ok=True, device={"platform": "gpu",
                          "kind": torch.cuda.get_device_name(0),
                          "count": torch.cuda.device_count()})
    return 0


if __name__ == "__main__":
    sys.exit(main())
