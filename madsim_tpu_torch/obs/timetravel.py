"""Time travel: lane checkpoints, window replay with upgraded
observability, and the divergence microscope (the counterpart of
`madsim_tpu.obs.timetravel`).

Any harvested lane snapshot re-seeds a fresh batch that continues
bit-identically (`core.state.checkpoint_lane` / `seed_batch_from`), and
because every observation plane is observation-only (TRACE_FIELDS: no
randomness, no replay-domain writes), the continuation may run with more
instrumentation than the original sweep without changing the trajectory.
Built on that:

  * `CheckpointLog` — the harvest `Runtime.run(ckpt_every=K)` and
    `run_fused(ckpt_every=K)` fill at their chunk syncs and segment
    boundaries;
  * `replay_window` / `full_chain_replay` / `time_travel_explain` —
    re-execute from the nearest checkpoint with the ring, profiler and
    latency planes upgraded, check the replay against the live
    observation (fingerprint and crash verdict), and recover the whole
    (`truncated=False`) causal chain and a Perfetto trace of the window;
  * `divergence_report` — bound two lanes' first schedule divergence
    with the coverage sketch, replay both from their last common
    checkpoint under full tracing, and name the first divergent dispatch
    with side-by-side ring suffixes and a two-track Perfetto export;
  * `advance_exact` — the exact-step advance behind `Runtime.state_at`.

A replay that has a live reference is checked against it; a mismatch is
retried once (as the JAX package does) and then raises ReplayDivergence.
On the card each derived runtime captures its own CUDA graph the first
time `run_fused` runs it (one graph is kept a runtime).
"""

from __future__ import annotations

import json

import numpy as np
import torch

from ..core.state import (LaneCheckpoint, checkpoint_lane, packed_copy,
                          seed_batch_from)
from . import causal
from .rings import ring_records
from .trace import _doc, export_chrome_trace, to_chrome_events


class ReplayDivergence(RuntimeError):
    """A window replay did not reproduce the live observation (fingerprint
    or crash verdict, after one retry): the checkpoint belongs to another
    run, or the engine is nondeterministic here."""


def _lane_value(leaf, lane: int):
    a = leaf.cpu().numpy() if isinstance(leaf, torch.Tensor) \
        else np.asarray(leaf)
    return a.reshape(-1)[lane] if a.ndim else a


class CheckpointLog:
    """The harvest of a `run(ckpt_every=K)` / `run_fused(ckpt_every=K)`
    sweep: owned host copies of the whole batch at successive ~K-step
    boundaries, read back per lane as `LaneCheckpoint`s.

    One snapshot is a host copy of the whole batch; `keep` bounds how many
    are kept (the oldest dropped), None keeps all. `signature` is stamped
    by the harvesting runtime."""

    def __init__(self, every: int | None = None, keep: int | None = None):
        self.every = every
        self.keep = keep
        self.signature = None
        self.snaps: list[dict] = []   # dicts: steps_done, state, signature

    def __len__(self) -> int:
        return len(self.snaps)

    def harvest(self, state, steps_done: int | None = None) -> None:
        """Append one snapshot: an owned host copy in one transfer
        (`core.state.packed_copy`), taken once the device work that wrote
        `state` has finished (the copy waits for it), so later in-place
        steps of the same buffers never reach it. The current `signature`
        is kept with each snapshot: a log filled by runs of different
        runtimes keeps each snapshot's own."""
        self.snaps.append(dict(steps_done=steps_done,
                               state=packed_copy(state, torch.device("cpu")),
                               signature=self.signature))
        if self.keep is not None and len(self.snaps) > self.keep:
            del self.snaps[0]

    def lane_steps(self, lane: int) -> list[int]:
        """The lane's dispatch count at each snapshot (monotone; it stops
        advancing once the lane halts)."""
        return [int(_lane_value(s["state"].steps, lane))
                for s in self.snaps]

    def iter_checkpoints(self, lane: int, before_step: int | None = None,
                         live_only: bool = True):
        """The lane's checkpoints, newest first, each taken when consumed.
        `before_step` keeps only snapshots at or before that dispatch
        count; `live_only` (default) drops snapshots where the lane had
        already halted (its final state, not a restart point)."""
        for snap in reversed(self.snaps):
            st = snap["state"]
            if live_only and bool(_lane_value(st.halted, lane)):
                continue
            steps = int(_lane_value(st.steps, lane))
            if before_step is not None and steps > before_step:
                continue
            yield checkpoint_lane(st, lane,
                                  signature=snap.get("signature",
                                                     self.signature))

    def checkpoints(self, lane: int, before_step: int | None = None,
                    live_only: bool = True) -> list[LaneCheckpoint]:
        """`iter_checkpoints` as a list."""
        return list(self.iter_checkpoints(lane, before_step=before_step,
                                          live_only=live_only))

    def nearest(self, lane: int, step: int | None = None,
                live_only: bool = True) -> LaneCheckpoint | None:
        """The latest checkpoint of `lane` at or before `step` (None = the
        latest live one): the one a window replay restarts from."""
        return next(self.iter_checkpoints(lane, before_step=step,
                                          live_only=live_only), None)


# ---------------------------------------------------------------------------
# exact-step advance, the handle's checkpoint
# ---------------------------------------------------------------------------

def advance_exact(rt, state, steps: int, chunk: int = 512):
    """Advance a batched state by EXACTLY `steps` dispatches per live lane,
    in power-of-two pieces of at most `chunk` (the JAX package's `state_at`
    discipline). Halted lanes freeze; an all-halted batch stops early."""
    remaining = int(steps)
    while remaining > 0:
        c = min(int(chunk), 1 << (remaining.bit_length() - 1))
        state, _ = rt.run_exact(state, c)
        remaining -= c
        if bool(state.halted.all()):
            break
    return state


def init_checkpoint(rt, seed: int, knobs: dict | None = None,
                    nudge: int | None = None) -> LaneCheckpoint:
    """The checkpoint every repro handle implies: the t=0 state of
    `(seed[, knobs][, nudge])` on `rt`, so replaying from init is replaying
    from the step-0 checkpoint."""
    state = rt.init_batch(np.asarray([seed], np.uint32))
    if knobs is not None:
        from ..search.mutate import apply_repro_knobs
        state, _ = apply_repro_knobs(rt, state, knobs)
    if nudge is not None:
        from ..search.pct import with_prio_nudge
        state = with_prio_nudge(state, np.asarray([nudge], np.int32))
    return checkpoint_lane(state, 0,
                           signature=rt.cfg.structural_signature())


# ---------------------------------------------------------------------------
# window replay
# ---------------------------------------------------------------------------

def _verdict_of(state, lane: int = 0) -> dict:
    return dict(crashed=bool(_lane_value(state.crashed, lane)),
                crash_code=int(_lane_value(state.crash_code, lane)),
                crash_node=int(_lane_value(state.crash_node, lane)))


def replay_window(rt, ckpt: LaneCheckpoint, *, until_step: int | None = None,
                  max_steps: int = 100_000, chunk: int = 512,
                  trace_cap: int | None = None, profile: bool | None = None,
                  latency_hist: int | None = None,
                  sketch_slots: int | None = None,
                  expect: dict | None = None,
                  export_trace: str | None = None, batch: int = 1) -> dict:
    """Re-execute from a lane checkpoint with observability upgraded.

    Derives a runtime from `rt` with the requested planes compiled in
    (`trace_cap` defaults to covering the whole window, so the ring never
    wraps; `profile` / `latency_hist` / `sketch_slots` override when not
    None), seeds a `batch`-clone child from `ckpt` (`seed_batch_from`
    adapts the planes and resets the ring) and runs it to exactly
    `until_step` total dispatches, or until crash or halt
    (`until_step=None`, at most `max_steps`, through `run_fused`).

    `expect` holds the live observation (any of crashed, crash_code,
    crash_node, fingerprint): a mismatch is retried once, then raises
    ReplayDivergence.

    Returns {state, rt (the upgraded runtime), from_step, steps,
    fingerprint, crashed, crash_code, crash_node[, trace_path]};
    `export_trace` writes lane 0's ring as a Perfetto trace of the
    window."""
    overrides: dict = {}
    if trace_cap is None:
        span = (int(until_step) - ckpt.steps if until_step is not None
                else int(max_steps))
        trace_cap = max(16, span)
    overrides["trace_cap"] = int(trace_cap)
    if profile is not None:
        overrides["profile"] = bool(profile)
    if latency_hist is not None:
        overrides["latency_hist"] = int(latency_hist)
    if sketch_slots is not None:
        overrides["sketch_slots"] = int(sketch_slots)
    changed = {k: v for k, v in overrides.items()
               if getattr(rt.cfg, k) != v}
    wrt = rt.derived(**changed) if changed else rt

    def once():
        st = seed_batch_from(ckpt, batch, rt=wrt, reset_planes=("ring",))
        if until_step is not None:
            st = advance_exact(wrt, st, int(until_step) - ckpt.steps, chunk)
        else:
            st = wrt.run_fused(st, max_steps, chunk)
        return st

    def observed(st):
        return dict(state=st, steps=int(_lane_value(st.steps, 0)),
                    fingerprint=int(wrt.fingerprints(st)[0]),
                    **_verdict_of(st, 0))

    out = dict(rt=wrt, from_step=int(ckpt.steps), **observed(once()))
    if expect is not None:
        def mismatches(o):
            return [k for k in ("crashed", "crash_code", "crash_node",
                                "fingerprint")
                    if k in expect and expect[k] != o[k]]
        if mismatches(out):
            # one retry, as the JAX package does; a second mismatch is a
            # real divergence
            out.update(observed(once()))
            bad = mismatches(out)
            if bad:
                raise ReplayDivergence(
                    f"window replay from step {ckpt.steps} does not "
                    f"reproduce the live observation on {bad}: "
                    f"expected { {k: expect[k] for k in bad} }, "
                    f"replayed { {k: out[k] for k in bad} }")
    if export_trace is not None:
        export_chrome_trace(export_trace, state=out["state"], lane=0)
        out["trace_path"] = export_trace
    return out


def full_chain_replay(rt, *, ckpt: LaneCheckpoint | None = None,
                      seed: int | None = None, knobs: dict | None = None,
                      nudge: int | None = None, expect: dict | None = None,
                      max_steps: int = 100_000, chunk: int = 512,
                      trace_cap: int | None = None,
                      until_step: int | None = None,
                      export_trace: str | None = None) -> dict:
    """Replay to halt (or to exactly `until_step` dispatches, for a lane
    the live sweep left running) from `ckpt`, or from t=0 through the
    (seed[, knobs][, nudge]) handle, with a ring sized to the whole
    window, then explain the final dispatch off the unwrapped ring.
    Returns the `replay_window` dict plus `explain`."""
    if ckpt is None:
        if seed is None:
            raise ValueError("full_chain_replay needs ckpt= or a "
                             "(seed[, knobs][, nudge]) handle")
        ckpt = init_checkpoint(rt, seed, knobs=knobs, nudge=nudge)
    win = replay_window(rt, ckpt, max_steps=max_steps, chunk=chunk,
                        trace_cap=trace_cap, expect=expect,
                        until_step=until_step,
                        export_trace=export_trace)
    exp = causal.explain_crash(win["state"], 0)
    exp["replayed_from_step"] = int(ckpt.steps)
    return dict(win, explain=exp)


def time_travel_explain(rt, state, lane: int = 0, *, ckpts: CheckpointLog,
                        max_steps: int = 100_000, chunk: int = 512,
                        trace_cap: int | None = None,
                        export_trace: str | None = None) -> dict:
    """`explain_crash` that replays instead of settling for the live
    ring's suffix: walk back through the lane's harvested checkpoints
    (newest first), window-replay from each with a ring that holds the
    whole window, and return the first chain that reaches its root. Each
    replay is checked against the live lane (fingerprint and crash
    verdict).

    Returns the `explain_crash` dict with `replayed=True`, `from_step`,
    `fingerprint` and `trace_path` (with `export_trace`). A live chain
    that is already complete returns as it is (`replayed=False`). Raises
    ValueError when no harvested checkpoint covers the lane."""
    live = dict(_verdict_of(state, lane),
                fingerprint=int(rt.fingerprints(state)[lane]))
    try:
        live_exp = causal.explain_crash(state, lane)
    except ValueError:
        live_exp = None          # ring compiled out / lane unsampled
    if live_exp is not None and not live_exp["truncated"]:
        out = dict(live_exp, replayed=False)
        if export_trace is not None:
            export_chrome_trace(export_trace, state=state, lane=lane)
            out["trace_path"] = export_trace
        return out
    crash_step = int(_lane_value(state.steps, lane))
    # a crashed or halted lane is frozen: the replay runs to halt. A lane
    # the sweep left running replays to exactly its dispatch count.
    live_halted = bool(_lane_value(state.halted, lane))
    until = None if live_halted else crash_step
    cks = (ckpts.iter_checkpoints(lane, before_step=crash_step)
           if ckpts is not None else iter(()))
    best = None
    any_ckpt = False
    for ckpt in cks:
        any_ckpt = True
        span = crash_step - ckpt.steps
        rep = full_chain_replay(
            rt, ckpt=ckpt, expect=live, max_steps=max_steps, chunk=chunk,
            trace_cap=(trace_cap if trace_cap is not None
                       else max(16, span)),
            until_step=until,
            export_trace=export_trace)
        exp = dict(rep["explain"], replayed=True,
                   from_step=int(ckpt.steps),
                   fingerprint=rep["fingerprint"])
        if "trace_path" in rep:
            exp["trace_path"] = rep["trace_path"]
        if not exp["truncated"]:
            return exp
        if best is None or len(exp["chain"]) > len(best["chain"]):
            best = exp           # the root precedes this checkpoint
    if not any_ckpt:
        raise ValueError(
            f"no harvested checkpoint covers lane {lane} before its "
            f"crash at step {crash_step} — run with ckpt_every=..., or "
            "replay the (seed, knobs) handle via full_chain_replay "
            "(t=0 is always a checkpoint when the handle is known)")
    return best                  # still truncated at the oldest


# ---------------------------------------------------------------------------
# divergence microscope
# ---------------------------------------------------------------------------

_TOKEN_KEYS = ("kind", "node", "src", "tag")


def _pair_state(prt, seed_a, seed_b, knobs_b, nudge_b):
    """Lanes A and B of a fresh `init_batch` (the knob write works in
    place, so it always gets a fresh state)."""
    seeds = np.asarray(
        [seed_a, seed_b if seed_b is not None else seed_a], np.uint32)
    st = prt.init_batch(seeds)
    if knobs_b is not None:
        from ..interop import knobs_to_numpy
        from ..search.mutate import KnobPlan
        kb = knobs_to_numpy(knobs_b)
        plan = KnobPlan.from_runtime(
            prt, dup_slots=len(np.atleast_1d(kb["dup_src"])))
        st = plan.apply(st, KnobPlan.stack([plan.base_knobs(), kb]))
    if nudge_b is not None:
        from ..search.pct import with_prio_nudge
        base = int(_lane_value(st.prio_nudge, 0))
        st = with_prio_nudge(st, np.asarray([base, int(nudge_b)], np.int32))
    return st


def _ring_token_rows(recs: dict) -> list[tuple]:
    cols = [np.asarray(recs[k]) for k in _TOKEN_KEYS]
    return [tuple(int(c[i]) for c in cols) for i in range(len(cols[0]))]


def _rec_row(recs: dict, i: int) -> dict:
    keys = ("step", "now", "kind", "node", "src", "tag", "parent",
            "lamport")
    return {k: int(np.asarray(recs[k])[i]) for k in keys if k in recs}


def export_pair_trace(path: str, state_a, state_b,
                      names=("lane_a", "lane_b")) -> int:
    """One Perfetto document with both lanes' tracks (lane A as pid 0,
    lane B as pid 1), each with its node tracks, flow arrows and instant
    args. Returns the number of instant events."""
    docs = []
    for pid, (st, name) in enumerate(zip((state_a, state_b), names)):
        evs = to_chrome_events(ring_records(st, 0))
        body = _doc(evs, None, None)["traceEvents"]
        for e in body:
            e["pid"] = pid
            # flows bind by (cat, id) across the whole document: the two
            # lanes' step-keyed ids are namespaced by pid
            if "id" in e:
                e["id"] = (pid << 32) | int(e["id"])
        docs.append(dict(name="process_name", ph="M", pid=pid,
                         args=dict(name=name)))
        docs.extend(body)
    with open(path, "w") as f:
        json.dump(dict(traceEvents=docs, displayTimeUnit="ms"), f)
    return sum(1 for e in docs if e.get("ph") == "i")


def divergence_report(rt, seed_a: int, seed_b: int | None = None, *,
                      knobs_b: dict | None = None,
                      nudge_b: int | None = None,
                      max_steps: int = 20_000, chunk: int = 512,
                      sketch_slots: int = 64, window_pad: int = 8,
                      suffix: int = 16,
                      export_trace: str | None = None) -> dict:
    """The divergence microscope: name two lanes' first divergent
    dispatch.

    Lane A runs `seed_a`; lane B `seed_b`, or `seed_a` under `knobs_b`
    (a fuzz mutant's knob vector) and/or `nudge_b` (a PCT tie-break).
      1. Probe: run the pair on a sketch build (derived when `rt` lacks
         one); `sketch_divergence` bounds the first divergent schedule
         slot (`bound="sketch-slot"`), or the whole run when no recorded
         slot differs (`bound="exhausted"`).
      2. Replay the window: advance a fresh pair exactly to the window
         start (the last common checkpoint), checkpoint both lanes,
         re-seed each into a big-ring build and run the window traced.
      3. Diff: the first ring index where the lanes' dispatch tokens
         (kind, node, src, tag) differ, with both sides' records,
         `suffix` records of each side, and (optionally) a two-track
         Perfetto export.
    The same pair gives the same report, dispatch for dispatch."""
    if seed_b is None and knobs_b is None and nudge_b is None:
        raise ValueError("nothing to diverge: pass seed_b, knobs_b "
                         "and/or nudge_b")
    prt = rt if rt.cfg.sketch_slots > 0 else rt.derived(
        sketch_slots=int(sketch_slots))
    st = prt.run_fused(_pair_state(prt, seed_a, seed_b, knobs_b, nudge_b),
                       max_steps, chunk)
    fps = prt.fingerprints(st)
    verdicts = (_verdict_of(st, 0), _verdict_of(st, 1))
    probe = causal.sketch_divergence(st, 0, 1)
    every = probe["every"]
    steps_ab = st.steps.cpu().numpy().reshape(-1)
    diverged = (int(fps[0]) != int(fps[1])
                or probe["bound"] == "sketch-slot"
                or verdicts[0] != verdicts[1])
    out = dict(diverged=bool(diverged), probe=probe,
               fingerprints=(int(fps[0]), int(fps[1])),
               verdicts=verdicts,
               steps=(int(steps_ab[0]), int(steps_ab[1])))
    if not diverged:
        return out
    if probe["bound"] == "sketch-slot":
        window_start = probe["slot"] * every
        window_len = every + int(window_pad)
    else:
        window_start = 0
        window_len = int(min(max_steps, max(steps_ab))) + int(window_pad)
    # 2. window replay from the last common checkpoint, full tracing
    st2 = _pair_state(prt, seed_a, seed_b, knobs_b, nudge_b)
    if window_start:
        st2 = advance_exact(prt, st2, window_start, chunk)
    sig = prt.cfg.structural_signature()
    ck_a = checkpoint_lane(st2, 0, signature=sig)
    ck_b = checkpoint_lane(st2, 1, signature=sig)
    trt = prt.derived(trace_cap=max(16, window_len))
    sa = advance_exact(
        trt, seed_batch_from(ck_a, 1, rt=trt, reset_planes=("ring",)),
        window_len, chunk)
    sb = advance_exact(
        trt, seed_batch_from(ck_b, 1, rt=trt, reset_planes=("ring",)),
        window_len, chunk)
    ra, rb = ring_records(sa, 0), ring_records(sb, 0)
    ta, tb = _ring_token_rows(ra), _ring_token_rows(rb)
    n = min(len(ta), len(tb))
    first = None
    for i in range(n):
        if ta[i] != tb[i]:
            first = dict(index=i, step=int(np.asarray(ra["step"])[i]),
                         a=_rec_row(ra, i), b=_rec_row(rb, i),
                         kind="dispatch")
            break
    if first is None and len(ta) != len(tb):
        # the schedules agree through the shorter window: the divergence
        # is one lane halting while the other dispatches on
        i = n
        longer, recs = ("a", ra) if len(ta) > len(tb) else ("b", rb)
        first = dict(index=i,
                     step=int(np.asarray(recs["step"])[i]),
                     a=_rec_row(ra, i) if longer == "a" else None,
                     b=_rec_row(rb, i) if longer == "b" else None,
                     kind="halt")
    lo = first["index"] if first is not None else 0
    out.update(
        window_start=int(ck_a.steps), window_len=int(window_len),
        bound=probe["bound"], slot=probe["slot"],
        first=first,
        suffix_a=[_rec_row(ra, i)
                  for i in range(lo, min(lo + int(suffix), len(ta)))],
        suffix_b=[_rec_row(rb, i)
                  for i in range(lo, min(lo + int(suffix), len(tb)))])
    if export_trace is not None:
        export_pair_trace(export_trace, sa, sb)
        out["trace_path"] = export_trace
    return out
