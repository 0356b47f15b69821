"""Chaos-script minimization: shrink a failing scenario to a minimal repro.

(The counterpart of `madsim_tpu.harness.minimize`, the whole module: the
batched ddmin, its serial fall-back with the same `mode` strings, and
the fuzzer hand-off `minimize_knobs`. Every candidate run goes through
`Runtime.run_fused`, bit-equal to `run` (on CUDA the replayed graph, the
counterpart of the JAX package's compiled chunk runner; on the CPU `run`
itself). The slot mask of a candidate batch is initial-state data,
written with plain `torch.where`.)

A failing seed from a fuzz sweep comes with the whole chaos script that
produced it — rolling kills, partitions, latency flips — most of which is
noise. This ddmin-style pass deletes scenario rows while the SAME seed
still crashes with the SAME code, converging to a 1-minimal script: every
remaining row is load-bearing (dropping any one of them makes the crash
vanish). The reference has nothing like this; its repro is "same seed,
same code, same config hash" with the full test body
(madsim-macros/src/lib.rs:188-190).

Batched by default (r9): a deletion candidate is initial-state data — a
freed event-table slot — so ALL candidates of a ddmin round run as ONE
batched dispatch (lane i = script minus row i) instead of one single-lane
run each. The mask-domain evaluation keeps surviving rows at their
original slots; since slot layout can shift tie-breaks, the final minimal
script is re-verified through `set_scenario` (the layout the returned
Scenario actually implies), with an automatic fall-back to the serial
row-by-row pass in the rare case the verification misses.

`minimize_knobs` is the same engine over a fuzzer knob vector
(search/mutate.py): items are the enabled scenario rows AND dup slots, the
scalar knobs (loss/latency/jitter/prio_nudge) are held fixed, and
candidate evaluation + final repro live in one domain, so no verification
gap exists there at all.
"""

from __future__ import annotations

import numpy as np
import torch

from ..interop import knobs_to_numpy
from ..runtime.scenario import Scenario


def _pow2(n: int) -> int:
    return 1 << max(0, int(n) - 1).bit_length() if n > 1 else 1


def _crash_code(rt, seed: int, max_steps: int, chunk: int):
    """-> crash code of the single-lane run, or None if it didn't crash."""
    state = rt.run_fused(rt.init_single(seed), max_steps, chunk)
    if not bool(state.crashed.any()):
        return None
    return int(state.crash_code.reshape(-1)[0])


def ddmin_mask(n_items: int, pinned: np.ndarray, test_batch) -> tuple:
    """Greedy batched ddmin over a keep-mask.

    `test_batch(masks: bool[K, n_items]) -> ok: bool[K]` evaluates K
    candidate masks in one batched dispatch (ok = the crash still
    reproduces). Each round: one dispatch tests every single-item
    deletion from the current mask; when several items are individually
    droppable, a second dispatch tests the NESTED PREFIX UNIONS of that
    set and accepts the largest prefix that still reproduces (prefix 1
    is a re-run of a known-good single deletion, so progress is
    guaranteed every round). Dispatch count is O(rounds) — typically a
    handful — not O(items x passes) like the serial row-by-row loop.
    Returns (mask, dispatches)."""
    mask = np.ones(n_items, bool)
    dispatches = 0
    while True:
        cand = np.nonzero(mask & ~pinned)[0]
        if cand.size == 0:
            break
        masks = np.repeat(mask[None], cand.size, axis=0)
        masks[np.arange(cand.size), cand] = False
        ok = np.asarray(test_batch(masks))
        dispatches += 1
        drop = cand[ok[:cand.size]]
        if drop.size == 0:
            break                                   # 1-minimal
        if drop.size == 1:
            mask[drop[0]] = False
            continue
        prefixes = np.repeat(mask[None], drop.size, axis=0)
        for j in range(drop.size):
            prefixes[j:, drop[j]] = False           # row j: drop[:j+1] off
        okp = np.asarray(test_batch(prefixes))[:drop.size]
        dispatches += 1
        best = int(np.max(np.nonzero(okp)[0], initial=0)) + 1
        mask[drop[:best]] = False
    return mask, dispatches


def _scenario_test_batch(rt, seed: int, max_steps: int, chunk: int,
                         code: int, W: int):
    """Mask-domain candidate evaluator: lane j runs `seed` with the
    scenario slots of mask j's False rows freed (EV_FREE / T_INF) —
    surviving rows KEEP their template slots. One `init_batch` + one
    batched run per call."""
    from ..core import types as T
    n_init = rt.cfg.n_nodes
    R = len(rt.scenario.rows)
    C = rt.cfg.event_capacity

    def test(masks: np.ndarray) -> np.ndarray:
        K = masks.shape[0]
        keep = np.ones((W, C), bool)
        keep[:K, n_init:n_init + R] = masks
        state = rt.init_batch(np.full(W, seed, np.uint32))
        kf = torch.as_tensor(keep, device=state.t_kind.device)
        state = state.replace(
            t_kind=torch.where(kf, state.t_kind,
                               torch.tensor(T.EV_FREE,
                                            dtype=state.t_kind.dtype,
                                            device=kf.device)),
            t_deadline=torch.where(kf, state.t_deadline,
                                   torch.tensor(T.T_INF, dtype=torch.int32,
                                                device=kf.device)))
        state = rt.run_fused(state, max_steps, chunk)
        crashed = state.crashed.cpu().numpy()
        codes = state.crash_code.cpu().numpy()
        return (crashed & (codes == code))[:K]

    return test


def minimize_scenario(rt, seed: int, max_steps: int, chunk: int = 512,
                      batched: bool = True):
    """Shrink `rt.scenario` to a 1-minimal script that still crashes
    `seed` with the original crash code.

    Returns (minimal: Scenario, info: dict) and leaves `rt` restored to
    its original scenario. info carries kept/dropped row counts, `runs`
    (device dispatches executed — for the batched path each one evaluates
    a whole candidate round), the crash code, and `mode`
    ("batched" / "serial" / "batched+serial_fallback").

    `batched=False` forces the pre-r9 serial loop (one single-lane run per
    candidate row) — kept as the reference the batched path's test
    measures its dispatch-count drop against."""
    from ..core import types as T

    original = rt.scenario
    code = _crash_code(rt, seed, max_steps, chunk)
    if code is None:
        raise ValueError(
            f"seed {seed} does not crash under the full scenario — "
            f"nothing to minimize")
    runs = 1

    if batched:
        rows = list(original.rows)
        R = len(rows)
        # OP_INIT is pinned alongside OP_HALT: in the mask domain "off"
        # means the boot never fires (node absent forever), while deleting
        # the row from a Scenario means the node boots at t=0 — mask
        # acceptance would diverge from set_scenario semantics (the same
        # template-bookkeeping reason search/mutate.py pins INIT rows)
        pinned = np.asarray([r.op in (T.OP_HALT, T.OP_INIT) for r in rows])
        # one fixed lane width for the whole pass (padded, power of two):
        # every round reuses a single compiled batch shape
        W = _pow2(max(R, 1))
        test = _scenario_test_batch(rt, seed, max_steps, chunk, code, W)
        mask, dispatches = ddmin_mask(R, pinned, test)
        runs += dispatches
        minimal = Scenario()
        minimal.rows = [r for i, r in enumerate(rows) if mask[i]]
        # the returned Scenario implies a REPACKED slot layout; verify the
        # crash survives it (tie-breaks can shift with slot positions)
        try:
            rt.set_scenario(minimal)
            runs += 1
            verified = _crash_code(rt, seed, max_steps, chunk) == code
        finally:
            rt.set_scenario(original)
        if verified:
            return minimal, dict(
                kept=len(minimal.rows),
                dropped=len(rows) - len(minimal.rows),
                runs=runs, crash_code=code, mode="batched")
        # rare: mask-domain acceptance doesn't survive repacking — redo
        # serially (which evaluates candidates in the repacked layout)
        minimal, info = _minimize_serial(rt, seed, max_steps, chunk, code)
        info["runs"] += runs
        info["mode"] = "batched+serial_fallback"
        return minimal, info

    minimal, info = _minimize_serial(rt, seed, max_steps, chunk, code)
    info["runs"] += runs
    return minimal, info


def _minimize_serial(rt, seed: int, max_steps: int, chunk: int, code: int):
    """The pre-r9 loop: greedy 1-minimal pass to fixpoint, one single-lane
    run per candidate deletion, candidates evaluated through
    `set_scenario` (so acceptance and the returned script share one slot
    layout). HALT rows are pinned: set_scenario would re-add one, so
    "deleting" a user HALT would silently test a longer horizon."""
    from ..core import types as T

    original = rt.scenario
    rows = list(original.rows)
    runs = 0
    try:
        changed = True
        while changed:
            changed = False
            i = 0
            while i < len(rows):
                if rows[i].op == T.OP_HALT:
                    i += 1
                    continue
                cand = Scenario()
                cand.rows = rows[:i] + rows[i + 1:]
                rt.set_scenario(cand)
                runs += 1
                if _crash_code(rt, seed, max_steps, chunk) == code:
                    rows = cand.rows         # row i was noise
                    changed = True
                else:
                    i += 1                   # row i is load-bearing
    finally:
        rt.set_scenario(original)
    minimal = Scenario()
    minimal.rows = rows
    return minimal, dict(
        kept=len(rows), dropped=len(original.rows) - len(rows),
        runs=runs, crash_code=code, mode="serial")


# ---------------------------------------------------------------------------
# knob-domain shrinking (the fuzzer hand-off, search/fuzz.py)
# ---------------------------------------------------------------------------


def minimize_knobs(rt, plan, knobs: dict, seed: int, max_steps: int,
                   chunk: int = 512):
    """Shrink a fuzzer knob vector's FAULT ROWS to a 1-minimal set that
    still crashes `seed` with the same code: items are the enabled
    droppable scenario rows plus enabled dup slots; the scalar knobs
    (loss/latency/jitter/prio_nudge) are held fixed — they are part of the
    repro, not candidates for deletion. Candidate evaluation, the
    returned knob vector, and its replay all live in the SAME apply-knobs
    domain, so there is no slot-layout verification gap.

    Returns (minimal_knobs, info) with info carrying kept/dropped counts,
    `runs` (batched dispatches), the crash code, and a human-readable
    `script` rendering of the minimal fault schedule.

    Every candidate batch is a fresh `init_batch`: `KnobPlan.apply`
    writes the state's event table in place (ROADMAP F14)."""
    kn0 = {k: np.array(v) for k, v in knobs_to_numpy(knobs).items()}
    R, D = plan.R, plan.D

    def run_masks(masks: np.ndarray):
        """masks bool[K, R+D] -> ok bool[K]; one batched dispatch."""
        K = masks.shape[0]
        W = _pow2(max(R + D, 1))
        variants = []
        for j in range(W):
            kn = {k: v.copy() for k, v in kn0.items()}
            m = masks[min(j, K - 1)]
            kn["row_on"] = kn0["row_on"] & m[:R]
            if D:
                kn["dup_on"] = kn0["dup_on"] & m[R:]
            variants.append(kn)
        batch = plan.stack(variants)
        state = plan.apply(rt.init_batch(np.full(W, seed, np.uint32)),
                           batch)
        state = rt.run_fused(state, max_steps, chunk)
        return (state.crashed.cpu().numpy()
                & (state.crash_code.cpu().numpy() == code))[:K]

    # target code from the UNSHRUNK knobs (one width-W dispatch keeps a
    # single compiled batch shape for the whole pass)
    state = plan.apply(rt.init_batch(np.full(_pow2(max(R + D, 1)), seed,
                                             np.uint32)),
                       plan.stack([kn0] * _pow2(max(R + D, 1))))
    state = rt.run_fused(state, max_steps, chunk)
    if not bool(state.crashed[0]):
        raise ValueError(
            f"seed {seed} does not crash under the given knobs — "
            f"nothing to minimize")
    code = int(state.crash_code[0])
    runs = 1

    on0 = np.concatenate([kn0["row_on"],
                          kn0["dup_on"] if D else np.zeros(0, bool)])
    pinned = np.concatenate([~plan.drop_ok, np.zeros(D, bool)]) | ~on0
    mask, dispatches = ddmin_mask(R + D, pinned, run_masks)
    runs += dispatches
    mask &= on0
    minimal = {k: v.copy() for k, v in kn0.items()}
    minimal["row_on"] = kn0["row_on"] & mask[:R]
    if D:
        minimal["dup_on"] = kn0["dup_on"] & mask[R:]
    kept = int(mask[:R].sum() + (mask[R:].sum() if D else 0))
    return minimal, dict(
        kept=kept, dropped=int(on0.sum()) - kept, runs=runs,
        crash_code=code,
        script=plan.to_scenario(minimal).describe())
