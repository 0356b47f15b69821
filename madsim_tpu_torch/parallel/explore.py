"""Coverage-driven schedule exploration — loop-until-dry seed sweeps.

The counterpart of `madsim_tpu.parallel.explore`: sweep successive seed
batches and stop when `dry_rounds` consecutive rounds produce no schedule
(`SimState.sched_hash`) never seen before. Crashes do not abort the
sweep: every distinct crash code is collected with its first seed.

Each round is one `run_fused` sweep plus the on-device coverage
reduction (`parallel.stats.coverage_digest`, the kernel of
csrc/coverage.cu), queued on the device; with `pipeline=True` round r+1
is launched before the host reads round r's digest. On CUDA `run_fused`
replays a CUDA graph and reads the all-halted flag one block late, so the
launch itself returns with at most one block still running: the host's
dedup overlaps that block, not the whole round. `pipeline=False` gives
the same results in strictly serial order.
"""

from __future__ import annotations

import time

import numpy as np

from . import stats


def explore(rt, max_steps: int, batch: int = 512, max_rounds: int = 16,
            dry_rounds: int = 2, base_seed: int = 0, chunk: int = 512,
            pipeline: bool = True, fused: bool = True, observer=None):
    """Sweep seed batches until `dry_rounds` consecutive rounds add no new
    distinct schedule (or `max_rounds` is hit).

    Args beyond the sweep shape:
      pipeline: launch round r+1 before reading round r's results (only
        with fused=True: the chunked runner reads halted.all() every
        chunk, so a speculative round would run to its end inline).
      fused: drive each round with `Runtime.run_fused` instead of `run`.
      observer: optional object with `on_round(record)` (one per
        harvested round: new_schedules, distinct_total, crashes, ...) and
        `on_done(record)` with the final result.

    Returns a dict: seeds_run, rounds, distinct_schedules, new_per_round,
    saturated, crash_first_seed_by_code ({crash_code: first seed}),
    crashes (total crashed trajectories).
    """
    def launch(r):
        """Queue one round's init + run + coverage reduction."""
        seeds = np.arange(base_seed + r * batch,
                          base_seed + (r + 1) * batch, dtype=np.uint32)
        if fused:
            state = rt.run_fused(rt.init_batch(seeds), max_steps, chunk)
        else:
            state, _ = rt.run(rt.init_batch(seeds), max_steps, chunk)
        pairs, n = stats.coverage_digest(state)
        return seeds, state, pairs, n

    def harvest(launched):
        """Read one round's results: the n distinct hashes and the [B]
        crash lanes — never the full [B] hash array."""
        seeds, state, pairs, n = launched
        hashes = stats.digest_hashes(pairs, n)
        return (seeds, hashes, state.crashed.cpu().numpy(),
                state.crash_code.cpu().numpy())

    seen: set[int] = set()
    crashes: dict[int, int] = {}
    n_crashed = 0
    new_per_round: list[int] = []
    dry = 0
    rounds = 0
    speculate = pipeline and fused
    t0 = time.perf_counter()
    pending = launch(0) if max_rounds > 0 else None
    for r in range(max_rounds):
        nxt = (launch(r + 1) if speculate and r + 1 < max_rounds else None)
        seeds, hashes, crashed, codes = harvest(pending)
        for i in np.nonzero(crashed)[0]:
            crashes.setdefault(int(codes[i]), int(seeds[i]))
        n_crashed += int(crashed.sum())
        fresh = set(hashes.tolist()) - seen
        new = len(fresh)
        seen |= fresh
        new_per_round.append(new)
        rounds += 1
        dry = dry + 1 if new == 0 else 0
        if observer is not None:
            observer.on_round(dict(
                kind="round", round=rounds, batch=batch,
                seeds_run=rounds * batch, new_schedules=new,
                distinct_total=len(seen), crashes=n_crashed,
                dry_rounds=dry, wall_s=time.perf_counter() - t0))
        if dry >= dry_rounds:
            break
        pending = nxt if nxt is not None else (
            launch(r + 1) if r + 1 < max_rounds else None)
    result = dict(
        seeds_run=rounds * batch,
        rounds=rounds,
        distinct_schedules=len(seen),
        new_per_round=new_per_round,
        saturated=dry >= dry_rounds,
        crash_first_seed_by_code=crashes,
        crashes=n_crashed,
    )
    if observer is not None:
        observer.on_done(dict(
            kind="done", distinct_total=len(seen),
            wall_s=time.perf_counter() - t0, **result))
    return result
