"""The coverage-guided fuzz loop: mutate -> run -> evaluate, pipelined.

The counterpart of `madsim_tpu.search.fuzz` on its in-memory path.
`explore()` samples the schedule space blindly; this driver SEARCHES it:
every round schedules parents from the corpus (energy-weighted), derives
a batch of mutants on the device (the havoc kernel, search/mutate.py),
writes them into the init state (the knob-write kernel), runs the batch
as one sweep, and admits lanes that reached a never-seen `sched_hash`
back into the corpus. The sweep stops when `dry_rounds` consecutive
rounds add no new schedule.

With `pipeline=True` (and the fused runner) round r+1's mutate + init +
run is launched before the host reads round r, at the price of one round
of corpus staleness (round r+1's parents come from the corpus as of round
r-1); `pipeline=False` is the serial AFL loop. On CUDA `run_fused` reads
its all-halted flag one block late, so the launch returns with at most
one block still running, and the host's corpus work overlaps that block.

Crashes are harvested, never aborted on: every distinct crash code keeps
its first full repro handle (seed, knob vector).

Not ported yet, each refused with NotImplementedError: durable campaigns
(`corpus_dir=`, with `verify_resume`, `sync_every` and the crash buckets:
ROADMAP P14), the lineage-driven arm (`ldfi=`: ROADMAP P13, with
search/ldfi.py and obs/support.py) and crash-repro shrinking
(`minimize=True`: ROADMAP P8, harness/minimize.py).
"""

from __future__ import annotations

import time

import numpy as np

from ..core import prng
from ..interop import knobs_to_numpy
from ..parallel import stats
from .corpus import YIELD_NAMES, Corpus
from .mutate import N_MUT_OPS, OP_NAMES, KnobPlan

# seed-space stride between workers sharing a campaign: worker w's round
# r runs seeds [base + w*STRIDE + r*batch, ...) mod 2^32
WORKER_SEED_STRIDE = 1 << 26


def fuzz(rt, max_steps: int, batch: int = 512, max_rounds: int = 16,
         dry_rounds: int = 3, base_seed: int = 0, chunk: int = 512,
         pipeline: bool = True, fused: bool = True, dup_slots: int = 2,
         havoc: int = 3, fresh_frac: float = 0.125, rng_seed: int = 0,
         observer=None, minimize: bool = False, corpus: Corpus | None = None,
         div_bonus: float | None = None, lat_bonus: float | None = None,
         burst_bonus: float | None = None,
         corpus_dir: str | None = None,
         worker_id: int = 0, sync_every: int = 1,
         verify_resume: bool | None = None, ldfi=None):
    """Coverage-guided schedule fuzzing over `rt`'s dynamic fault knobs.

    Round 0 is a blind bootstrap (base knobs, fresh seeds) that seeds the
    corpus; later rounds run mutants (with the pipeline, from round 2:
    round 1 is launched before round 0 is read). Every lane gets a fresh
    seed, so a repro is the (seed, knobs) pair. Arguments as the JAX package's
    `fuzz` (dup_slots, havoc, fresh_frac, rng_seed, corpus, div_bonus,
    lat_bonus, burst_bonus, worker_id; observer with `on_round` /
    `on_done`). corpus_dir, ldfi and minimize=True raise
    NotImplementedError (see the module doc); sync_every and
    verify_resume act only on a durable store, as in the reference.

    Returns a dict: seeds_run, rounds, distinct_schedules, new_per_round,
    saturated, crash_first_seed_by_code (bootstrap lanes only: seed-alone
    handles), crashes, crash_repros ({code: {seed, round, knobs,
    script}}), corpus_size, mutation_ops ({operator: times applied}),
    mutation_yield ({operator or "base": admissions}), corpus_energy.
    """
    if corpus_dir is not None:
        raise NotImplementedError(
            "fuzz(corpus_dir=...): durable campaigns (service/store.py, "
            "verify_resume, crash buckets) are not ported to "
            "madsim_tpu_torch yet (ROADMAP P14)")
    if ldfi is not None:
        raise NotImplementedError(
            "fuzz(ldfi=...): lineage-driven fault injection (search/ldfi.py, "
            "obs/support.py) is not ported to madsim_tpu_torch yet "
            "(ROADMAP P13)")
    if minimize:
        raise NotImplementedError(
            "fuzz(minimize=True): crash-repro shrinking (harness/"
            "minimize.py) is not ported to madsim_tpu_torch yet "
            "(ROADMAP P8)")
    plan = KnobPlan.from_runtime(rt, dup_slots=dup_slots)
    op_hist = np.zeros(N_MUT_OPS, np.int64)
    # cumulative coverage-yield attribution: admissions credited to the
    # admitted lane's last applied operator, "+1" slot = untouched lanes
    yield_hist = np.zeros(N_MUT_OPS + 1, np.int64)
    if corpus is None:
        corpus = Corpus(plan, rng=np.random.default_rng(rng_seed),
                        fresh_frac=fresh_frac,
                        div_bonus=1.0 if div_bonus is None else div_bonus,
                        lat_bonus=0.0 if lat_bonus is None else lat_bonus,
                        burst_bonus=(0.0 if burst_bonus is None
                                     else burst_bonus))
    else:
        # an explicit bonus wins over a passed-in corpus's setting
        if div_bonus is not None:
            corpus.div_bonus = float(div_bonus)
        if lat_bonus is not None:
            corpus.lat_bonus = float(lat_bonus)
        if burst_bonus is not None:
            corpus.burst_bonus = float(burst_bonus)
    # the campaign's master key, jax's PRNGKey(uint32(rng_seed ^
    # 0x5EED5EED)), on the host: each round folds its number in
    master = prng.seed_key((int(rng_seed) ^ 0x5EED5EED) & prng.MASK32)

    def launch(r):
        """Schedule + mutate + launch one round without reading results."""
        lane0 = (base_seed + worker_id * WORKER_SEED_STRIDE
                 + r * batch) % (1 << 32)
        seeds = (np.arange(batch, dtype=np.uint64)
                 + np.uint64(lane0)).astype(np.uint32)
        if r == 0 or len(corpus) == 0:
            knobs = plan.base_batch(batch)
            ids = np.full(batch, -1, np.int64)
            hist = last_op = None
        else:
            parents, ids = corpus.schedule(batch)
            key = prng.fold_in(master, r)
            knobs, hist, last_op = plan.mutate(parents, key, havoc=havoc)
        state = plan.apply(rt.init_batch(seeds), knobs)
        if fused:
            state = rt.run_fused(state, max_steps, chunk)
        else:
            state, _ = rt.run(state, max_steps, chunk)
        return seeds, ids, knobs, hist, last_op, state

    def harvest(launched):
        """Read one round: the [B] hash and crash lanes and the knob batch
        (the corpus needs per-lane attribution)."""
        seeds, ids, knobs, hist, last_op, state = launched
        knobs_host = knobs_to_numpy(knobs)
        hashes = stats.sched_hash_u64(state)
        sk = state.cov_sketch
        sketches = (sk.cpu().numpy().view(np.uint32)
                    if sk.ndim == 2 and sk.shape[1] > 0 else None)
        lat_p99 = stats.lane_e2e_p99(state)
        lat_brief = (stats.latency_brief(state)
                     if lat_p99 is not None and observer is not None
                     else None)
        burst = stats.lane_burst(state)
        if hist is not None:
            op_hist[:] += hist.cpu().numpy()
            last_op = last_op.cpu().numpy()
        else:
            last_op = np.full(len(seeds), -1, np.int64)
        return (seeds, ids, knobs_host, hashes, state.crashed.cpu().numpy(),
                state.crash_code.cpu().numpy(), hist is not None, last_op,
                sketches, lat_p99, lat_brief, burst)

    seen: set[int] = set()
    crashes: dict[int, int] = {}
    repros: dict[int, dict] = {}
    n_crashed = 0
    new_per_round: list[int] = []
    rounds = 0
    dry = 0
    speculate = pipeline and fused
    t0 = time.perf_counter()
    pending = launch(0) if max_rounds > 0 and dry < dry_rounds else None
    for r in range(max_rounds):
        if pending is None:
            break
        nxt = (launch(r + 1) if speculate and r + 1 < max_rounds else None)
        (seeds, ids, knobs_host, hashes, crashed, codes, mutated, last_op,
         sketches, lat_p99, lat_brief, burst) = harvest(pending)
        rounds += 1
        cstats = corpus.observe(knobs_host, seeds, hashes, crashed, codes,
                                ids, r, sketches=sketches, last_op=last_op,
                                lat_p99=lat_p99, burst=burst)
        yield_hist[:] += cstats["op_yield"]
        for i in np.nonzero(crashed)[0]:
            c = int(codes[i])
            if not mutated:     # seed-alone handles: bootstrap lanes only
                crashes.setdefault(c, int(seeds[i]))
            if c not in repros:
                kn = KnobPlan.lane(knobs_host, int(i))
                repros[c] = dict(seed=int(seeds[i]), round=r, knobs=kn,
                                 script=plan.to_scenario(kn).describe())
        n_crashed += int(crashed.sum())
        fresh = set(hashes.tolist()) - seen
        seen |= fresh
        new_per_round.append(len(fresh))
        dry = dry + 1 if not fresh else 0
        if observer is not None:
            rec = dict(
                kind="fuzz_round", round=rounds, batch=batch,
                seeds_run=rounds * batch, new_schedules=len(fresh),
                distinct_total=len(seen), crashes=n_crashed,
                corpus_size=cstats["size"],
                new_crash_codes=cstats["new_crash_codes"],
                admitted=cstats["new"],
                op_yield={YIELD_NAMES[i]: int(cstats["op_yield"][i])
                          for i in range(len(YIELD_NAMES))},
                corpus_energy=corpus.energy_summary(),
                dry_rounds=dry, wall_s=time.perf_counter() - t0)
            if lat_brief is not None:
                rec.update(lat_p50=lat_brief["e2e_p50"],
                           lat_p99=lat_brief["e2e_p99"],
                           slo_miss=lat_brief["slo_miss"],
                           slo_target=lat_brief.get("slo_target", 0))
            if sketches is not None:
                rec["div_slot_p50"] = int(np.median(
                    stats.first_divergence_slots(sketches)))
            observer.on_round(rec)
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
        crash_repros=repros,
        corpus_size=len(corpus),
        mutation_ops={OP_NAMES[i]: int(op_hist[i])
                      for i in range(N_MUT_OPS)},
        mutation_yield={YIELD_NAMES[i]: int(yield_hist[i])
                        for i in range(len(YIELD_NAMES))},
        corpus_energy=corpus.energy_summary(),
    )
    if observer is not None:
        observer.on_done(dict(
            kind="done", distinct_total=len(seen),
            wall_s=time.perf_counter() - t0,
            **{k: v for k, v in result.items() if k != "crash_repros"}))
    return result
