"""The coverage-guided fuzz loop: mutate -> run -> evaluate, pipelined.

The counterpart of `madsim_tpu.search.fuzz`.
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

With `minimize=True` every harvested crash repro is shrunk to its
1-minimal fault rows (`harness.minimize.minimize_knobs`) into the
result's `minimized` table.

Durable campaigns (`corpus_dir=`): the corpus, the cross-round
consensus sketch and every crash repro live in a `service.CorpusStore`
directory, synced at round boundaries. A killed campaign resumes from
its last sync and, because everything between syncs is re-derived from
(restored rng state, restored corpus, deterministic seeds), converges
to exactly the run that was never killed. Crashed lanes are deduped
into causal-fingerprint buckets (service/buckets.py). The speculative
pipeline is off under a store: round r+1's parents must be scheduled
after round r's sync point, or the persisted rng state could not replay
the schedule draw.

The lineage-driven arm (`ldfi=`, search/ldfi.py): green lanes' success
supports are read off their rings (obs/support.py), and the last
`ldfi.frac` of every later round's batch runs knob vectors synthesized
to cut the supports' edges. It also runs the serial loop: round r+1's
synthesis needs round r's rings.
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


def _lat_fields(lat_brief: dict) -> dict:
    """The latency slice of a fuzz-round / metrics record
    (obs/metrics.py schema): one definition for both."""
    return dict(lat_p50=lat_brief["e2e_p50"],
                lat_p99=lat_brief["e2e_p99"],
                slo_miss=lat_brief["slo_miss"],
                slo_target=lat_brief.get("slo_target", 0))


def _env_verify_resume() -> bool:
    """Default of the run-twice resume guard when the caller passed None:
    MADSIM_FUZZ_VERIFY_RESUME=1 turns it on without touching call
    sites."""
    import os
    return os.environ.get("MADSIM_FUZZ_VERIFY_RESUME", "") not in ("", "0")


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
    seed, so a repro is the (seed, knobs) pair. Arguments as the JAX
    package's `fuzz` (dup_slots, havoc, fresh_frac, rng_seed, corpus,
    div_bonus, lat_bonus, burst_bonus; observer with `on_round` /
    `on_done`).

    Durable campaigns (corpus_dir is the switch):
      corpus_dir   a service.CorpusStore directory (created on first
                   use, signature-checked on reopen). `max_rounds` is
                   the CAMPAIGN total: a resumed call runs only the
                   remaining rounds. `distinct_schedules` then reports
                   the campaign's cumulative coverage as this worker
                   sees it.
      worker_id    this process's namespace: entry ids, seed space
                   (WORKER_SEED_STRIDE apart) and state/log file names.
      sync_every   rounds between durability points (1 = every round).
      verify_resume  run-twice guard (None reads
                   MADSIM_FUZZ_VERIFY_RESUME, default off) on the first
                   round after a resume: the round's (seeds, knobs)
                   batch runs again until two consecutive runs agree on
                   (hashes, crashed, codes, sketches, p99, burst); three
                   distinct results raise.

    ldfi: a `search.ldfi.LdfiConfig` turns on the lineage-driven arm
    (needs cfg.trace_cap > 0). Targeted lanes ride the LAST
    `ldfi.frac` of each post-bootstrap round; their admissions carry
    `origin="targeted"` in the store, bucket records an `origin`, round
    records and the worker state a `targeted_yield` count. ldfi=None is
    the plain fuzzer bit for bit, stores included.

    With a store or ldfi the result also carries `phase_s`, one dict a
    round of this call: its host seconds split into device (schedule,
    mutate, knob write and the run, through to the runner's return),
    harvest (the reads of the finished round), ldfi (synthesis and
    support extraction), buckets (fingerprints and bucket files) and
    store (the metrics row and the sync: entry files and the worker
    state). It is the one key of the result the JAX package's lacks.

    Returns a dict: seeds_run, rounds, distinct_schedules, new_per_round,
    saturated, crash_first_seed_by_code (bootstrap lanes only: seed-alone
    handles), crashes, crash_repros ({code: {seed, round, knobs,
    script}}), corpus_size, mutation_ops ({operator: times applied}),
    mutation_yield ({operator or "base": admissions}), corpus_energy;
    minimized with minimize=True; targeted ({supports,
    truncated_supports, lanes_run, admitted}) with ldfi; corpus_dir,
    rounds_done_total, buckets_opened and buckets_total with a store.
    """
    plan = KnobPlan.from_runtime(rt, dup_slots=dup_slots)
    pool = None
    targeted_total = 0
    targeted_yield_total = 0
    if ldfi is not None:
        if rt.cfg.trace_cap <= 0:
            raise ValueError(
                "fuzz(ldfi=...) needs the flight recorder compiled in "
                "(cfg.trace_cap > 0): support extraction walks lineage "
                "rings — there is nothing to aim without them")
        from ..obs.support import extract_support
        from .ldfi import SupportPool, synthesize
        pool = SupportPool()
    op_hist = np.zeros(N_MUT_OPS, np.int64)
    # cumulative coverage-yield attribution: admissions credited to the
    # admitted lane's last applied operator, "+1" slot = untouched lanes
    yield_hist = np.zeros(N_MUT_OPS + 1, np.int64)
    if verify_resume is None:
        verify_resume = _env_verify_resume()
    store = buckets = None
    round_start = 0
    dry = 0
    wall_prior = 0.0
    if corpus_dir is not None:
        from ..service.buckets import CrashBuckets
        from ..service.store import (CorpusStore, StoreMismatch,
                                     store_signature)
        store = CorpusStore(corpus_dir,
                            signature=store_signature(rt, plan))
        # a mesh-sharded group's shards own worker_id*shards+s: refuse a
        # namespace such a group's state already claims
        owner = store.claimed_namespaces().get(worker_id)
        if owner is not None and owner != f"worker w{worker_id}":
            raise StoreMismatch(
                f"worker namespace {worker_id} is already owned by "
                f"{owner} in this corpus dir — a mesh-sharded group's "
                "shards occupy worker_id*shards+s; pick a worker_id "
                "outside every group's range")
        buckets = CrashBuckets(store)
        # the triage plane reads the scenario row table without a Runtime
        store.write_triage_rows(plan)
        if corpus is None:
            corpus = store.load_corpus(
                plan, worker_id=worker_id, rng_seed=rng_seed,
                fresh_frac=fresh_frac,
                div_bonus=1.0 if div_bonus is None else div_bonus,
                lat_bonus=0.0 if lat_bonus is None else lat_bonus,
                burst_bonus=0.0 if burst_bonus is None else burst_bonus)
        else:
            if corpus.worker_id != worker_id:
                # a mismatched namespace would persist a worker state
                # whose entry order points at files sync never writes
                raise ValueError(
                    f"corpus.worker_id={corpus.worker_id} != "
                    f"fuzz(worker_id={worker_id}): a durable campaign's "
                    "corpus must mint ids in its worker's namespace "
                    "(build it with Corpus(..., worker_id=) or let "
                    "fuzz load it from the store)")
            corpus.track_evictions = True
        ws = store.load_worker_state(worker_id)
        round_start = int(ws.get("rounds_done", 0))
        dry = int(ws.get("dry", 0))
        wall_prior = float(ws.get("wall_s", 0.0))
        if ws.get("op_hist"):
            op_hist[:] = np.asarray(ws["op_hist"], np.int64)
        if ws.get("op_yield"):
            yield_hist[:] = np.asarray(ws["op_yield"], np.int64)
        if ws.get("targeted_yield") is not None and ldfi is not None:
            # the support pool is not persisted (a resumed campaign
            # harvests again); the cumulative admission count is
            targeted_yield_total = int(ws["targeted_yield"])
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
    # this round's host seconds by part (the result's `phase_s`)
    split = dict(device=0.0, harvest=0.0, ldfi=0.0, buckets=0.0, store=0.0)
    phases: list[dict] = []

    def run(seeds, knobs):
        state = plan.apply(rt.init_batch(seeds), knobs)
        if fused:
            return rt.run_fused(state, max_steps, chunk)
        return rt.run(state, max_steps, chunk)[0]

    def launch(r):
        """Schedule + mutate + launch one round without reading results."""
        t_launch = time.perf_counter()
        t_ldfi = 0.0
        lane0 = (base_seed + worker_id * WORKER_SEED_STRIDE
                 + r * batch) % (1 << 32)
        seeds = (np.arange(batch, dtype=np.uint64)
                 + np.uint64(lane0)).astype(np.uint32)
        targeted = np.zeros(batch, bool)
        if r == 0 or len(corpus) == 0:
            knobs = plan.base_batch(batch)
            ids = np.full(batch, -1, np.int64)
            hist = last_op = None
        else:
            parents, ids = corpus.schedule(batch)
            key = prng.fold_in(master, r)
            tvecs, tseeds = [], []
            if pool is not None and len(pool):
                t0 = time.perf_counter()
                tvecs, tseeds = synthesize(
                    plan, pool, min(batch, max(1, int(batch * ldfi.frac))),
                    max_cuts=ldfi.max_cuts, lead=ldfi.lead,
                    rank_cap=ldfi.rank_cap, with_seeds=True)
                t_ldfi = time.perf_counter() - t0
            if tvecs:
                # the lineage arm: targeted vectors ride the LAST T lanes.
                # The masked havoc kernel passes those lanes' parents
                # through (the histogram and last-op count only real
                # mutants); the synthesized rows then replace them on
                # the host, and the knob-write kernel bounds-checks them
                # like any mutant
                tn = len(tvecs)
                mask = np.ones(batch, bool)
                mask[batch - tn:] = False
                knobs, hist, last_op = plan.mutate_masked(
                    parents, key, mask, havoc=havoc)
                knobs = {k: np.array(v)
                         for k, v in knobs_to_numpy(knobs).items()}
                tb = KnobPlan.stack(tvecs)
                for k in knobs:
                    knobs[k][batch - tn:] = tb[k]
                ids = ids.copy()
                ids[batch - tn:] = -1     # no havoc parent to reward
                targeted[batch - tn:] = True
                # pin each targeted lane to the green seed its cut was
                # aimed at: edge instants are seed-specific
                for j, ts_seed in enumerate(tseeds):
                    if ts_seed is not None:
                        seeds[batch - tn + j] = np.uint32(ts_seed)
            else:
                knobs, hist, last_op = plan.mutate(parents, key,
                                                   havoc=havoc)
        state = run(seeds, knobs)
        split["ldfi"] += t_ldfi
        split["device"] += time.perf_counter() - t_launch - t_ldfi
        return seeds, ids, knobs, hist, last_op, targeted, state

    def harvest(launched):
        """Read one round: the [B] hash and crash lanes and the knob batch
        (the corpus needs per-lane attribution)."""
        t0 = time.perf_counter()
        seeds, ids, knobs, hist, last_op, targeted, state = launched
        knobs_host = knobs_to_numpy(knobs)
        hashes = stats.sched_hash_u64(state)
        sk = state.cov_sketch
        sketches = (sk.cpu().numpy().view(np.uint32)
                    if sk.ndim == 2 and sk.shape[1] > 0 else None)
        lat_p99 = stats.lane_e2e_p99(state)
        lat_brief = (stats.latency_brief(state)
                     if lat_p99 is not None
                     and (observer is not None or store is not None)
                     else None)
        burst = stats.lane_burst(state)
        if hist is not None:
            op_hist[:] += hist.cpu().numpy()
            last_op = last_op.cpu().numpy()
        else:
            last_op = np.full(len(seeds), -1, np.int64)
        out = (seeds, ids, knobs_host, hashes, state.crashed.cpu().numpy(),
               state.crash_code.cpu().numpy(), hist is not None, last_op,
               sketches, state, lat_p99, lat_brief, burst, targeted)
        split["harvest"] += time.perf_counter() - t0
        return out

    def verified(harvested):
        """The run-twice resume guard: the SAME (seeds, knobs) batch runs
        again until two consecutive runs agree on the outputs the
        campaign keeps (parallel.stats._agree_twice)."""
        from ..parallel.stats import _agree_twice

        def key_of(h):
            hashes, crashed, codes, sketches, lat_p99, burst = \
                h[3], h[4], h[5], h[8], h[10], h[12]
            return (hashes.tobytes(), crashed.tobytes(), codes.tobytes(),
                    None if sketches is None else sketches.tobytes(),
                    None if lat_p99 is None else lat_p99.tobytes(),
                    None if burst is None else burst.tobytes())

        def again():
            seeds, ids, knobs_host = harvested[:3]
            mutated, last_op = harvested[6], harvested[7]
            state = run(seeds, knobs_host)
            h = harvest((seeds, ids, knobs_host, None, None,
                         harvested[13], state))
            # the replay re-applies the same knobs: the first run's
            # operator attribution stands
            return h[:6] + (mutated, last_op) + h[8:]

        return _agree_twice(harvested, again, key_of,
                            what="first post-resume campaign round")

    # under a durable store, `seen` starts at the campaign's cumulative
    # coverage (this worker's view)
    seen: set[int] = corpus.coverage_keys() if store is not None else set()
    crashes: dict[int, int] = {}
    repros: dict[int, dict] = {}
    opened_buckets: list[str] = []
    n_crashed = 0
    new_per_round: list[int] = []
    rounds = 0
    # a durable campaign schedules round r+1 after round r's sync point,
    # and the lineage arm synthesizes it from round r's rings: both run
    # the serial loop
    speculate = pipeline and fused and store is None and ldfi is None
    t0 = time.perf_counter()
    pending = (launch(round_start)
               if round_start < max_rounds and dry < dry_rounds else None)
    verify_round = (round_start if verify_resume and store is not None
                    and round_start > 0 else None)
    for r in range(round_start, max_rounds):
        if pending is None:
            break
        nxt = (launch(r + 1) if speculate and r + 1 < max_rounds else None)
        harvested = harvest(pending)
        if r == verify_round:
            harvested = verified(harvested)
        (seeds, ids, knobs_host, hashes, crashed, codes, mutated,
         last_op, sketches, state, lat_p99, lat_brief, burst,
         targeted) = harvested
        rounds += 1
        cstats = corpus.observe(knobs_host, seeds, hashes, crashed, codes,
                                ids, r, sketches=sketches,
                                last_op=last_op, lat_p99=lat_p99,
                                burst=burst,
                                origin=targeted if ldfi is not None
                                else None)
        yield_hist[:] += cstats["op_yield"]
        if ldfi is not None:
            t_sup = time.perf_counter()
            targeted_total += int(targeted.sum())
            targeted_yield_total += int(cstats.get("targeted_yield", 0))
            # harvest green supports: UNMUTATED lanes (bootstrap or havoc
            # no-ops, not targeted) that did not crash, until the pool
            # holds ldfi.lanes supports
            for i in range(len(seeds)):
                if len(pool) >= ldfi.lanes:
                    break
                if (bool(crashed[i]) or int(last_op[i]) >= 0
                        or bool(targeted[i])):
                    continue
                sup = extract_support(
                    state, int(i), witness=ldfi.witness,
                    replay=ldfi.replay, rt=rt, seed=int(seeds[i]),
                    knobs=KnobPlan.lane(knobs_host, int(i)))
                if sup is not None:
                    pool.add(sup, seed=int(seeds[i]))
            split["ldfi"] += time.perf_counter() - t_sup
        for i in np.nonzero(crashed)[0]:
            c = int(codes[i])
            if not mutated:     # seed-alone handles: bootstrap lanes only
                crashes.setdefault(c, int(seeds[i]))
            if c not in repros:
                kn = KnobPlan.lane(knobs_host, int(i))
                repros[c] = dict(seed=int(seeds[i]), round=r, knobs=kn,
                                 script=plan.to_scenario(kn).describe())
        if buckets is not None and crashed.any():
            # one representative lane per distinct (crash code, origin)
            # per round: the chain walk is a host read per lane. The
            # origin axis lets targeted lanes (the batch tail) open the
            # buckets they earned
            t_b = time.perf_counter()
            coded: set[tuple] = set()
            for i in np.nonzero(crashed)[0]:
                c = (int(codes[i]),
                     bool(targeted[int(i)]) if ldfi is not None else False)
                if c in coded:
                    continue
                coded.add(c)
                key, opened = buckets.observe_lane(
                    state, int(i), seed=int(seeds[i]),
                    knobs=KnobPlan.lane(knobs_host, int(i)),
                    round_no=r, worker_id=worker_id,
                    last_op=int(last_op[int(i)]),
                    origin=(("targeted" if targeted[int(i)] else "havoc")
                            if ldfi is not None else None))
                if opened:
                    opened_buckets.append(key)
            split["buckets"] += time.perf_counter() - t_b
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
            if ldfi is not None:
                # the lineage arm's round ledger
                rec.update(targeted=int(targeted.sum()),
                           targeted_yield=int(
                               cstats.get("targeted_yield", 0)),
                           support_pool=len(pool))
            if lat_brief is not None:
                rec.update(_lat_fields(lat_brief))
            if buckets is not None:
                rec["buckets_opened"] = len(opened_buckets)
            if sketches is not None:
                rec["div_slot_p50"] = int(np.median(
                    stats.first_divergence_slots(sketches)))
            observer.on_round(rec)
        if store is not None and (
                (r + 1 - round_start) % sync_every == 0
                or dry >= dry_rounds or r + 1 == max_rounds):
            # the durability point: after observe/buckets, BEFORE the
            # next round's schedule draw. The timeline row goes first: a
            # kill between the two re-runs the round and re-appends an
            # identical row (deduped by rounds_done in campaign_timeline)
            t_s = time.perf_counter()
            wall_now = wall_prior + time.perf_counter() - t0
            mrow = dict(
                t=time.time(), worker=worker_id, rounds_done=r + 1,
                coverage=len(seen), seeds_run=(r + 1) * batch,
                crashes=n_crashed, corpus_size=len(corpus),
                dry=dry, wall_s=round(wall_now, 3),
                op_yield=[int(x) for x in yield_hist])
            if ldfi is not None:
                mrow["targeted_yield"] = targeted_yield_total
            if lat_brief is not None:
                mrow.update(_lat_fields(lat_brief))
            store.append_metrics(worker_id, mrow)
            store.sync(corpus, worker_id, rounds_done=r + 1, dry=dry,
                       op_hist=op_hist, op_yield=yield_hist,
                       wall_s=wall_now,
                       targeted_yield=(targeted_yield_total
                                       if ldfi is not None else None))
            split["store"] += time.perf_counter() - t_s
        phases.append(dict(split))
        for k in split:
            split[k] = 0.0
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
    if ldfi is not None:
        result["targeted"] = dict(
            supports=len(pool), truncated_supports=pool.truncated,
            lanes_run=targeted_total, admitted=targeted_yield_total)
    if store is not None or ldfi is not None:
        result["phase_s"] = phases
    if store is not None:
        result.update(
            corpus_dir=store.dir,
            rounds_done_total=round_start + rounds,
            buckets_opened=opened_buckets,
            buckets_total=len(store.bucket_keys()))
    if minimize and repros:
        from ..harness.minimize import minimize_knobs
        result["minimized"] = {}
        for c, rep in repros.items():
            try:
                minimal, info = minimize_knobs(rt, plan, rep["knobs"],
                                               rep["seed"], max_steps,
                                               chunk)
                result["minimized"][c] = dict(info, knobs=minimal)
            except Exception as e:  # noqa: BLE001 - repro handle still stands
                result["minimized"][c] = dict(error=f"{type(e).__name__}: {e}")
        if buckets is not None:
            # attach the shrunk fault script to the buckets this run
            # opened (matched by crash code); the bucket's canonical
            # (seed, knobs) repro stays
            for key in buckets.new_keys:
                rec_b = store.load_bucket(key)
                mini = result["minimized"].get(int(rec_b["crash_code"]))
                if mini and "script" in mini:
                    rec_b["minimized"] = {
                        k: v for k, v in mini.items() if k != "knobs"}
                    store.write_bucket(key, rec_b)
    if observer is not None:
        observer.on_done(dict(
            kind="done", distinct_total=len(seen),
            wall_s=time.perf_counter() - t0,
            **{k: v for k, v in result.items()
               if k not in ("crash_repros", "minimized")}))
    return result
