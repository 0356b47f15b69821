"""The multi-process campaign driver: many cheap workers, one durable store.

The counterpart of `madsim_tpu.service.campaign`: host Python, the same names
and the same file bytes, so a store written by either package opens in
the other.

The CI-farm shape madsim users actually run (ROADMAP "production
traffic"): N worker processes fuzz the same runtime into one shared
corpus directory. Each worker owns its id's namespace (entry ids, seed
space, scheduler state), merges the others' coverage at its round syncs,
and dedups crashes into the shared causal-fingerprint buckets — the
Podracer split (PAPERS.md) of many actors over one store, where the
determinism core makes every merge safe by construction.

Workers are real OS processes (`python -m madsim_tpu_torch.service.worker`),
not threads: each holds its own CUDA context and loads the kernels
already built into `madsim_tpu_torch/_build/` (only the first worker of
a fresh checkout pays the nvcc builds). The driver here spawns them, polls the corpus dir
for campaign-level stats (kind="campaign" SweepObserver records:
uptime, schedules/s, buckets), and renders the merged report. Killing
a worker — SIGKILL included — loses at most its work since its last
round sync; relaunching the same worker id resumes it exactly
(search/fuzz.py durability contract).
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import time

import numpy as np

from .buckets import merged_buckets
from .store import CorpusStore


def worker_cmd(corpus_dir: str, worker_id: int, factory: str, *,
               factory_kwargs: dict | None = None, max_steps: int,
               batch: int = 64, max_rounds: int = 4, chunk: int = 256,
               dry_rounds: int | None = None, base_seed: int = 0,
               sync_every: int = 1, minimize: bool = False,
               shards: int = 1, verify_resume: bool = False,
               python: str = sys.executable) -> list[str]:
    """The argv for one campaign worker process. `factory` is a
    "module:function" spec resolved in the worker (the runtime itself
    is not picklable across processes — a factory is the contract).
    `shards` > 1 asks for a mesh-sharded campaign, which this package
    does not have yet (the worker refuses it); `verify_resume` arms the
    run-twice guard on its first post-resume round."""
    cmd = [python, "-m", "madsim_tpu_torch.service.worker",
           "--corpus-dir", corpus_dir,
           "--worker-id", str(worker_id),
           "--factory", factory,
           "--max-steps", str(max_steps),
           "--batch", str(batch),
           "--max-rounds", str(max_rounds),
           "--chunk", str(chunk),
           "--base-seed", str(base_seed),
           "--sync-every", str(sync_every)]
    if factory_kwargs:
        cmd += ["--factory-kwargs", json.dumps(factory_kwargs)]
    if dry_rounds is not None:
        cmd += ["--dry-rounds", str(dry_rounds)]
    if minimize:
        cmd += ["--minimize"]
    if shards != 1:
        cmd += ["--shards", str(shards)]
    if verify_resume:
        cmd += ["--verify-resume"]
    return cmd


def spawn_worker(corpus_dir: str, worker_id: int, factory: str,
                 env: dict | None = None, **kw) -> subprocess.Popen:
    """Launch one worker as its own process. `env` REPLACES the child
    environment when given; default inherits. The device is the
    factory's: pass `factory_kwargs={"device": "cpu"}` for a CPU
    worker. stdout carries the worker's final result as one JSON
    line."""
    e = dict(env) if env is not None else dict(os.environ)
    return subprocess.Popen(
        worker_cmd(corpus_dir, worker_id, factory, **kw), env=e,
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)


def campaign_stats(corpus_dir: str, *, uptime_s: float = 0.0,
                   workers: int = 0, workers_alive: int = 0,
                   round_no: int = 0, store: CorpusStore | None = None
                   ) -> dict:
    """One campaign-level rollup record off the shared dir (cheap scan;
    the poll loop's SweepObserver.on_round payload and the basis of the
    final report). Pass a long-lived `store` when polling — its
    immutable-entry hash cache keeps each poll O(new files). Wall time
    is the max over workers' own accounts — workers run concurrently,
    their walls overlap."""
    if store is None:
        store = CorpusStore(corpus_dir, create=False)
    coverage = store.coverage_keys()
    states = [store.load_worker_state(w) for w in store.worker_ids()]
    # mesh-sharded groups (r13) roll up next to plain workers: their
    # group json carries the same top-level rounds_done/wall_s
    states += [store.load_shard_group_state(g)
               for g in store.shard_group_ids()]
    wall = max([s.get("wall_s", 0.0) for s in states], default=0.0)
    rounds_done = sum(s.get("rounds_done", 0) for s in states)
    buckets = store.bucket_keys()
    # deduped by (fingerprint, worker, round): a resumed worker's
    # replayed round re-appends identical observation lines, which
    # inflated the rate curves (store.bucket_log_deduped)
    crash_obs = len(store.bucket_log_deduped())
    return dict(
        kind="campaign", round=round_no, uptime_s=round(uptime_s, 2),
        workers=workers, workers_alive=workers_alive,
        corpus_entries=len(store.entry_names()),
        coverage_keys=len(coverage),
        rounds_done=rounds_done,
        buckets=len(buckets),
        crash_observations=crash_obs,
        schedules_per_sec=round(len(coverage) / wall, 2) if wall else 0.0,
        buckets_per_min=round(60.0 * len(buckets) / wall, 3) if wall
        else 0.0,
        worker_wall_s=round(wall, 2))


def run_campaign(factory: str, corpus_dir: str, *, workers: int = 2,
                 max_steps: int, batch: int = 64, max_rounds: int = 4,
                 chunk: int = 256, factory_kwargs: dict | None = None,
                 base_seed: int = 0, sync_every: int = 1,
                 minimize: bool = False, shards: int = 1,
                 verify_resume: bool = False, observer=None,
                 env: dict | None = None, poll_s: float = 2.0,
                 python: str = sys.executable) -> dict:
    """Run one campaign segment: spawn `workers` processes on one corpus
    dir, poll campaign stats while they run, and return the merged
    report. Re-running with the same arguments RESUMES the campaign
    (each worker picks up at its rounds_done) — an always-on service is
    `supervise_campaign` (this call in a loop with a growing
    `max_rounds`, dead-worker restarts, and cold-entry pruning).
    `shards` > 1 asks for mesh-sharded workers, which this package does
    not have yet (each worker refuses it)."""
    t0 = time.monotonic()
    procs = {
        w: spawn_worker(corpus_dir, w, factory,
                        factory_kwargs=factory_kwargs, max_steps=max_steps,
                        batch=batch, max_rounds=max_rounds, chunk=chunk,
                        base_seed=base_seed, sync_every=sync_every,
                        minimize=minimize, shards=shards,
                        verify_resume=verify_resume, env=env, python=python)
        for w in range(workers)}
    results = {}
    poll = 0
    poll_store = None
    try:
        while any(p.poll() is None for p in procs.values()):
            time.sleep(poll_s)
            poll += 1
            if observer is not None and os.path.exists(
                    os.path.join(corpus_dir, "MANIFEST.json")):
                if poll_store is None:
                    poll_store = CorpusStore(corpus_dir, create=False)
                alive = sum(p.poll() is None for p in procs.values())
                observer.on_round(campaign_stats(
                    corpus_dir, uptime_s=time.monotonic() - t0,
                    workers=workers, workers_alive=alive, round_no=poll,
                    store=poll_store))
    except KeyboardInterrupt:
        # graceful stop: SIGTERM the workers, let their round finish is
        # not guaranteed — but the store contract means nothing past the
        # last sync is lost, and the next run_campaign resumes
        for p in procs.values():
            if p.poll() is None:
                p.send_signal(signal.SIGTERM)
        raise
    for w, p in procs.items():
        out, _ = p.communicate()
        line = (out or "").strip().splitlines()
        results[w] = dict(returncode=p.returncode,
                          result=json.loads(line[-1]) if line else None)
    return campaign_report(corpus_dir, uptime_s=time.monotonic() - t0,
                           workers=workers, worker_results=results)


def campaign_timeline(store: CorpusStore, stale_after: float = 3.0,
                      now: float | None = None) -> dict:
    """Fold the workers' durable `metrics/` rows (appended at every
    durability sync, fsync'd — search/fuzz.py) into the campaign's
    after-the-fact telemetry. No live poller required: a finished or
    killed campaign is inspectable from the dir alone.

    Rows are deduped by (worker, rounds_done) keeping the LAST
    occurrence — a killed-and-resumed worker re-appends its interrupted
    sync's row with identical content (the append-before-commit
    ordering), so the folded timeline has no double-counted rounds and
    no gaps. Returns:

      timeline         all rows, deduped, time-ordered
      coverage_curve   [[t_rel_s, coverage]] — campaign-global coverage
                       over wall time (running max over workers' views)
      rate_curve       [[t_rel_s, schedules_per_sec]] — coverage/wall
                       at each sync
      p99_curve        [[t_rel_s, lat_p99_us]] — the campaign's
                       end-to-end p99 over wall time, from rows whose
                       worker ran with the SLO latency plane compiled
                       in (cfg.latency_hist > 0, r16); empty otherwise
      slo              {target, miss} — the advertised SLO target (µs)
                       and total misses over every deduped round row
                       (r23); None when no row carried latency fields
      workers_health   {label: {last_seen, age_s, rounds_done, sync_gap_s,
                       stale}} — `stale` means the CAMPAIGN has newer
                       activity than the worker: no row of this worker
                       within `stale_after` × its own observed sync
                       cadence of the newest row ANY worker appended.
                       Staleness is always measured against that newest
                       row, never against `now` — a worker whose last
                       row IS the campaign's latest activity can't be
                       stale, so a finished campaign (one worker
                       included) reads healthy no matter how long ago
                       it finished, while a worker that died unresumed
                       beside still-running peers reads stale — its
                       last counters are history, not current state.
                       `now` (default: the newest row's timestamp) only
                       scales the reported age_s.
    """
    by_worker = store.read_metrics()
    rows = []
    health = {}
    for label, raw in by_worker.items():
        dedup: dict[int, dict] = {}
        for rec in raw:
            dedup[int(rec.get("rounds_done", 0))] = rec
        wrows = sorted(dedup.values(),
                       key=lambda r: (r.get("t", 0.0),
                                      r.get("rounds_done", 0)))
        rows += [dict(r, worker=label) for r in wrows]
        if wrows:
            ts = [r.get("t", 0.0) for r in wrows]
            gaps = [b - a for a, b in zip(ts, ts[1:]) if b > a]
            health[label] = dict(
                last_seen=ts[-1],
                rounds_done=int(wrows[-1].get("rounds_done", 0)),
                sync_gap_s=round(float(np.median(gaps)) if gaps else 0.0,
                                 3))
    rows.sort(key=lambda r: (r.get("t", 0.0), r.get("rounds_done", 0)))
    t_latest = max((r.get("t", 0.0) for r in rows), default=0.0)
    t_ref = now if now is not None else t_latest
    for label, h in health.items():
        h["age_s"] = round(max(t_ref - h["last_seen"], 0.0), 3)
        # a worker with one row has no observed cadence — only flag it
        # against cadences its peers establish
        gap = h["sync_gap_s"] or max(
            (g["sync_gap_s"] for g in health.values() if g["sync_gap_s"]),
            default=0.0)
        # stale only when the CAMPAIGN has newer activity than the
        # worker: the lag is vs the newest row any worker appended, not
        # vs `now` — a finished campaign's last-syncing worker (its own
        # worker, in the 1-worker case) would otherwise read stale the
        # moment a late report passed a wall-clock `now`
        lag = max(t_latest - h["last_seen"], 0.0)
        h["stale"] = bool(gap and lag > stale_after * gap)
    t0 = rows[0].get("t", 0.0) if rows else 0.0
    coverage_curve = []
    rate_curve = []
    p99_curve = []
    cov = 0
    # schedules/s uses campaign_stats' denominator rule at each point in
    # time: campaign coverage over the MAX of the workers' own wall
    # accounts so far (workers run concurrently, their walls overlap) —
    # dividing by the current ROW's wall would spike whenever a young
    # worker's small wall met the campaign-global coverage
    wall_by_worker: dict[str, float] = {}
    for r in rows:
        cov = max(cov, int(r.get("coverage", 0)))
        t_rel = round(r.get("t", 0.0) - t0, 3)
        coverage_curve.append([t_rel, cov])
        if r.get("wall_s"):
            wall_by_worker[r["worker"]] = max(
                wall_by_worker.get(r["worker"], 0.0), float(r["wall_s"]))
        wall = max(wall_by_worker.values(), default=0.0)
        if wall:
            rate_curve.append([t_rel, round(cov / wall, 2)])
        if r.get("lat_p99") is not None:
            p99_curve.append([t_rel, int(r["lat_p99"])])
    # SLO rollup (r23): total misses over every deduped round row plus
    # the last advertised target — the tile next to the p99 curve. None
    # when no worker ran the latency plane (section doesn't render).
    slo_rows = [r for r in rows if r.get("slo_miss") is not None]
    slo = (dict(target=max((int(r.get("slo_target", 0))
                            for r in slo_rows), default=0),
                miss=sum(int(r["slo_miss"]) for r in slo_rows))
           if slo_rows else None)
    return dict(timeline=rows, coverage_curve=coverage_curve,
                rate_curve=rate_curve, p99_curve=p99_curve,
                slo=slo, workers_health=health)


def campaign_report(corpus_dir: str, uptime_s: float = 0.0,
                    workers: int = 0, worker_results: dict | None = None,
                    stale_after: float = 3.0) -> dict:
    """The merged truth of a campaign dir: coverage, per-worker rounds,
    crash buckets AFTER the read-side suffix merge (so the count is
    bugs, not bucket-open races), and the durable timeline
    (`campaign_timeline` — coverage/schedules-per-sec/p99 curves +
    per-worker last-seen health, with stale workers FLAGGED rather than
    their last counters silently reported as current)."""
    store = CorpusStore(corpus_dir, create=False)
    stats = campaign_stats(corpus_dir, uptime_s=uptime_s, workers=workers,
                           store=store)
    merged = merged_buckets(store)
    per_worker = {
        w: store.load_worker_state(w) for w in store.worker_ids()}
    tl = campaign_timeline(store, stale_after=stale_after)
    return dict(
        stats,
        timeline=tl["timeline"],
        coverage_curve=tl["coverage_curve"],
        rate_curve=tl["rate_curve"],
        p99_curve=tl["p99_curve"],
        slo=tl["slo"],
        workers_health=tl["workers_health"],
        stale_workers=sorted(w for w, h in tl["workers_health"].items()
                             if h["stale"]),
        buckets_merged=len(merged),
        bucket_detail=[
            dict(key=m["key"], crash_code=m["crash_code"],
                 members=m["members"], observations=m["observations"],
                 repro=m["repro"],
                 minimized="minimized" in m)
            for m in merged],
        workers_detail={
            **{w: dict(rounds_done=s.get("rounds_done", 0),
                       corpus_entries=len(s.get("order", [])),
                       wall_s=round(s.get("wall_s", 0.0), 2),
                       dry=s.get("dry", 0))
               for w, s in per_worker.items()},
            # mesh-sharded groups: one row per group, shard widths and
            # the per-shard live-entry split visible
            **{f"g{g}": dict(
                rounds_done=s.get("rounds_done", 0),
                shards=s.get("shards", 0),
                corpus_entries=sum(len(sh.get("order", []))
                                   for sh in s.get("shard_states", [])),
                per_shard_entries=[len(sh.get("order", []))
                                   for sh in s.get("shard_states", [])],
                wall_s=round(s.get("wall_s", 0.0), 2),
                dry=s.get("dry", 0))
               for g, s in ((g, store.load_shard_group_state(g))
                            for g in store.shard_group_ids())}},
        worker_results=worker_results)


def prune_cold_entries(corpus_dir: str, below: float = 0.1,
                       keep_min: int = 4) -> dict:
    """Supervisor policy op: drop cold entries (current energy < `below`)
    from every worker's and shard's LIVE corpus, keeping at least the
    `keep_min` hottest per corpus. Rewrites only the scheduler `order`
    lists (one atomic replace per state file); entry FILES are immutable
    admission records and stay — the campaign's coverage frontier
    (`_seen`, dedup, dry detection) is untouched, exactly like an
    eviction. Run it only between segments (no live workers): a pruned
    order changes the resumed run's parent draws BY DESIGN — this is a
    supervisor intervention, not a resume, so the split==continuous
    equality contract deliberately does not span it.

    Returns {pruned, kept, workers} counts."""
    from .store import _atomic_json
    store = CorpusStore(corpus_dir, create=False)
    pruned = kept = touched = 0

    def prune_order(order):
        nonlocal pruned, kept
        if len(order) <= keep_min:
            kept += len(order)
            return order, False
        hot = sorted(range(len(order)), key=lambda i: -order[i][1])
        protect = set(hot[:keep_min])
        new = [row for i, row in enumerate(order)
               if row[1] >= below or i in protect]
        pruned += len(order) - len(new)
        kept += len(new)
        return new, len(new) != len(order)

    for w in store.worker_ids():
        ws = store.load_worker_state(w)
        if not ws:
            continue
        ws["order"], changed = prune_order(ws.get("order", []))
        if changed:
            _atomic_json(store.worker_state_path(w), ws)
            touched += 1
    for g in store.shard_group_ids():
        gs = store.load_shard_group_state(g)
        changed_any = False
        for sh in gs.get("shard_states", []):
            sh["order"], changed = prune_order(sh.get("order", []))
            changed_any |= changed
        if changed_any:
            _atomic_json(store.shard_group_path(g), gs)
            touched += 1
    return dict(pruned=pruned, kept=kept, workers=touched)


def supervise_campaign(factory: str, corpus_dir: str, *, workers: int = 2,
                       segments: int = 3, rounds_per_segment: int = 4,
                       max_steps: int, batch: int = 64, chunk: int = 256,
                       factory_kwargs: dict | None = None,
                       base_seed: int = 0, sync_every: int = 1,
                       minimize: bool = False, shards: int = 1,
                       verify_resume: bool = False,
                       prune_below: float = 0.1, prune_keep_min: int = 4,
                       observer=None, env: dict | None = None,
                       poll_s: float = 2.0,
                       python: str = sys.executable,
                       run_segment=None, triage: bool = True) -> dict:
    """The always-on supervisor loop (the r11 follow-on): run campaign
    SEGMENTS back to back, each rotating the per-worker `max_rounds`
    target up by `rounds_per_segment` — so `run_campaign`'s
    one-segment-per-call contract becomes a service. Between segments
    the supervisor:

      - RESTARTS dead workers: a worker that exited nonzero (crash,
        OOM, SIGKILL) left its store consistent at its last sync; the
        next segment respawns every worker id, and the dead one resumes
        from where it actually synced (the durability contract) — the
        restart count is reported per segment;
      - PRUNES cold corpus entries (`prune_cold_entries`): energies
        decay every round, so multi-segment campaigns accumulate dead
        weight in the scheduler orders; pruning keeps parent sampling
        sharp without ever forgetting coverage.

      - SNAPSHOTS the triage plane (`triage=True`, the default): one
        `service.triage.triage_snapshot` per segment, so a long
        campaign accretes a diffable `triage/` history for free —
        `python -m madsim_tpu_torch.service.report <dir> --against prev`
        answers "what did the last segment buy" without re-reading raw
        entry files (the snapshot walk is O(new files) on the
        supervisor's long-lived store handle, like the poll loop).

    `run_segment` injects the segment runner (tests stub it); default
    is `run_campaign`. Returns {segments: [per-segment report summary
    incl. its snapshot number], restarts, pruned, report: final merged
    campaign_report}."""
    runner = run_campaign if run_segment is None else run_segment
    seg_rows = []
    restarts = 0
    pruned_total = 0
    triage_store = None
    prev_snap = None
    for seg in range(segments):
        target = (seg + 1) * rounds_per_segment
        rep = runner(factory, corpus_dir, workers=workers,
                     max_steps=max_steps, batch=batch, max_rounds=target,
                     chunk=chunk, factory_kwargs=factory_kwargs,
                     base_seed=base_seed, sync_every=sync_every,
                     minimize=minimize, shards=shards,
                     verify_resume=verify_resume, observer=observer,
                     env=env, poll_s=poll_s, python=python)
        dead = sorted(
            int(w) for w, r in (rep.get("worker_results") or {}).items()
            if r.get("returncode") not in (0, None))
        if seg + 1 < segments:
            restarts += len(dead)
            pr = prune_cold_entries(corpus_dir, below=prune_below,
                                    keep_min=prune_keep_min)
            pruned_total += pr["pruned"]
        snap_no = None
        if triage and os.path.exists(
                os.path.join(corpus_dir, "MANIFEST.json")):
            from .triage import triage_diff, triage_snapshot
            if triage_store is None:
                triage_store = CorpusStore(corpus_dir, create=False)
            snap_no, snap = triage_snapshot(triage_store)
            if observer is not None:
                rec = dict(kind="triage", segment=seg, snapshot=snap_no)
                if prev_snap is not None:
                    d = triage_diff(prev_snap, snap)
                    rec.update(
                        empty=d["empty"],
                        coverage_added=d["coverage"]["added"],
                        **{f"buckets_{k}": len(v)
                           for k, v in d["buckets"].items()})
                observer.on_round(rec)
            prev_snap = snap
        seg_rows.append(dict(
            segment=seg, max_rounds=target,
            rounds_done=rep.get("rounds_done", 0),
            coverage_keys=rep.get("coverage_keys", 0),
            buckets=rep.get("buckets", 0),
            dead_workers=dead,
            snapshot=snap_no))
        if observer is not None:
            observer.on_round(dict(kind="supervisor", segment=seg,
                                   max_rounds=target,
                                   dead_workers=dead,
                                   restarts=restarts,
                                   pruned=pruned_total))
    return dict(segments=seg_rows, restarts=restarts,
                pruned=pruned_total,
                report=campaign_report(corpus_dir, workers=workers))


def replay_bucket(rt, corpus_dir: str, key: str, max_steps: int,
                  chunk: int = 256, dup_slots: int = 2,
                  verify: bool | None = None,
                  full_chain: bool = False, window_trace: bool = False):
    """Re-run a bucket's kept repro — the durable analog of pasting a
    madsim seed into a failing test. Returns (crashed, crash_code,
    explain dict or None): the (seed, knobs) handle replays the exact
    trajectory on any host with a structurally equal runtime — the
    manifest signature guards that (a mismatched `rt`, or a different
    `dup_slots` than the campaign fuzzed with, raises StoreMismatch
    here instead of replaying knobs onto the wrong rows).

    verify (None reads MADSIM_FUZZ_VERIFY_RESUME, default off): the
    run-twice guard — a bucket replay is replay-AUTHORITATIVE ("does
    this bug still exist?"), so with verify on the lane re-runs until
    two consecutive invocations agree on (crashed, code, fingerprint);
    three distinct results raise (real nondeterminism).

    full_chain (r20, DESIGN §21): when the replayed crash's chain is
    truncated at ring wrap — or the runtime compiled the ring out —
    re-run the handle through `obs.timetravel.full_chain_replay` (the
    t=0 checkpoint, ring upgraded to hold the whole trajectory) and
    return the COMPLETE chain instead; the bucket record is upgraded
    in place when the complete chain matches the bucket
    (deepest-common-suffix), so triage converges to full chains.
    window_trace additionally writes the replayed window's focused
    Perfetto export next to the bucket artifacts
    (`buckets/<key>.window.trace.json` — service.report links it)."""
    import numpy as np

    from ..obs.causal import explain_crash
    from ..search.fuzz import _env_verify_resume
    from ..search.mutate import KnobPlan
    from .store import store_signature
    if verify is None:
        verify = _env_verify_resume()
    plan = KnobPlan.from_runtime(rt, dup_slots=dup_slots)
    store = CorpusStore(corpus_dir, signature=store_signature(rt, plan),
                        create=False)
    seed, knobs = store.load_bucket_repro(key)

    def once():
        # a fresh init state each time: the knob write works in place
        state = plan.apply(rt.init_batch(np.asarray([seed], np.uint32)),
                           KnobPlan.stack([knobs]))
        state = rt.run_fused(state, max_steps, chunk)
        return state, (bool(state.crashed[0]), int(state.crash_code[0]),
                       int(rt.fingerprints(state)[0]))

    state, out = once()
    if verify:
        from ..parallel.stats import _agree_twice
        state, out = _agree_twice((state, out), once,
                                  key_of=lambda t: t[1],
                                  what=f"bucket {key}")
    crashed, code, fp_seen = out
    exp = None
    if crashed and rt.cfg.trace_cap > 0:
        exp = explain_crash(state, 0)
    if full_chain and crashed and (exp is None or exp.get("truncated")):
        from ..obs.causal import causal_fingerprint, fingerprints_match
        from ..obs.timetravel import full_chain_replay
        trace_path = (store.bucket_path(key, ".window.trace.json")
                      if window_trace else None)
        rep = full_chain_replay(
            rt, seed=seed, knobs=knobs,
            expect=dict(crashed=crashed, crash_code=code,
                        fingerprint=fp_seen),
            max_steps=max_steps, chunk=chunk,
            trace_cap=int(state.steps[0]) + 1,
            export_trace=trace_path)
        exp = rep["explain"]
        # converge the durable record to the complete chain — only when
        # deepest-common-suffix proves it the same bug as the bucket
        rec = store.load_bucket(key)
        new_fp = causal_fingerprint(exp)
        old_fp = rec["fingerprint"]
        deeper = (new_fp["depth"] > old_fp["depth"]
                  or (new_fp.get("complete") and not old_fp.get("complete"))
                  or rec.get("chain_truncated") is not False)
        if deeper and fingerprints_match(new_fp, old_fp):
            rec.update(fingerprint=new_fp,
                       chain=[{k: int(c[k]) for k in c}
                              for c in exp["chain"]],
                       chain_truncated=bool(exp["truncated"]))
            store.write_bucket(key, rec)
    elif full_chain and crashed and window_trace:
        # chain already complete in the live ring: still attach the
        # focused trace so the bucket row links it
        from ..obs.trace import export_chrome_trace
        export_chrome_trace(store.bucket_path(key, ".window.trace.json"),
                            state=state, lane=0)
    return crashed, code, exp
