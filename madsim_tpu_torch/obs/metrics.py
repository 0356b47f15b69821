"""Sweep metrics: the SweepObserver callback protocol + JSONL sink (the
counterpart of `madsim_tpu.obs.metrics`).

Observers hook the host sync points the runners ALREADY pay for — the
per-chunk `halted.all()` test in `run()`/`run_compacting()`, the
per-round digest harvest in `explore()` — so attaching one adds no new
device round-trips; the only extra cost is reading lanes the host was
blocked on anyway. Record kinds (each a flat JSON-able dict carrying
`kind`):

  chunk    one scan chunk retired (run/run_compacting): steps_done,
           lanes_halted, wall-clock lane_steps_per_sec
  compact  run_compacting re-packed survivors: from_batch/to_batch/stashed
  round    one explore() round harvested: new_schedules, distinct_total,
           crashes — the per-round coverage growth off the existing
           on-device digest. fuzz() rounds arrive as kind="fuzz_round"
           with corpus_size/new_crash_codes, plus (r15) `admitted`,
           `op_yield` — the round's admissions attributed to the havoc
           operator that produced each admitted mutant ("base" =
           untouched lanes; the per-operator counts sum to `admitted`)
           — and `corpus_energy` (the scheduler's energy distribution:
           entries/total/mean/p50/p90/max/crash_entries), plus
           div_slot_p50 (the
           round's median first-divergence slot vs the consensus prefix)
           when the build compiles the prefix sketch in
           (cfg.sketch_slots > 0) — depth telemetry riding the sketch
           transfer the corpus already pays for. Builds with the SLO
           latency plane compiled in (cfg.latency_hist > 0, r16) add
           `lat_p99` (the round batch's merged end-to-end p99 estimate
           in ticks, bucket-CDF lower bound), `lat_p50`, and `slo_miss`
           (completions past the dynamic slo_target this round) — and
           run()'s `done` record carries the same three for plain
           sweeps. Mesh-sharded campaigns
           (search/shard.py) add shards (mesh width) and per_shard —
           one row per device shard: {shard, worker_id, corpus_size,
           coverage, new, crashes, seeds_run} — so renderers can show
           the mesh instead of collapsing it into one line
           (ProgressObserver prints one row per shard). A multi-process
           campaign driver (service/campaign.py) emits kind="campaign"
           rounds: uptime_s, workers_alive, corpus_entries,
           coverage_keys, buckets, schedules_per_sec, buckets_per_min —
           the campaign-level rollup polled from the shared corpus dir —
           and `supervise_campaign` emits kind="supervisor" segment
           records: segment, max_rounds, dead_workers, restarts, pruned
  compile  a runner built a new executable: label, batch, chunk (the
           hook is kept for records of the JAX package's compile log;
           nothing in this package fires it: a CUDA graph capture is
           not a compile)
  done     sweep finished: totals

Dispatch is by attribute, so an observer overrides only the hooks it
cares about; exceptions in observer code propagate (a metrics layer that
silently eats its own bugs measures nothing).
"""

from __future__ import annotations

import json
import os
from typing import IO


class SweepObserver:
    """Base observer: every hook a no-op. Subclass and override."""

    def on_chunk(self, rec: dict) -> None:
        pass

    def on_compact(self, rec: dict) -> None:
        pass

    def on_round(self, rec: dict) -> None:
        pass

    def on_compile(self, rec: dict) -> None:
        pass

    def on_done(self, rec: dict) -> None:
        pass


class JsonlObserver(SweepObserver):
    """Write every record as one JSON line (the dashboard/ingest format).

    `sink` is a path (opened for append; close() or use as a context
    manager) or an open file-like object (caller owns its lifetime).
    Floats are rounded — these are metrics, not measurements to diff.

    Every record is flushed as written, so a SIGKILL'd process's log is
    complete up to its last record; `fsync=True` additionally fsyncs per
    record, extending that claim to power loss — campaign workers use
    it (service/worker.py): under `supervise_campaign` respawns the
    worker log is durable telemetry, and the r15 timeline trusts it.
    fsync needs a real file descriptor; sinks without `fileno()`
    (StringIO) raise at construction rather than silently not syncing.
    """

    def __init__(self, sink: str | IO[str], fsync: bool = False):
        self._own = isinstance(sink, str)
        self._f = open(sink, "a") if self._own else sink
        self._fsync = fsync
        if fsync:
            self._f.fileno()    # fail here, not at first record
        self.records: list[dict] = []

    def _emit(self, rec: dict) -> None:
        rec = {k: (round(v, 3) if isinstance(v, float) else v)
               for k, v in rec.items()}
        self.records.append(rec)
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()
        if self._fsync:
            os.fsync(self._f.fileno())

    on_chunk = on_compact = on_round = on_compile = on_done = _emit

    def close(self) -> None:
        if self._own:
            self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class TeeObserver(SweepObserver):
    """Fan one sweep out to several observers (e.g. JSONL + progress)."""

    def __init__(self, *observers: SweepObserver):
        self.observers = observers

    def on_chunk(self, rec):
        for o in self.observers:
            o.on_chunk(rec)

    def on_compact(self, rec):
        for o in self.observers:
            o.on_compact(rec)

    def on_round(self, rec):
        for o in self.observers:
            o.on_round(rec)

    def on_compile(self, rec):
        for o in self.observers:
            o.on_compile(rec)

    def on_done(self, rec):
        for o in self.observers:
            o.on_done(rec)
