"""The fuzz corpus: interesting knob vectors, energy-scheduled.

(The port's own copy of `madsim_tpu.search.corpus` — host-only numpy,
the same energy rules, entry ids and random draws, so a campaign admits
the same entries in both packages.)

AFL keeps inputs that reached new edges; the schedule fuzzer keeps knob
vectors whose lane produced a `sched_hash` never seen before — the corpus
is KEYED AND DEDUPED by the coverage digest itself (one entry per distinct
u64 schedule hash), so it can only grow when coverage grows. Host-side and
numpy-only: the corpus is bookkeeping between device rounds, and the
pipelined fuzz loop overlaps it with the device's next block. That
overlap hides it only while it is shorter than the block: on an H100 at
the flagship's width (B=100,000) the corpus work of a round takes longer
than the device round, so there the corpus is the bottleneck and the
card waits for it (PERF.md section 5; ROADMAP "Next").

Energy rules (the AFL-style scheduler, simplified to what the batched
setting needs):
  - admission energy 1.0; a lane that CRASHED enters with 3.0 (crash
    neighborhoods are where more crashes live);
  - a parent whose mutant discovered a new schedule is rewarded
    (energy x1.5, capped) — productive regions get more mutation budget;
  - every round all energies decay x`decay` toward a floor, so stale
    entries fade instead of starving newcomers;
  - `schedule()` samples parents with probability proportional to energy,
    and keeps `fresh_frac` of each batch on the UNMUTATED base knobs — an
    exploration floor so the corpus never traps the sweep in one basin;
  - (r16, opt-in) lanes whose OWN end-to-end latency p99 sits high get
    an admission bonus scaled by how close to the round's worst tail
    they are (up to x(1+lat_bonus)) — the divergence-bonus treatment
    applied to TAIL AMPLIFICATION, so the fuzzer can hunt admissions
    that push p99 up, not just ones that rewire the schedule. Fed by
    the on-device latency plane (SimState.lh_e2e, cfg.latency_hist);
    lat_bonus=0 (the default) keeps energy latency-blind and a build
    without the plane is always blind regardless.
  - (r21, opt-in) lanes whose DEEPEST TRANSIENT SPIKE sits high get an
    admission bonus scaled by how close to the round's worst spike
    they are (up to x(1+burst_bonus)) — the lat_bonus treatment
    applied to the WINDOWED series (SimState sr_*, cfg.series_windows):
    the per-lane metric is the worst per-WINDOW p99 (queue high-water
    on latency-less builds), so a mutant that digs one deep transient
    hole which the aggregate p99 then averages away — exactly the
    trajectory shape the recovery oracle judges — outscores a mutant
    that is merely uniformly slow. Fed by `parallel.stats.lane_burst`;
    burst_bonus=0 (the default) keeps energy burst-blind and a build
    without the series plane is always blind regardless.
  - (r10) lanes that diverged from the campaign's consensus prefix EARLY
    get an admission bonus scaled by depth (up to x(1+div_bonus)),
    computed from the on-device prefix-coverage sketches
    (SimState.cov_sketch): an early split means the mutation rewired the
    schedule near its root, and everything downstream of it is new
    territory — the per-prefix signal the terminal sched_hash alone
    cannot see. (r11) The consensus prefix is CROSS-ROUND: per-slot value
    counts accumulate over every observed round (and, through the
    durable store, every prior campaign segment), so novelty is judged
    against the whole campaign's history, not just the current batch —
    the ROADMAP follow-on the r10 per-round modal left open.

Multi-process namespacing (r11): entry ids carry the worker id in their
high bits (`worker_id << _ID_SHIFT | counter`), so two workers sharing a
corpus dir can never mint colliding ids — the by-id parent-reward and
eviction attribution stays sound when entries merge across processes
(a foreign parent id either resolves to the merged copy or to nobody,
never to the wrong entry).
"""

from __future__ import annotations

import numpy as np

from ..parallel.stats import first_divergence_slots
from .mutate import N_MUT_OPS, OP_NAMES, KnobPlan

# op_yield's attribution buckets: one per havoc operator, plus "base"
# for admitted lanes no operator touched (bootstrap / fresh-floor lanes
# and mutants whose every draw was guarded into a no-op)
YIELD_NAMES = OP_NAMES + ("base",)

# entry id = (worker_id << _ID_SHIFT) | per-worker monotonic counter.
# 2^40 admissions per worker and 2^23 workers fit int64 with headroom.
_ID_SHIFT = 40


def split_entry_id(eid: int) -> tuple[int, int]:
    """(worker_id, counter) of a namespaced entry id."""
    return int(eid) >> _ID_SHIFT, int(eid) & ((1 << _ID_SHIFT) - 1)


class Corpus:
    def __init__(self, plan: KnobPlan, rng=None, max_entries: int = 4096,
                 fresh_frac: float = 0.125, decay: float = 0.97,
                 reward: float = 1.5, energy_cap: float = 8.0,
                 div_bonus: float = 1.0, lat_bonus: float = 0.0,
                 burst_bonus: float = 0.0, worker_id: int = 0):
        self.plan = plan
        self.rng = rng if rng is not None else np.random.default_rng(0)
        self.max_entries = int(max_entries)
        self.fresh_frac = float(fresh_frac)
        self.decay = float(decay)
        self.reward = float(reward)
        self.energy_cap = float(energy_cap)
        self.div_bonus = float(div_bonus)   # 0 = sched_hash-only energy
        self.lat_bonus = float(lat_bonus)   # 0 = latency-blind energy
        self.burst_bonus = float(burst_bonus)  # 0 = burst-blind energy
        self.worker_id = int(worker_id)
        self.entries: list[dict] = []   # slot-stable: eviction replaces
        self._seen: set[int] = set()    # every hash ever admitted (dedupe)
        self.crash_codes: set[int] = set()
        # parent attribution is by monotonic entry id, not slot index:
        # schedule() hands out ids and observe() rewards through this map,
        # so an eviction (same round or, under the pipelined loop, a later
        # one) can never hand a stale parent's reward to the slot's fresh
        # occupant — the reward just finds nobody. Ids are namespaced by
        # worker (see module docstring), so the same holds across
        # processes sharing a durable corpus dir.
        self._next_id = self.worker_id << _ID_SHIFT
        self._by_id: dict[int, dict] = {}
        # cross-round consensus prefix: per-slot {sketch value: count}
        # over every lane ever observed (kilobytes of host bookkeeping;
        # serialized with the corpus by service/store.py)
        self._slot_counts: list[dict[int, int]] | None = None
        # durable-store hook: when a CorpusStore drives this corpus it
        # flips this on so entries evicted BETWEEN two syncs are still
        # persisted (their coverage keys are part of _seen and must
        # survive a resume); off by default so in-memory campaigns don't
        # accumulate dead entries
        self.track_evictions = False
        self.evicted_unsynced: list[dict] = []
        # mesh-shard hook (r13, search/shard.py): when on, observe()
        # also queues each OWN admission into an outbox the sharded
        # driver drains at merge points — the in-memory counterpart of
        # the store's immutable entry files, so shard corpora can
        # exchange exactly the entries admitted since the last merge.
        # Foreign admissions (admit_foreign) never enter the outbox:
        # re-broadcasting them would only ping-pong already-shared keys.
        self.track_admissions = False
        self.admitted_unmerged: list[dict] = []
        # consensus DELTA counters (shard mode only): what this corpus
        # folded since the last cross-shard merge. merge_consensus()
        # drains them into the campaign tally, so repeated merges never
        # double-count the shared history. Never pruned — bounded by
        # the lanes observed between two merges.
        self._slot_delta: list[dict[int, int]] | None = None

    def __len__(self) -> int:
        return len(self.entries)

    # ------------------------------------------------------------------
    def coverage_keys(self) -> set[int]:
        """Every sched_hash ever admitted (a copy): the corpus's coverage
        frontier — survives evictions, merges across workers."""
        return set(self._seen)

    def consensus_sketch(self) -> np.ndarray | None:
        """The campaign's consensus prefix: per-slot modal sketch value
        over every observed round (ties break to the smallest value, the
        `parallel.stats.first_divergence_slots` rule). None before any
        sketched round was observed."""
        if self._slot_counts is None:
            return None
        out = np.zeros(len(self._slot_counts), np.uint32)
        for j, counts in enumerate(self._slot_counts):
            # max count, ties to smallest value — sort keys first
            best_v, best_c = 0, -1
            for v in sorted(counts):
                if counts[v] > best_c:
                    best_v, best_c = v, counts[v]
            out[j] = best_v
        return out

    def _fold_sketches(self, sk: np.ndarray) -> None:
        if self._slot_counts is None:
            self._slot_counts = [dict() for _ in range(sk.shape[1])]
        if self.track_admissions and self._slot_delta is None:
            self._slot_delta = [dict() for _ in range(sk.shape[1])]
        for j in range(sk.shape[1]):
            counts = self._slot_counts[j]
            vals, cnts = np.unique(sk[:, j], return_counts=True)
            for v, c in zip(vals.tolist(), cnts.tolist()):
                counts[int(v)] = counts.get(int(v), 0) + int(c)
                if self._slot_delta is not None:
                    dj = self._slot_delta[j]
                    dj[int(v)] = dj.get(int(v), 0) + int(c)
            if len(counts) > 8192:
                # bound the per-slot tally on very long campaigns: keep
                # the hottest half, deterministically (count desc, value
                # asc) — pruning is a pure function of the counter state,
                # so an interrupted+resumed campaign prunes identically
                keep = sorted(counts.items(),
                              key=lambda kv: (-kv[1], kv[0]))[:4096]
                self._slot_counts[j] = dict(keep)

    def admit_foreign(self, entry: dict) -> bool:
        """Merge one entry harvested by ANOTHER worker (service/store.py
        scan): admitted only when its coverage key is new here, keeping
        its foreign id and admission energy. Returns True on admission.
        The merge is lock-free by construction — ids are namespaced per
        worker and entries are immutable once written, so merging is
        order-independent set union keyed by sched_hash."""
        h = int(entry["hash"])
        if h in self._seen:
            return False
        self._seen.add(h)
        if entry.get("crash_code", 0):
            self.crash_codes.add(int(entry["crash_code"]))
        self._insert(dict(entry))
        return True

    def _insert(self, entry: dict) -> None:
        self._by_id[entry["id"]] = entry
        if len(self.entries) < self.max_entries:
            self.entries.append(entry)
        else:                        # replace the coldest slot
            j = int(np.argmin([e["energy"] for e in self.entries]))
            del self._by_id[self.entries[j]["id"]]
            if self.track_evictions:
                self.evicted_unsynced.append(self.entries[j])
            self.entries[j] = entry

    # ------------------------------------------------------------------
    def energy_summary(self) -> dict:
        """The corpus's energy distribution — where the scheduler's
        mutation budget is concentrated (fuzz_round records carry it):
        entry count, total/mean/percentile energies, and how many live
        entries came from crashing lanes."""
        if not self.entries:
            return dict(entries=0)
        en = np.asarray([e["energy"] for e in self.entries])
        return dict(
            entries=len(self.entries),
            total=round(float(en.sum()), 3),
            mean=round(float(en.mean()), 3),
            p50=round(float(np.percentile(en, 50)), 3),
            p90=round(float(np.percentile(en, 90)), 3),
            max=round(float(en.max()), 3),
            crash_entries=sum(1 for e in self.entries
                              if e.get("crash_code", 0)))

    # ------------------------------------------------------------------
    def observe(self, knobs_batch, seeds, hashes_u64, crashed, codes,
                parent_ids, round_no: int, sketches=None,
                last_op=None, lat_p99=None, burst=None,
                origin=None) -> dict:
        """Fold one harvested round into the corpus. `knobs_batch` is the
        HOST knob batch that ran, `hashes_u64` the per-lane schedule
        hashes, `parent_ids` the corpus entry id each lane mutated from
        (schedule()'s ids; -1 for base/bootstrap lanes), `sketches` the
        optional [B, S] prefix-coverage sketch batch (SimState.cov_sketch
        — enables the early-divergence admission bonus), `last_op` the
        optional int[B] per-lane LAST applied havoc operator
        (KnobPlan.mutate's third output; -1 = untouched), `lat_p99` the
        optional int[B] per-lane end-to-end p99 estimate
        (parallel.stats.lane_e2e_p99 — enables the opt-in tail-latency
        admission bonus when self.lat_bonus > 0), `burst` the optional
        int[B] per-lane deepest-transient-spike metric
        (parallel.stats.lane_burst off the windowed series — enables
        the opt-in burst admission bonus when self.burst_bonus > 0).
        `origin` the optional bool[B] LDFI mask (search/ldfi.py):
        True marks a lane that ran a lineage-targeted vector — its
        admitted entry is tagged `origin="targeted"` (an ADDITIVE key:
        havoc entries carry no origin at all, so campaigns without the
        LDFI arm stay byte-identical at the store level) and the stats
        gain `targeted_yield`, targeted admissions counted the same way
        op_yield's "base" slot counts them (a targeted lane's last_op
        is -1). Returns
        admission stats; with `last_op` given they include `op_yield` —
        admissions attributed by operator (int64[N_MUT_OPS + 1], last
        slot = "base"), summing exactly to `new`: which operators'
        mutants actually bought coverage, not just which ran."""
        new = 0
        new_crash_codes = []
        targeted_yield = 0
        op_yield = (np.zeros(N_MUT_OPS + 1, np.int64)
                    if last_op is not None else None)
        div_slot = None
        n_slots = 0
        if sketches is not None:
            sk = np.asarray(sketches)
            if sk.ndim == 2 and sk.shape[1] > 0:
                # fold into the CROSS-ROUND consensus counters first, then
                # measure each lane against the updated campaign modal —
                # round 1 of a fresh corpus reproduces the old per-round
                # modal exactly; later rounds judge novelty against the
                # whole campaign's history (and, via the durable store,
                # prior segments and other workers)
                self._fold_sketches(sk)
                if self.div_bonus > 0:
                    n_slots = sk.shape[1]
                    div_slot = first_divergence_slots(
                        sk, consensus=self.consensus_sketch())
        lat_rel = None
        if lat_p99 is not None and self.lat_bonus > 0:
            lp = np.asarray(lat_p99, np.float64)
            lat_max = float(lp.max()) if lp.size else 0.0
            if lat_max > 0:
                # tail-amplification bonus scale: each lane's p99
                # relative to the round's worst tail, in [0, 1]
                lat_rel = lp / lat_max
        burst_rel = None
        if burst is not None and self.burst_bonus > 0:
            bp = np.asarray(burst, np.float64)
            burst_max = float(bp.max()) if bp.size else 0.0
            if burst_max > 0:
                # burst-amplification bonus scale: each lane's deepest
                # per-window spike relative to the round's worst, [0, 1]
                burst_rel = bp / burst_max
        for e in self.entries:
            e["energy"] = max(0.05, e["energy"] * self.decay)
        for i in range(len(seeds)):
            h = int(hashes_u64[i])
            hit_crash = bool(crashed[i])
            if hit_crash and int(codes[i]) not in self.crash_codes:
                self.crash_codes.add(int(codes[i]))
                new_crash_codes.append(int(codes[i]))
            if h in self._seen:
                continue
            self._seen.add(h)
            new += 1
            if op_yield is not None:
                o = int(last_op[i])
                op_yield[o if 0 <= o < N_MUT_OPS else N_MUT_OPS] += 1
            energy = 3.0 if hit_crash else 1.0
            slot = None
            if div_slot is not None:
                # early-divergence bonus: a lane whose schedule left the
                # round's consensus prefix at slot j gets up to
                # x(1 + div_bonus) admission energy, linear in how early
                # (j == n_slots — never diverged in-window — gets none)
                slot = int(div_slot[i])
                energy *= 1.0 + self.div_bonus * (n_slots - slot) / n_slots
            if lat_rel is not None:
                # tail-latency bonus (r16): a lane whose own p99 sits
                # at the round's worst tail gets up to x(1 + lat_bonus)
                # admission energy, linear in relative tail height —
                # the divergence-bonus treatment for tail amplification
                energy *= 1.0 + self.lat_bonus * float(lat_rel[i])
            if burst_rel is not None:
                # transient-spike bonus (r21): a lane whose deepest
                # per-window spike sits at the round's worst gets up
                # to x(1 + burst_bonus) admission energy — amplifies
                # mutants by their worst MOMENT, not worst aggregate
                energy *= 1.0 + self.burst_bonus * float(burst_rel[i])
            entry = dict(id=self._next_id, hash=h, seed=int(seeds[i]),
                         knobs=KnobPlan.lane(knobs_batch, i),
                         energy=min(self.energy_cap, energy),
                         round=int(round_no), div_slot=slot,
                         crash_code=int(codes[i]) if hit_crash else 0)
            if origin is not None and bool(origin[i]):
                entry["origin"] = "targeted"
                targeted_yield += 1
            self._next_id += 1
            self._insert(entry)
            if self.track_admissions:
                self.admitted_unmerged.append(entry)
            parent = self._by_id.get(int(parent_ids[i]))
            if parent is not None:
                parent["energy"] = min(
                    self.energy_cap, parent["energy"] * self.reward)
        out = dict(new=new, size=len(self.entries),
                   new_crash_codes=new_crash_codes)
        if op_yield is not None:
            out["op_yield"] = op_yield
        if origin is not None:
            out["targeted_yield"] = targeted_yield
        return out

    # ------------------------------------------------------------------
    def schedule(self, batch: int):
        """Pick the next round's parents: energy-weighted sampling with
        replacement, with a `fresh_frac` floor of unmutated base lanes.
        Returns (host knob batch [batch, ...], parent entry ids [batch],
        -1 for base lanes)."""
        ids = np.full(batch, -1, np.int64)
        out = [self.plan.base_knobs() for _ in range(batch)]
        if self.entries:
            en = np.asarray([e["energy"] for e in self.entries])
            p = en / en.sum()
            pick = self.rng.choice(len(self.entries), size=batch, p=p)
            mutate_lane = self.rng.random(batch) >= self.fresh_frac
            for i in range(batch):
                if mutate_lane[i]:
                    ent = self.entries[int(pick[i])]
                    out[i] = ent["knobs"]
                    ids[i] = ent["id"]
        return KnobPlan.stack(out), ids


def merge_consensus(corpora, tally=None):
    """The consensus all-reduce, applied to corpus state (r13): drain
    every shard corpus's DELTA counters (what it folded since the last
    merge) into the campaign tally, then install an independent copy of
    the tally as every corpus's consensus counters — afterwards each
    shard's divergence energy measures novelty against the whole
    campaign's history, not just its own shard's (the r10 cross-shard
    follow-on). Returns the updated tally; the driver (search/shard.py)
    threads it between merges.

    Delta-based on purpose: installing the tally and then re-summing
    whole counter sets at the next merge would count the shared history
    once per shard. Summing only the per-shard deltas keeps the tally
    exact, and makes the fold associative/commutative — merge order
    cannot fork shards. Deltas never prune (`_fold_sketches` bounds
    them by the lanes between merges); the tally itself is pruned with
    the same deterministic rule as a corpus's own counters, applied at
    install time, so every shard holds the identical post-prune view.
    The 1-shard sharded campaign never calls this (nothing is
    cross-shard there), keeping it bit-identical to the unsharded
    fuzzer by construction."""
    deltas = [c._slot_delta for c in corpora if c._slot_delta is not None]
    if not deltas and tally is None:
        return None
    n_slots = max([len(d) for d in deltas]
                  + ([len(tally)] if tally is not None else []))
    merged: list[dict[int, int]] = [
        dict(tally[j]) if tally is not None and j < len(tally) else dict()
        for j in range(n_slots)]
    for d in deltas:
        for j, counts in enumerate(d):
            mj = merged[j]
            for v, c in counts.items():
                mj[v] = mj.get(v, 0) + c
    for j, mj in enumerate(merged):
        if len(mj) > 8192:
            keep = sorted(mj.items(), key=lambda kv: (-kv[1], kv[0]))[:4096]
            merged[j] = dict(keep)
    for c in corpora:
        c._slot_counts = [dict(s) for s in merged]
        if c._slot_delta is not None:
            c._slot_delta = [dict() for _ in range(n_slots)]
    return merged
