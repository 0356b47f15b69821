"""Crash dedup by causal fingerprint: one bug = one bucket.

The counterpart of `madsim_tpu.service.buckets`: host Python, the same names
and the same file bytes, so a store written by either package opens in
the other.

The raw crash code is too coarse a dedup key (every invariant trip in a
model shares one code) and the raw (seed, lane) too fine (millions of
lanes hit the same bug). The r10 lineage layer gives the right key: the
`explain_crash` parent chain — WHAT sequence of events caused the crash,
independent of which lane/seed/process observed it. `obs/causal.py
causal_fingerprint` hashes that chain wrap-stably (deepest-common-suffix
matching, so ring truncation at different points can't split a bug);
this module keeps the durable bucket files in a `CorpusStore`:

  buckets/<key>.json        the fingerprint record + chain summary + the
                            kept repro handle (seed, round, worker)
  buckets/<key>.npz         the repro's full knob vector — with the seed,
                            the complete replay handle (a mutated lane is
                            NOT reproducible from its seed alone)
  buckets/<key>.trace.json  Perfetto export of the crash lane's ring
                            (flow arrows = the causal chain, r10)
  buckets.jsonl             one line per bucketed observation (telemetry)

Buckets are not only crashes: confirmed SCHEDULE RACES (analyze/races.py)
land here too, under `obs.causal.race_fingerprint` — same files, same
dedup machinery, with the repro handle extended to (seed, knobs, nudge)
since a race only manifests under its PCT tie-break policy.

Cross-process dedup is mostly by construction: two workers that compute
the same fingerprint race to `os.replace` the same file name — last
writer wins with equivalent content. The residual race (two workers
opening buckets for one bug truncated at DIFFERENT wrap depths in the
same instant) is repaired at read time: `merged_buckets` folds
suffix-matching buckets together, so campaign reports count bugs, not
write races.
"""

from __future__ import annotations

import time

from ..obs.causal import (causal_fingerprint, code_fingerprint,
                          explain_crash, fingerprints_match)
from .store import CorpusStore


class CrashBuckets:
    """The write-side bucket index one worker holds over a store."""

    def __init__(self, store: CorpusStore):
        self.store = store
        self._index: dict[str, dict] = {}
        self.new_keys: list[str] = []   # buckets THIS worker opened

    def refresh(self) -> None:
        for key in self.store.bucket_keys():
            if key not in self._index:
                self._index[key] = self.store.load_bucket(key)

    def _match(self, fp: dict) -> str | None:
        if fp["key"] in self._index:
            return fp["key"]
        best = None
        best_depth = -1
        for key, rec in self._index.items():
            if fingerprints_match(fp, rec["fingerprint"]) \
                    and rec["fingerprint"]["depth"] > best_depth:
                best, best_depth = key, rec["fingerprint"]["depth"]
        return best

    def observe(self, fp: dict, *, seed: int, knobs: dict | None,
                round_no: int, worker_id: int, chain: list | None = None,
                state=None, lane: int | None = None,
                nudge: int | None = None,
                last_op: int | None = None,
                chain_truncated: bool | None = None,
                origin: str | None = None) -> tuple[str, bool]:
        """Fold one crash observation in. Returns (bucket key, opened):
        `opened` is True when this observation created a new bucket (and
        wrote its repro + trace artifacts); an observation matching an
        existing bucket only appends a telemetry line — the first repro
        stays the bucket's canonical handle.

        `nudge` extends the repro handle for CONFIRMED SCHEDULE RACES
        (analyze/races.py, fp kind="race"): the race only manifests
        under that PCT tie-break policy, so the full replay handle is
        (seed, knobs, nudge) — `search.pct.with_prio_nudge` applies the
        third leg at replay.

        `last_op` (r18) records the havoc operator that produced the
        crashing lane's knob vector (KnobPlan.mutate's per-lane
        attribution; -1 = untouched/bootstrap) into the bucket record —
        the triage plane's per-operator bucket attribution; buckets
        without it (pre-r18, or races) attribute to the explicit
        `base` class.

        `origin` (r22) records which SEARCH ARM produced the crashing
        lane's knob vector — "targeted" (a lineage-synthesized vector,
        search/ldfi.py) or "havoc" — into the bucket record and every
        telemetry line, the triage plane's targeted-vs-havoc bucket
        attribution. Additive: buckets observed without it (pre-r22, or
        ldfi-less campaigns) carry no origin field and triage
        attributes them to "havoc" (factually honest — nothing before
        r22 ever aimed).

        `chain_truncated` (r20) records whether this observation's
        chain was cut at ring wrap. Completeness UPGRADE rule: an
        observation matching an existing bucket with a DEEPER (or
        newly complete) chain — e.g. a time-travel replay
        (`explain_crash(replay=True)`) recovering the full chain its
        truncated sibling opened the bucket with — rewrites the
        bucket's fingerprint/chain in place (deepest-common-suffix
        already proved them the same bug; the repro handle and key
        stay canonical). The bucket record therefore converges to the
        most complete chain any worker ever observed."""
        self.refresh()
        key = self._match(fp)
        opened = key is None
        if opened:
            key = fp["key"]
            repro = dict(seed=int(seed), round=int(round_no),
                         worker_id=int(worker_id))
            if nudge is not None:
                repro["nudge"] = int(nudge)
            rec = dict(
                key=key, fingerprint=fp,
                crash_code=fp["crash_code"], crash_node=fp["crash_node"],
                chain=[{k: int(c[k]) for k in c} for c in (chain or [])],
                repro=repro,
                created_at=time.time())
            if last_op is not None:
                rec["op"] = int(last_op)
            if origin is not None:
                rec["origin"] = str(origin)
            if chain_truncated is not None:
                rec["chain_truncated"] = bool(chain_truncated)
            self.store.write_bucket(key, rec, knobs=knobs)
            if state is not None and lane is not None:
                from ..obs.trace import export_chrome_trace
                export_chrome_trace(self.store.bucket_path(
                    key, ".trace.json"), state=state, lane=int(lane))
            self._index[key] = rec
            self.new_keys.append(key)
        else:
            old = self._index[key]["fingerprint"]
            deeper = (fp["depth"] > old["depth"]
                      or (fp.get("complete") and not old.get("complete")))
            if deeper and chain:
                rec = dict(self._index[key], fingerprint=fp,
                           chain=[{k: int(c[k]) for k in c}
                                  for c in chain],
                           upgraded_at=time.time())
                if chain_truncated is not None:
                    rec["chain_truncated"] = bool(chain_truncated)
                self.store.write_bucket(key, rec)   # no knobs: the
                self._index[key] = rec              # canonical repro stays
        line = dict(
            kind="crash", bucket=key, fp_key=fp["key"],
            crash_code=fp["crash_code"], seed=int(seed),
            round=int(round_no), worker_id=int(worker_id),
            opened=bool(opened))
        if origin is not None:
            line["origin"] = str(origin)
        self.store.append_bucket_log(line)
        return key, opened

    def observe_lane(self, state, lane: int, *, seed: int,
                     knobs: dict | None, round_no: int,
                     worker_id: int,
                     last_op: int | None = None,
                     origin: str | None = None) -> tuple[str, bool]:
        """Fingerprint one crashed lane straight off its ring. Falls back
        to the code fingerprint when the build compiled lineage out
        (cfg.trace_cap == 0) — coarser buckets, still deduped."""
        try:
            exp = explain_crash(state, lane)
            fp = causal_fingerprint(exp)
            chain = exp["chain"]
            truncated = bool(exp["truncated"])
        except ValueError:
            code = int(state.crash_code.reshape(-1)[lane])
            node = int(state.crash_node.reshape(-1)[lane])
            fp, chain, state, lane = code_fingerprint(code, node), None, \
                None, None
            truncated = None
        return self.observe(fp, seed=seed, knobs=knobs, round_no=round_no,
                            worker_id=worker_id, chain=chain, state=state,
                            lane=lane, last_op=last_op,
                            chain_truncated=truncated, origin=origin)


def merged_buckets(store: CorpusStore, log: list | None = None) -> list[dict]:
    """The read-side truth: all buckets, with suffix-matching ones folded
    together (repairing the concurrent-open race and cross-ring-depth
    splits). Deepest chain wins as canonical; observation counts come
    from the telemetry log DEDUPED by (fingerprint, worker, round) —
    a killed worker's interrupted round re-appends its observation line
    on resume, and counting the replay twice inflated every bug-rate
    curve downstream (campaign_report). Deterministic: candidates are
    processed in (depth desc, key) order. `log` short-circuits the
    observation-log read with an already-deduped row list — a caller
    that needs the rows itself (triage_snapshot) parses the file once
    and shares."""
    recs = [store.load_bucket(k) for k in store.bucket_keys()]
    recs.sort(key=lambda r: (-r["fingerprint"]["depth"], r["key"]))
    merged: list[dict] = []
    for rec in recs:
        home = None
        for m in merged:
            if fingerprints_match(rec["fingerprint"], m["fingerprint"]):
                home = m
                break
        if home is None:
            merged.append(dict(rec, members=[rec["key"]], observations=0))
        else:
            home["members"].append(rec["key"])
    by_member = {k: m for m in merged for k in m["members"]}
    for line in (store.bucket_log_deduped() if log is None else log):
        m = by_member.get(line.get("bucket"))
        if m is not None:
            m["observations"] += 1
    return merged
