"""The campaign triage plane: a long campaign as a DIFFABLE product.

The counterpart of `madsim_tpu.service.triage`: host Python, the same names
and the same file bytes, so a store written by either package opens in
the other.

`campaign_report` answers "what is in this store right now"; after an
overnight multi-worker run the operator's real questions are *what
changed since yesterday*, *which fault recipe earned which bucket*, and
*do our old repros still reproduce*. This module makes those questions
cheap by snapshotting the store into a standing, versioned history the
rest of the plane (diff, attribution, audit, dashboard) reads:

  triage/NNNN.json   one SNAPSHOT: corpus/coverage/bucket/worker truth
                     folded into a byte-stable document (sorted keys,
                     atomic write-then-rename per §13, and NO field
                     sampled from the wall clock at snapshot time — the
                     identity contract: the same store always produces
                     byte-identical snapshot bodies, so history never
                     lies about what changed)
  triage/ROWS.json   the scenario row table (store.write_triage_rows,
                     appended by the first worker) the recipe
                     classifier reads — attribution without a Runtime
  triage/AUDIT.json  the repro-health ledger `audit_buckets` rotates
                     through (pass/fail/flaky per bucket; snapshots
                     fold it in)

Lifecycle (triage_diff): every causal-fingerprint bucket classifies as
  new        in cur only — a bug the window between snapshots found
  grew       in both, observed again, and it was ACTIVE at prev — the
             still-reproducing known bug (summary only, it is expected)
  regressed  in both, observed again AFTER a quiet period (no
             observation within `quiet_rounds` of prev's newest round)
             — a bug that had gone silent and came back
  stale      vanished from the store, or newly quiet — no observation
             in the recent rounds anymore (candidate for the
             repro-health audit: silent because fixed, or because the
             fuzzer stopped reaching it?)
Diff of a snapshot against itself is provably empty: every diff field
is a prev-vs-cur difference, so equal inputs produce no entries.

Attribution accounting contract: per-recipe attribution assigns every
DISTINCT coverage key (and every merged bucket) exactly one
`runtime.scenario.RECIPE_FAMILIES` family via the persisted row table +
the entry's own knob vector (row toggles, torn/direction flags, and dup
clones all respected — a mutant that dropped its torn row classifies by
what actually ran); per-operator attribution folds the r15 `op_yield`
vectors (coverage) and the bucket records' havoc-operator provenance
(buckets). Both sum EXACTLY to their totals: anything unattributable
(no row table, pre-r18 bucket, worker state without yield vectors)
lands in an explicit `base` class — never a silent "other".

Cost: O(new files) per snapshot off a long-lived store handle — entry
files are immutable, so their (hash, family) classification caches
forever (`CorpusStore._triage_cache`), exactly like the campaign poll
loop's coverage-key cache.
"""

from __future__ import annotations

import json
import os

import numpy as np

from ..runtime.scenario import (RECIPE_FAMILIES, classify_recipe,
                                row_recipe_class)
from ..search.corpus import YIELD_NAMES, split_entry_id
from ..search.mutate import N_MUT_OPS
from .buckets import merged_buckets
from .campaign import campaign_timeline
from .store import CorpusStore, _atomic_bytes

TRIAGE_FORMAT = "madsim-triage"
# v2 (r20): bucket rows carry chain_complete + window_trace, audit
# rows carry chain_complete — additive; v1 snapshots still diff cleanly
# v3 (r22): attribution gains the origin axis (origin_coverage /
# origin_buckets: lineage-targeted vs havoc, search/ldfi.py) and bucket
# rows carry `origin` — additive; v2 snapshots still diff cleanly
TRIAGE_VERSION = 3

# the explicit unattributable class (accounting contract above)
BASE_CLASS = "base"
ATTR_FAMILIES = RECIPE_FAMILIES + (BASE_CLASS,)

# the r22 origin axis: which search arm produced an admission/bucket.
# Anything without a recorded origin (pre-r22 stores, ldfi-less
# campaigns) is "havoc" — factually honest, nothing before r22 aimed.
ORIGIN_CLASSES = ("targeted", "havoc")


# ---------------------------------------------------------------------------
# snapshot naming / loading
# ---------------------------------------------------------------------------

def _as_store(store_or_dir) -> CorpusStore:
    if isinstance(store_or_dir, CorpusStore):
        return store_or_dir
    return CorpusStore(store_or_dir, create=False)


def snapshot_path(store: CorpusStore, n: int) -> str:
    return os.path.join(store.triage_dir(), f"{n:04d}.json")


def list_snapshots(store: CorpusStore) -> list[int]:
    """Snapshot numbers present, ascending (the standing history)."""
    try:
        names = os.listdir(store.triage_dir())
    except FileNotFoundError:
        return []
    out = []
    for n in names:
        stem, ext = os.path.splitext(n)
        if ext == ".json" and stem.isdigit():
            out.append(int(stem))
    return sorted(out)


def load_snapshot(store_or_dir, which="last") -> dict:
    """Load one snapshot: an int NNNN, "last", or "prev" (the one
    before last). Raises FileNotFoundError when the history is too
    short — a campaign that never snapshotted has nothing to diff."""
    store = _as_store(store_or_dir)
    have = list_snapshots(store)
    if isinstance(which, str) and which.isdigit():
        which = int(which)
    if which == "last":
        if not have:
            raise FileNotFoundError(
                f"no triage snapshots under {store.triage_dir()} — "
                "run triage_snapshot() (or service.report --snapshot)")
        which = have[-1]
    elif which == "prev":
        if len(have) < 2:
            raise FileNotFoundError(
                f"need two snapshots to diff against 'prev'; "
                f"{store.triage_dir()} has {len(have)}")
        which = have[-2]
    with open(snapshot_path(store, int(which))) as f:
        return json.load(f)


# ---------------------------------------------------------------------------
# the recipe classifier (entry/bucket knob vector -> one family)
# ---------------------------------------------------------------------------

def _row_torn(rows: dict, r: int, knobs: dict) -> bool:
    """The effective torn flag of scenario row r under this knob vector
    (the fuzzer's fault_perturb toggles it; non-torn-capable rows keep
    their base encoding)."""
    if rows["torn_ok"][r]:
        flag = np.asarray(knobs.get("row_flag", ()))
        if flag.size > r:
            return bool(int(flag[r]) & 1)
    return bool(rows["base_torn"][r])


def classify_knobs(rows: dict | None, knobs: dict) -> str:
    """One recipe family for one knob vector, against the persisted row
    table: the classes of every row that would actually RUN under it —
    enabled scenario rows (pinned rows always run) plus enabled dup
    clones of droppable rows (`KnobPlan.to_scenario` semantics) —
    folded by `classify_recipe` precedence. No row table -> the
    explicit BASE_CLASS (pre-r18 store; zero silent leakage)."""
    if rows is None:
        return BASE_CLASS
    ops = rows["op"]
    R = len(ops)
    row_on = np.asarray(knobs.get("row_on", np.ones(R, bool)))
    classes = []
    for r in range(R):
        if not (bool(row_on[r]) or not rows["drop_ok"][r]):
            continue
        classes.append(row_recipe_class(int(ops[r]),
                                        _row_torn(rows, r, knobs)))
    dup_on = np.atleast_1d(np.asarray(knobs.get("dup_on", ())))
    dup_src = np.atleast_1d(np.asarray(knobs.get("dup_src", ())))
    for d in range(dup_on.size):
        if not bool(dup_on[d]):
            continue
        srow = int(np.clip(dup_src[d], 0, R - 1))
        if not rows["drop_ok"][srow]:
            continue
        classes.append(row_recipe_class(int(ops[srow]),
                                        _row_torn(rows, srow, knobs)))
    return classify_recipe(classes)


def _op_name(op) -> str:
    """Havoc-operator index -> YIELD_NAMES label; -1/unknown/missing ->
    the explicit base class (bootstrap lanes, pre-r18 records)."""
    if op is None:
        return BASE_CLASS
    op = int(op)
    return YIELD_NAMES[op] if 0 <= op < N_MUT_OPS else BASE_CLASS


# ---------------------------------------------------------------------------
# the snapshot
# ---------------------------------------------------------------------------

def _entry_files_by_ns(store: CorpusStore) -> dict[int, list[str]]:
    out: dict[int, list[str]] = {}
    for name in store.entry_names():
        w = split_entry_id(store._parse_entry_name(name))[0]
        out.setdefault(w, []).append(name)
    return out


def _committed_entries(store: CorpusStore, states: dict) -> list[str]:
    """The entry files attribution walks: per namespace, only counters
    BELOW the owner's persisted next_counter (half-synced leftovers of
    an interrupted round are quarantined exactly like load_corpus — the
    re-run rewrites them, and counting them now would let a snapshot
    taken mid-kill disagree with one taken after the resume). Files of
    namespaces with no scheduler state at all are kept: a foreign
    merge-only dir is still coverage."""
    next_counter = {w: int(s.get("next_counter", 0))
                    for w, s in states.items()}
    out = []
    for w, names in _entry_files_by_ns(store).items():
        nc = next_counter.get(w)
        for name in sorted(names):
            c = split_entry_id(store._parse_entry_name(name))[1]
            if nc is None or c < nc:
                out.append(name)
    return sorted(out)


# snapshots embed at most this many points per timeline curve (the
# sparkline resolution ceiling; endpoints always kept)
_CURVE_CAP = 512


def _downsample(curve: list, cap: int = _CURVE_CAP) -> list:
    """Deterministic stride-downsample of a [[t, v], ...] series to at
    most `cap` points, first and last always kept — the snapshot's
    curves must not grow the triage history quadratically with a long
    campaign's sync count."""
    n = len(curve)
    if n <= cap:
        return curve
    idx = sorted({round(i * (n - 1) / (cap - 1)) for i in range(cap)})
    return [curve[i] for i in idx]


def _scheduler_states(store: CorpusStore) -> tuple[dict, dict]:
    """({namespace: scheduler state}, {top-level label: state}) over
    plain workers and sharded groups (a group contributes one top-level
    row but one scheduler state per shard namespace)."""
    by_ns: dict[int, dict] = {}
    top: dict[str, dict] = {}
    for w in store.worker_ids():
        ws = store.load_worker_state(w)
        by_ns[w] = ws
        top[f"w{w:04d}"] = ws
    for g in store.shard_group_ids():
        gs = store.load_shard_group_state(g)
        top[f"g{g:04d}"] = gs
        for sh in gs.get("shard_states", []):
            by_ns[int(sh["worker_id"])] = sh
    return by_ns, top


def triage_snapshot(store_or_dir, quiet_rounds: int = 2) -> tuple[int, dict]:
    """Fold the store into one snapshot and append it to the triage/
    history. Returns (snapshot number, body). Byte-stable: the body is
    a pure function of the store's durable contents (sorted keys, no
    wall-clock sampling — `created_at`-style fields are deliberately
    absent), so snapshotting an unchanged store twice writes two files
    with identical bytes and `triage_diff` of the pair is empty."""
    store = _as_store(store_or_dir)
    rows = store.load_triage_rows()
    by_ns, top_states = _scheduler_states(store)
    entry_files = _committed_entries(store, by_ns)

    # -- coverage + per-recipe / per-operator / per-origin attribution --
    recipe_cov = {f: 0 for f in ATTR_FAMILIES}
    origin_cov = {o: 0 for o in ORIGIN_CLASSES}
    claimed: set[int] = set()
    for name in entry_files:
        got = store._triage_cache.get(name)
        # a classification cached while ROWS.json was still absent is
        # provisional (fam None): reclassify once the table appears —
        # entry files are immutable, so everything else caches forever.
        # Pre-r22 cache tuples (len 2, no origin slot) reload once.
        if got is None or (got[1] is None and rows is not None) \
                or len(got) < 3:
            e = store.load_entry(name)
            got = (int(e["hash"]),
                   None if rows is None
                   else classify_knobs(rows, e["knobs"]),
                   e.get("origin") or "havoc")
            store._triage_cache[name] = got
        h, fam = got[0], (BASE_CLASS if got[1] is None else got[1])
        if h in claimed:
            continue                    # first claim wins (sorted walk)
        claimed.add(h)
        recipe_cov[fam] += 1
        origin_cov[got[2] if got[2] in ORIGIN_CLASSES else "havoc"] += 1

    op_cov = {n: 0 for n in YIELD_NAMES}
    attributed_ns: set[int] = set()
    for label, st in sorted(top_states.items()):
        oy = st.get("op_yield")
        if not oy:
            continue
        for i, n in enumerate(oy[:len(YIELD_NAMES)]):
            op_cov[YIELD_NAMES[i]] += int(n)
        if label.startswith("g"):
            attributed_ns |= {int(sh["worker_id"])
                              for sh in st.get("shard_states", [])}
        else:
            attributed_ns.add(int(st.get("worker_id", int(label[1:]))))
    # admissions of workers that never persisted a yield vector land in
    # the explicit base class, so the operator side still sums to the
    # committed-admission total
    for name in entry_files:
        w = split_entry_id(store._parse_entry_name(name))[0]
        if w not in attributed_ns:
            op_cov[BASE_CLASS] += 1

    # -- buckets: merged truth + lifecycle-bearing fields ---------------
    # parse the observation log ONCE and share it with merged_buckets
    # (on a long campaign the log is the store's biggest file)
    obs_log = store.bucket_log_deduped()
    merged = merged_buckets(store, log=obs_log)
    obs_rounds: dict[str, list[int]] = {}
    obs_workers: dict[str, set[int]] = {}
    by_member = {k: m["key"] for m in merged for k in m["members"]}
    for line in obs_log:
        home = by_member.get(line.get("bucket"))
        if home is None:
            continue
        obs_rounds.setdefault(home, []).append(int(line.get("round", 0)))
        obs_workers.setdefault(home, set()).add(
            int(line.get("worker_id", 0)))
    recipe_bk = {f: 0 for f in ATTR_FAMILIES}
    op_bk = {n: 0 for n in YIELD_NAMES}
    origin_bk = {o: 0 for o in ORIGIN_CLASSES}
    buckets = {}
    for m in merged:
        fam = BASE_CLASS
        if rows is not None:
            try:
                _seed, knobs = store.load_bucket_repro(m["key"])
                fam = classify_knobs(rows, knobs)
            except (FileNotFoundError, KeyError):
                fam = BASE_CLASS        # race-only / repro-less bucket
        opn = _op_name(m.get("op"))
        ogn = m.get("origin") if m.get("origin") in ORIGIN_CLASSES \
            else "havoc"
        recipe_bk[fam] += 1
        op_bk[opn] += 1
        origin_bk[ogn] += 1
        rounds = obs_rounds.get(m["key"], [m["repro"].get("round", 0)])
        # r20: chain completeness + the replayed-window trace link.
        # chain_truncated is the recorded truth when present (r20+
        # observations and time-travel upgrades); older records fall
        # back to the fingerprint's depth-capped completeness bit.
        ct = m.get("chain_truncated")
        buckets[m["key"]] = dict(
            crash_code=int(m["crash_code"]),
            crash_node=int(m.get("crash_node", -1)),
            members=sorted(m["members"]),
            observations=int(m["observations"]),
            first_round=int(min(rounds)),
            last_round=int(max(rounds)),
            workers=sorted(obs_workers.get(
                m["key"], {m["repro"].get("worker_id", 0)})),
            recipe=fam,
            op=opn,
            origin=ogn,
            repro={k: int(v) for k, v in m["repro"].items()},
            minimized=bool("minimized" in m),
            chain_complete=((not ct) if ct is not None
                            else bool(m["fingerprint"].get("complete",
                                                           False))),
            # the traced MEMBER key (or None): replay_bucket/audit write
            # the trace under whichever member they replayed, which is
            # not always the merged bucket's canonical key — report/
            # dashboard link the file that actually exists
            window_trace=next(
                (k2 for k2 in sorted(m["members"])
                 if os.path.exists(
                     store.bucket_path(k2, ".window.trace.json"))),
                None))

    # -- durable timeline curves + worker health ------------------------
    # curves embed DOWNSAMPLED (≤ _CURVE_CAP points, endpoints kept,
    # deterministic stride): a long campaign's timeline grows per sync,
    # and the snapshot history must not grow quadratically with it. The
    # coverage KEY LIST stays complete on purpose — exact added/removed
    # diffing is the plane's contract, and keys are the one set a diff
    # cannot reconstruct from counts (17 bytes/key; a 100k-key campaign
    # pays ~1.7MB per snapshot, the documented price of exactness —
    # DESIGN §19).
    tl = campaign_timeline(store)
    from ..obs.profiler import curve_brief
    health = {
        label: dict(rounds_done=h["rounds_done"],
                    last_seen=round(float(h["last_seen"]), 3),
                    sync_gap_s=h["sync_gap_s"],
                    # age vs the campaign's newest activity — NOT vs the
                    # wall clock at snapshot time (identity contract)
                    age_s=h["age_s"],
                    stale=bool(h["stale"]))
        for label, h in sorted(tl["workers_health"].items())}

    max_round = max([s.get("rounds_done", 0) for s in top_states.values()],
                    default=0)
    # AUDIT ledger (audit_buckets) folds in when present
    audit = load_audit(store).get("buckets", {})
    body = dict(
        format=TRIAGE_FORMAT,
        version=TRIAGE_VERSION,
        quiet_rounds=int(quiet_rounds),
        store=dict(
            entries=len(entry_files),
            coverage_total=len(claimed),
            buckets_total=len(merged),
            crash_observations=sum(
                b["observations"] for b in buckets.values()),
            max_round=int(max_round),
            workers={label: dict(
                rounds_done=int(s.get("rounds_done", 0)),
                wall_s=round(float(s.get("wall_s", 0.0)), 3),
                dry=int(s.get("dry", 0)),
                shards=int(s["shards"])) if "shards" in s else dict(
                rounds_done=int(s.get("rounds_done", 0)),
                wall_s=round(float(s.get("wall_s", 0.0)), 3),
                dry=int(s.get("dry", 0)))
                for label, s in sorted(top_states.items())}),
        coverage=dict(keys=sorted(f"{h:016x}" for h in claimed)),
        buckets=buckets,
        attribution=dict(
            recipe_coverage=recipe_cov,
            recipe_buckets=recipe_bk,
            operator_coverage=op_cov,
            operator_buckets=op_bk,
            origin_coverage=origin_cov,
            origin_buckets=origin_bk,
            rows_known=rows is not None),
        curves=dict(coverage=_downsample(tl["coverage_curve"]),
                    rate=_downsample(tl["rate_curve"]),
                    p99=_downsample(tl["p99_curve"])),
        p99=curve_brief(tl["p99_curve"]),
        # the SLO context for the p99 tile (r23): target + total misses
        # over the deduped timeline; None when no worker ran the
        # latency plane — the tile then shows the curve alone
        slo=tl.get("slo"),
        rate=curve_brief(tl["rate_curve"]),
        workers_health=health,
        audit={k: dict(v) for k, v in sorted(audit.items())
               if k in by_member or k in buckets},
    )
    have = list_snapshots(store)
    n = (have[-1] + 1) if have else 1
    os.makedirs(store.triage_dir(), exist_ok=True)
    _atomic_bytes(snapshot_path(store, n),
                  (json.dumps(body, sort_keys=True, indent=1)
                   + "\n").encode())
    return n, body


# ---------------------------------------------------------------------------
# the diff
# ---------------------------------------------------------------------------

def _delta_map(a: dict, b: dict) -> dict:
    """{key: [prev, cur]} for keys whose values differ (either side's
    missing key reads as absent-marker None) — the empty-on-equal
    building block."""
    out = {}
    for k in sorted(set(a) | set(b)):
        va, vb = a.get(k), b.get(k)
        if va != vb:
            out[k] = [va, vb]
    return out


def _quiet(b: dict, snap: dict, quiet_rounds: int) -> bool:
    return (int(snap["store"]["max_round"]) - int(b["last_round"])
            >= quiet_rounds)


def triage_diff(prev: dict, cur: dict,
                quiet_rounds: int | None = None) -> dict:
    """Classify everything that changed between two snapshots. Buckets
    are matched by canonical key OR member overlap (a deeper chain
    arriving between snapshots can re-elect a merged bucket's canonical
    key; member overlap keeps that one bug from reading as new+stale).
    `quiet_rounds` defaults to the snapshots' own setting. Equal
    snapshots produce {'empty': True, ...all fields empty...} — every
    field below is a prev-vs-cur difference by construction."""
    if quiet_rounds is None:
        quiet_rounds = int(cur.get("quiet_rounds", 2))
    pb, cb = prev.get("buckets", {}), cur.get("buckets", {})
    # member -> canonical maps for cross-snapshot identity
    p_by_member = {m: k for k, b in pb.items() for m in b["members"]}
    pairs: dict[str, str | None] = {}       # cur key -> prev key
    matched_prev: set[str] = set()
    for k, b in cb.items():
        hit = None
        if k in pb:
            hit = k
        else:
            for m in b["members"]:
                if m in p_by_member:
                    hit = p_by_member[m]
                    break
        pairs[k] = hit
        if hit is not None:
            matched_prev.add(hit)
    new, regressed, grew, stale = [], [], [], []
    for k in sorted(cb):
        pk = pairs[k]
        b = cb[k]
        if pk is None:
            new.append(k)
            continue
        p = pb[pk]
        seen_again = (b["observations"] > p["observations"]
                      or b["last_round"] > p["last_round"])
        if seen_again:
            (regressed if _quiet(p, prev, quiet_rounds)
             else grew).append(k)
        elif _quiet(b, cur, quiet_rounds) \
                and not _quiet(p, prev, quiet_rounds):
            stale.append(k)             # newly quiet
    stale += sorted(k for k in pb if k not in matched_prev)  # removed
    p_keys = set(prev.get("coverage", {}).get("keys", []))
    c_keys = set(cur.get("coverage", {}).get("keys", []))
    pa = prev.get("attribution", {})
    ca = cur.get("attribution", {})
    out = dict(
        buckets=dict(new=new, regressed=regressed, grew=grew,
                     stale=sorted(stale)),
        coverage=dict(
            added=len(c_keys - p_keys), removed=len(p_keys - c_keys)),
        attribution={dim: _delta_map(pa.get(dim, {}), ca.get(dim, {}))
                     for dim in ("recipe_coverage", "recipe_buckets",
                                 "operator_coverage", "operator_buckets",
                                 "origin_coverage", "origin_buckets")},
        p99=_delta_map(dict(brief=prev.get("p99")),
                       dict(brief=cur.get("p99"))),
        workers=_delta_map(prev.get("workers_health", {}),
                           cur.get("workers_health", {})),
        audit=_delta_map(prev.get("audit", {}), cur.get("audit", {})),
        rounds=_delta_map(dict(max_round=prev["store"]["max_round"]),
                          dict(max_round=cur["store"]["max_round"])),
    )
    out["empty"] = not (
        any(out["buckets"].values())
        or out["coverage"]["added"] or out["coverage"]["removed"]
        or any(out["attribution"].values())
        or out["p99"] or out["workers"] or out["audit"] or out["rounds"])
    return out


def bucket_lifecycle(key: str, diff: dict | None) -> str:
    """One bucket's lifecycle class per `diff` (the renderers' shared
    lookup — "known" when no diff names it)."""
    if diff:
        for cls in ("new", "regressed", "grew", "stale"):
            if key in diff.get("buckets", {}).get(cls, ()):
                return cls
    return "known"


def bucket_audit(snapshot: dict, key: str,
                 members=()) -> dict | None:
    """The audit-ledger verdict for a bucket, falling back through its
    merged members (the ledger keys RAW bucket files; a merged bucket's
    canonical may differ from the member that was audited)."""
    audit = snapshot.get("audit", {})
    hit = audit.get(key)
    if hit is not None:
        return hit
    return next((audit[m] for m in members if m in audit), None)


# ---------------------------------------------------------------------------
# repro-health audit
# ---------------------------------------------------------------------------

def audit_path(store: CorpusStore) -> str:
    return os.path.join(store.triage_dir(), "AUDIT.json")


def load_audit(store_or_dir) -> dict:
    store = _as_store(store_or_dir)
    try:
        with open(audit_path(store)) as f:
            return json.load(f)
    except (FileNotFoundError, ValueError):
        return dict(cursor_key="", buckets={})


def audit_buckets(rt, store_or_dir, max_steps: int, budget: int = 4,
                  chunk: int = 512, dup_slots: int = 2,
                  full_chain: bool = False) -> dict:
    """Re-verify a deterministic rotation of bucket repro handles — the
    standing answer to "do our repros still reproduce on this
    toolchain" (every replay goes through `replay_bucket(verify=True)`,
    the run-twice guard).

    Per audited bucket: `pass` (the handle still crashes — any code;
    the fingerprint, not the code, is the bucket's identity), `fail`
    (replayed clean — the bug no longer reproduces here), `flaky`
    (replay itself misbehaved: three-way disagreement under the verify
    guard, or the handle's artifacts are broken). A failing or flaky
    handle NEVER aborts the sweep — it is the finding. A structurally
    mismatched runtime still raises StoreMismatch out: that is operator
    error, not bucket health.

    The rotation cursor and per-bucket tallies live in triage/AUDIT.json
    (atomic rewrite); snapshots fold the ledger in, so the dashboard
    always shows the latest verdict per bucket. `budget` bounds replays
    per call — a nightly `budget=4` sweeps a 40-bucket corpus every ten
    nights, for free.

    The ledger also records each audited bucket's CHAIN COMPLETENESS
    (r20): whether its recorded causal chain is complete or still
    truncated-at-wrap (`chain_complete`). With `full_chain=True` each
    audited replay additionally runs the time-travel hook
    (`replay_bucket(full_chain=True, window_trace=True)`) — truncated
    buckets are upgraded to their complete chain and gain a focused
    window trace as they rotate through the audit."""
    from ..service.store import StoreMismatch
    from .campaign import replay_bucket
    store = _as_store(store_or_dir)
    ledger = load_audit(store)
    keys = store.bucket_keys()
    audited = []
    if keys:
        # rotation resumes AFTER the last audited KEY, not at a numeric
        # index: buckets opened between calls shift every index in the
        # sorted list, and an index cursor would re-audit some buckets
        # while starving the ones that were next in line
        import bisect
        cursor_key = ledger.get("cursor_key", "")
        start = bisect.bisect_right(keys, cursor_key) % len(keys)
        todo = [keys[(start + i) % len(keys)]
                for i in range(min(int(budget), len(keys)))]
        for key in todo:
            rec = store.load_bucket(key)
            try:
                crashed, code, _ = replay_bucket(
                    rt, store.dir, key, max_steps, chunk=chunk,
                    dup_slots=dup_slots, verify=True,
                    full_chain=full_chain, window_trace=full_chain)
                status = "pass" if crashed else "fail"
                note = None
            except StoreMismatch:
                raise
            except Exception as e:  # noqa: BLE001 - per-bucket verdict
                status, code = "flaky", None
                note = f"{type(e).__name__}: {e}"
            if full_chain:
                rec = store.load_bucket(key)   # may have been upgraded
            b = ledger["buckets"].setdefault(
                key, {"audits": 0, "pass": 0, "fail": 0, "flaky": 0})
            b["audits"] += 1
            b[status] += 1
            b["status"] = status
            b["expected_code"] = int(rec["crash_code"])
            b["last_code"] = None if code is None else int(code)
            # is the bucket's recorded chain the WHOLE story, or still
            # cut at ring wrap? (pre-r20 records without the flag fall
            # back to the fingerprint's depth-capped completeness bit)
            ct = rec.get("chain_truncated")
            b["chain_complete"] = (
                (not ct) if ct is not None
                else bool(rec["fingerprint"].get("complete", False)))
            if note is not None:
                b["note"] = note
            elif "note" in b:
                del b["note"]
            audited.append(dict(bucket=key, status=status, code=code,
                                chain_complete=b["chain_complete"]))
        ledger["cursor_key"] = todo[-1]
        ledger.pop("cursor", None)
    os.makedirs(store.triage_dir(), exist_ok=True)
    _atomic_bytes(audit_path(store),
                  (json.dumps(ledger, sort_keys=True, indent=1)
                   + "\n").encode())
    return dict(audited=audited,
                counts={s: sum(1 for a in audited if a["status"] == s)
                        for s in ("pass", "fail", "flaky")},
                cursor_key=ledger.get("cursor_key", ""), ledger=ledger)
