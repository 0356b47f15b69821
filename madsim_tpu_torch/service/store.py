"""The durable corpus store: a fuzzing campaign that survives its process.

The counterpart of `madsim_tpu.service.store`: host Python, the same names
and the same file bytes, so a store written by either package opens in
the other.

madsim's determinism core makes distributed crash harvests mergeable BY
CONSTRUCTION — a `(seed, knobs)` pair reproduces an entire execution, so
two workers' corpora are just two sets of replayable handles keyed by
coverage (PAPER.md). This module turns the r9 in-memory `search.Corpus`
into that durable, mergeable artifact: a directory any number of worker
processes share, written with the same versioned reject-on-mismatch
contract as `runtime/checkpoint.py` and read back into a campaign that
resumes exactly where it left off.

Layout (one campaign = one directory):

  MANIFEST.json           format + version + structural signature —
                          validated on open, REJECTED on mismatch (the
                          checkpoint contract: silently merging corpora
                          from different structures would poison both)
  entries/w<w>-<c>.npz    one admitted corpus entry per file, IMMUTABLE
                          once renamed into place: knob arrays + coverage
                          key (sched_hash) + admission metadata. The file
                          name IS the namespaced entry id (worker w,
                          counter c), so cross-process merge is lock-free
                          set union — no two workers can mint the same
                          name, and a scan is a dedup-by-construction
                          merge (search/corpus.py `admit_foreign`)
  state/w<w>.json         one worker's scheduler state: rounds done, rng
                          state, live-entry order + CURRENT energies,
                          cross-round consensus sketch counters — energy
                          and rng are per-worker POLICY state; coverage
                          (the entry files) is the shared campaign truth
  state/g<w>.json         a MESH-SHARDED worker's group state (r13):
                          every shard's scheduler state plus the
                          cross-shard consensus tally, committed by ONE
                          rename per sync so a kill can never tear the
                          shards of one worker apart (shard s mints
                          entries in namespace w*shards+s — just more
                          worker ids to everyone else; because that
                          mapping numerically overlaps plain worker
                          ids, fuzz/fuzz_sharded refuse at open any
                          namespace another owner's state claims —
                          `claimed_namespaces`)
  buckets/<key>.json|.npz|.trace.json
                          crash buckets (service/buckets.py): fingerprint
                          record, minimal (seed, knobs) repro, Perfetto
                          trace of the crash lane
  buckets.jsonl           append-only observation log (one line per
                          bucketed crash observation; the bucket DIR is
                          the deduped truth, this is the rate telemetry)
  logs/w<w>.jsonl         per-worker SweepObserver records (fuzz rounds)
  metrics/w<w>.jsonl      per-worker campaign-timeline rows (r15): one
  metrics/g<w>.jsonl      append per durability sync (sharded groups use
                          the g-prefix), fsync'd, carrying
                          (t, rounds_done, coverage, seeds_run, crashes,
                          corpus_size, wall_s, op_yield). Appended BEFORE
                          the state sync, so a kill between the two
                          re-appends an identical row on resume —
                          `campaign_timeline` dedups by rounds_done, so
                          the durable timeline has no gaps and no double
                          counts, and a campaign is inspectable after
                          the fact without a live poller
                          (service/campaign.py `campaign_report`)

Atomicity: every file is written to a `.tmp-<pid>` sibling and
`os.replace`d into place, so a SIGKILL at any instant leaves either the
old file or the new one, never a torn read — loaders additionally skip
tmp names outright. A kill mid-SYNC (some entry files renamed, the state
json not yet) is repaired on resume: own-namespace entry files whose
counter is at or past the state's `next_counter` are ignored (the
interrupted round re-runs deterministically and rewrites them with
identical bytes), so resume converges to exactly the uninterrupted run.
"""

from __future__ import annotations

import json
import os
import re
import tempfile
import zipfile

import numpy as np

from ..search.corpus import _ID_SHIFT, Corpus, split_entry_id

CORPUS_FORMAT = "madsim-corpus"
CORPUS_VERSION = 1

_TMP_MARK = ".tmp-"


class StoreMismatch(ValueError):
    """Corpus dir was written by a different format version or a
    structurally different runtime — resuming would corrupt both."""


# ---------------------------------------------------------------------------
# atomic write primitives (write-then-rename; the whole durability story)
# ---------------------------------------------------------------------------

def _atomic_bytes(path: str, data: bytes) -> None:
    d = os.path.dirname(path)
    fd, tmp = tempfile.mkstemp(dir=d, prefix=os.path.basename(path)
                               + _TMP_MARK)
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(data)
            # fsync data before the rename and the directory after it:
            # SIGKILL-safety needs only the rename, but the durability
            # claim covers power loss, where an unsynced rename can
            # reach disk before the data blocks (zero-length "new" file)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        dfd = os.open(d or ".", os.O_RDONLY)
        try:
            os.fsync(dfd)
        finally:
            os.close(dfd)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def _atomic_json(path: str, obj) -> None:
    _atomic_bytes(path, (json.dumps(obj, indent=1) + "\n").encode())


def _atomic_npz(path: str, arrays: dict) -> None:
    import io
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    _atomic_bytes(path, buf.getvalue())


# the header `np.save` writes for a C-ordered array of a plain dtype
_NPY_HEADER = re.compile(rb"\{'descr': '([^']*)', 'fortran_order': False, "
                         rb"'shape': \(([0-9, ]*)\), \}")


def _read_npz(path: str) -> dict:
    """{member: owned array} of an `np.savez` file, in member order: the
    values `np.load` gives, read ~3x faster (the header parsed by one
    regex instead of `ast`), since a triage snapshot or a corpus load
    reads every entry file of a campaign. Anything but a version 1-3 npy
    of a plain dtype in C order goes through `np.load`."""
    out = {}
    with zipfile.ZipFile(path) as z:
        for info in z.infolist():
            data = z.read(info)
            m = None
            if data[:6] == b"\x93NUMPY" and data[6] in (1, 2, 3):
                off = 10 if data[6] == 1 else 12
                hlen = int.from_bytes(data[8:off], "little")
                m = _NPY_HEADER.match(data[off:off + hlen])
            if m is None or m.group(1).startswith(b"|O"):
                with np.load(path) as whole:
                    return {k: np.array(whole[k]) for k in whole.files}
            shape = tuple(int(x) for x in m.group(2).split(b",")
                          if x.strip())
            a = np.frombuffer(data, np.dtype(m.group(1).decode()),
                              count=int(np.prod(shape, dtype=np.int64)),
                              offset=off + hlen)
            out[info.filename[:-4]] = a.reshape(shape).copy()
    return out


def _is_tmp(name: str) -> bool:
    return _TMP_MARK in name


# ---------------------------------------------------------------------------
# signature
# ---------------------------------------------------------------------------

def store_signature(rt, plan) -> list:
    """The structural identity a corpus dir is bound to: the step
    program's structural signature (compile domain, DESIGN §10) plus the
    knob-vector schema (shapes/dtypes of everything an entry stores).
    Dynamic knobs (time_limit, exact latencies, ...) deliberately do NOT
    key the store — they ride inside entries, the same split that lets
    one captured step serve many configs. The same config gives the
    same signature in both packages (`SimConfig.structural_signature`,
    the knob dtypes), so either opens the other's store."""
    knobs = plan.base_knobs()
    return [
        "corpus-sig-v1",
        list(rt.cfg.structural_signature()),
        [int(plan.n_init), int(plan.R), int(plan.D), int(plan.N),
         int(plan.payload_words), bool(plan.jitter_gate)],
        [[k, list(np.asarray(v).shape), str(np.asarray(v).dtype)]
         for k, v in sorted(knobs.items())],
    ]


def _norm(sig) -> str:
    return json.dumps(sig, sort_keys=True)


# ---------------------------------------------------------------------------
# the store
# ---------------------------------------------------------------------------

class CorpusStore:
    def __init__(self, corpus_dir: str, signature=None, create: bool = True):
        self.dir = os.path.abspath(corpus_dir)
        self.entries_dir = os.path.join(self.dir, "entries")
        self.state_dir = os.path.join(self.dir, "state")
        self.buckets_dir = os.path.join(self.dir, "buckets")
        self.logs_dir = os.path.join(self.dir, "logs")
        self.metrics_dir = os.path.join(self.dir, "metrics")
        manifest_path = os.path.join(self.dir, "MANIFEST.json")
        if create:
            for d in (self.entries_dir, self.state_dir, self.buckets_dir,
                      self.logs_dir, self.metrics_dir):
                os.makedirs(d, exist_ok=True)
        if os.path.exists(manifest_path):
            with open(manifest_path) as f:
                man = json.load(f)
            if man.get("format") != CORPUS_FORMAT:
                raise StoreMismatch(
                    f"{self.dir} is not a corpus dir "
                    f"(format={man.get('format')!r})")
            if man.get("version") != CORPUS_VERSION:
                raise StoreMismatch(
                    f"corpus format version {man.get('version')} != "
                    f"supported {CORPUS_VERSION} — refusing to merge "
                    "across formats; start a fresh dir (or migrate)")
            if signature is not None and _norm(man.get("signature")) \
                    != _norm(json.loads(json.dumps(signature))):
                raise StoreMismatch(
                    "corpus dir was written by a structurally different "
                    "runtime/knob-plan — entries would not be replayable "
                    "here. Expected signature:\n  "
                    f"{_norm(signature)}\nfound:\n  "
                    f"{_norm(man.get('signature'))}")
            self.signature = man.get("signature")
        else:
            if not create:
                raise FileNotFoundError(f"no corpus at {self.dir}")
            if signature is None:
                raise ValueError("creating a corpus dir needs a signature "
                                 "(store_signature(rt, plan))")
            self.signature = json.loads(json.dumps(signature))
            _atomic_json(manifest_path, dict(
                format=CORPUS_FORMAT, version=CORPUS_VERSION,
                signature=self.signature))
        # filenames already folded into the live corpus (merge cursor)
        self._scanned: set[str] = set()
        # entry files are IMMUTABLE once renamed into place, so their
        # coverage keys cache forever on a store handle — keeps the
        # campaign driver's poll loop O(new entries), not O(corpus)
        self._hash_cache: dict[str, int] = {}
        # triage-plane sibling cache (r18, service/triage.py): per entry
        # file, (coverage hash, recipe family) — same immutability
        # argument, so repeated snapshots off one handle re-read each
        # raw entry file at most once (O(new files), like the poll loop)
        self._triage_cache: dict[str, tuple] = {}

    # -- naming --------------------------------------------------------
    @staticmethod
    def _entry_name(eid: int) -> str:
        w, c = split_entry_id(eid)
        return f"w{w:04d}-{c:012d}.npz"

    @staticmethod
    def _parse_entry_name(name: str) -> int | None:
        if not (name.startswith("w") and name.endswith(".npz")) \
                or _is_tmp(name):
            return None
        try:
            w, c = name[1:-4].split("-")
            return (int(w) << _ID_SHIFT) | int(c)
        except ValueError:
            return None

    def worker_state_path(self, worker_id: int) -> str:
        return os.path.join(self.state_dir, f"w{worker_id:04d}.json")

    def shard_group_path(self, worker_id: int) -> str:
        """A mesh-sharded worker's GROUP state (r13, search/shard.py):
        all of its shards' scheduler states in one file, written by one
        atomic rename — a SIGKILL can never tear the shards of one
        worker apart. Named g<id>, not w<id>, so a plain fuzz() worker
        scanning the dir never mistakes a group file for its own state
        (the shard namespaces are disjoint from base worker ids by the
        worker_id*shards+s mapping, so entries can't collide either)."""
        return os.path.join(self.state_dir, f"g{worker_id:04d}.json")

    def worker_log_path(self, worker_id: int) -> str:
        return os.path.join(self.logs_dir, f"w{worker_id:04d}.jsonl")

    def metrics_path(self, worker_id: int, group: bool = False) -> str:
        return os.path.join(self.metrics_dir,
                            f"{'g' if group else 'w'}{worker_id:04d}.jsonl")

    # -- campaign timeline (r15) ---------------------------------------
    def append_metrics(self, worker_id: int, rec: dict,
                       group: bool = False) -> None:
        """Append one campaign-timeline row for this worker (fsync'd:
        the timeline must be trustworthy under SIGKILL respawns —
        single-line O_APPEND writes are atomic on POSIX at this size).
        Called right BEFORE the state sync it describes; see the layout
        docstring for the dedup contract that ordering buys."""
        os.makedirs(self.metrics_dir, exist_ok=True)
        with open(self.metrics_path(worker_id, group), "a") as f:
            f.write(json.dumps(rec) + "\n")
            f.flush()
            os.fsync(f.fileno())

    def read_metrics(self) -> dict:
        """{worker label: [timeline rows, file order]} for every worker
        (and g<id> sharded group) that ever appended. Unparseable tail
        lines (a torn write under power loss — O_APPEND makes this
        unlikely, fsync ordering makes it harmless) are skipped."""
        out: dict[str, list] = {}
        try:
            names = sorted(os.listdir(self.metrics_dir))
        except FileNotFoundError:
            return out
        for n in names:
            if not n.endswith(".jsonl") or _is_tmp(n):
                continue
            rows = []
            with open(os.path.join(self.metrics_dir, n)) as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        rows.append(json.loads(line))
                    except ValueError:
                        continue
            out[n[:-6]] = rows
        return out

    # -- entries -------------------------------------------------------
    def write_entry(self, entry: dict) -> None:
        """Persist one corpus entry (immutable admission record). Safe to
        re-run: a deterministic re-execution of an interrupted round
        rewrites the same name with identical content."""
        arrays = {f"knob_{k}": np.asarray(v)
                  for k, v in entry["knobs"].items()}
        arrays.update(
            id=np.int64(entry["id"]),
            hash=np.uint64(entry["hash"]),
            seed=np.int64(entry["seed"]),
            energy0=np.float64(entry["energy"]),
            round=np.int64(entry["round"]),
            div_slot=np.int64(-1 if entry.get("div_slot") is None
                              else entry["div_slot"]),
            crash_code=np.int64(entry.get("crash_code", 0)))
        # ADDITIVE r22 field: only lineage-targeted admissions carry an
        # origin member at all — a campaign without the LDFI arm writes
        # byte-identical files to a pre-r22 store, and pre-r22 readers
        # ignore unknown members by construction (np.load key access)
        if entry.get("origin"):
            arrays["origin"] = np.str_(entry["origin"])
        _atomic_npz(os.path.join(self.entries_dir,
                                 self._entry_name(entry["id"])), arrays)

    def load_entry(self, name: str) -> dict:
        z = _read_npz(os.path.join(self.entries_dir, name))
        knobs = {k[5:]: v for k, v in z.items() if k.startswith("knob_")}
        div = int(z["div_slot"])
        out = dict(id=int(z["id"]), hash=int(z["hash"]),
                   seed=int(z["seed"]), energy=float(z["energy0"]),
                   round=int(z["round"]),
                   div_slot=None if div < 0 else div,
                   crash_code=int(z["crash_code"]), knobs=knobs)
        if "origin" in z:
            out["origin"] = str(z["origin"])
        return out

    def entry_names(self) -> list[str]:
        try:
            names = os.listdir(self.entries_dir)
        except FileNotFoundError:
            return []
        return sorted(n for n in names
                      if self._parse_entry_name(n) is not None)

    # -- worker state --------------------------------------------------
    def load_worker_state(self, worker_id: int) -> dict:
        p = self.worker_state_path(worker_id)
        if not os.path.exists(p):
            return {}
        with open(p) as f:
            return json.load(f)

    @staticmethod
    def _scheduler_state(corpus: Corpus) -> dict:
        """One corpus's serialized scheduler state — the per-worker (or
        per-shard) half of a state file: live-entry order + CURRENT
        energies, namespace counter, rng, consensus counters."""
        return dict(
            next_counter=split_entry_id(corpus._next_id)[1],
            order=[[int(e["id"]), float(e["energy"])]
                   for e in corpus.entries],
            crash_codes=sorted(int(c) for c in corpus.crash_codes),
            sketch_counts=(None if corpus._slot_counts is None else
                           [sorted((int(v), int(c)) for v, c in s.items())
                            for s in corpus._slot_counts]),
            rng_state=corpus.rng.bit_generator.state)

    def write_worker_state(self, corpus: Corpus, worker_id: int,
                           rounds_done: int, dry: int, op_hist,
                           wall_s: float, op_yield=None,
                           targeted_yield=None) -> None:
        self._write_own_entries(corpus, worker_id)
        st = dict(
            worker_id=int(worker_id),
            rounds_done=int(rounds_done),
            dry=int(dry),
            wall_s=float(wall_s),
            op_hist=[int(x) for x in np.asarray(op_hist)],
            op_yield=(None if op_yield is None
                      else [int(x) for x in np.asarray(op_yield)]),
            **self._scheduler_state(corpus))
        if targeted_yield is not None:
            # additive r22 counter (LDFI campaigns only): cumulative
            # targeted admissions — absent ⇒ byte-identical pre-r22 json
            st["targeted_yield"] = int(targeted_yield)
        _atomic_json(self.worker_state_path(worker_id), st)

    def write_shard_group_state(self, corpora, worker_id: int, shards: int,
                                rounds_done: int, dry: int, op_hist,
                                wall_s: float, tally=None,
                                op_yield=None,
                                targeted_yield=None) -> None:
        """Persist a sharded worker's WHOLE group as one atomic write:
        per-shard scheduler states (namespaced worker_id*shards+s), the
        shared round/dry/wall counters, and the cross-shard consensus
        tally. Top-level rounds_done/wall_s keep campaign_stats readers
        working unchanged. Entry files must already be on disk
        (`persist_entries` per shard) — the group json is the commit
        point, exactly like a worker state. `targeted_yield` (r22) is
        the group's cumulative targeted-arm admission count — written
        only when the campaign aimed (additive; ldfi-less group jsons
        stay byte-identical)."""
        st = dict(
            worker_id=int(worker_id),
            shards=int(shards),
            rounds_done=int(rounds_done),
            dry=int(dry),
            wall_s=float(wall_s),
            op_hist=[int(x) for x in np.asarray(op_hist)],
            op_yield=(None if op_yield is None
                      else [int(x) for x in np.asarray(op_yield)]),
            tally=(None if tally is None else
                   [sorted((int(v), int(c)) for v, c in s.items())
                    for s in tally]),
            shard_states=[
                dict(worker_id=int(c.worker_id),
                     **self._scheduler_state(c))
                for c in corpora])
        if targeted_yield is not None:
            st["targeted_yield"] = int(targeted_yield)
        _atomic_json(self.shard_group_path(worker_id), st)

    def load_shard_group_state(self, worker_id: int) -> dict:
        p = self.shard_group_path(worker_id)
        if not os.path.exists(p):
            return {}
        with open(p) as f:
            return json.load(f)

    def persist_entries(self, corpus: Corpus, worker_id: int) -> None:
        """Write this corpus's not-yet-persisted own-namespace
        admissions (the public entry-file half of a sync; the sharded
        driver commits the group state separately, in one write)."""
        self._write_own_entries(corpus, worker_id)

    def _write_own_entries(self, corpus: Corpus, worker_id: int) -> None:
        """Write any of this worker's admissions not yet on disk (ids in
        the worker's namespace whose file is new to this store handle) —
        including entries admitted AND evicted since the last sync, whose
        coverage keys must survive a resume."""
        for e in list(corpus.entries) + corpus.evicted_unsynced:
            if split_entry_id(e["id"])[0] != worker_id:
                continue
            name = self._entry_name(e["id"])
            if name in self._scanned:
                continue
            self.write_entry(e)
            self._scanned.add(name)
        corpus.evicted_unsynced.clear()

    # -- corpus load / merge -------------------------------------------
    def load_corpus(self, plan, worker_id: int = 0, rng_seed: int = 0,
                    state: dict | None = None, **corpus_kwargs) -> Corpus:
        """Rebuild this worker's corpus: its own scheduler state (entry
        order, current energies, rng, consensus counters) from the state
        json, its own coverage history from its entry files, and every
        OTHER worker's entries merged in (`admit_foreign`). A fresh dir
        returns a fresh corpus seeded with `rng_seed`. `state` overrides
        the on-disk worker json — the sharded driver passes one shard's
        slice of a group state (the shards share a file, not a schema)."""
        corpus = Corpus(plan, rng=np.random.default_rng(rng_seed),
                        worker_id=worker_id, **corpus_kwargs)
        corpus.track_evictions = True
        ws = self.load_worker_state(worker_id) if state is None else state
        order = ws.get("order", [])
        if ws:
            corpus.rng.bit_generator.state = ws["rng_state"]
            corpus._next_id = ((worker_id << _ID_SHIFT)
                               | int(ws["next_counter"]))
            corpus.crash_codes = set(ws.get("crash_codes", []))
            sk = ws.get("sketch_counts")
            if sk is not None:
                corpus._slot_counts = [
                    {int(v): int(c) for v, c in slot} for slot in sk]
            mirror = corpus._energy_mirror()
            for eid, energy in order:
                e = self.load_entry(self._entry_name(int(eid)))
                e["energy"] = float(energy)
                corpus._seen.add(e["hash"])
                corpus._insert(e, mirror)
        next_counter = int(ws.get("next_counter", 0))
        in_order = {int(eid) for eid, _ in order}
        for name in self.entry_names():
            eid = self._parse_entry_name(name)
            w, c = split_entry_id(eid)
            if w == worker_id:
                self._scanned.add(name)
                if eid in in_order:
                    continue        # already placed, in slot order
                if c >= next_counter:
                    # half-synced leftover of an interrupted round: the
                    # re-run regenerates it bit-identically — loading it
                    # now would fork the resumed corpus from the
                    # uninterrupted one
                    continue
                # admitted before the sync point but evicted since: its
                # coverage key must stay seen (eviction never forgets)
                corpus._seen.add(self.load_entry(name)["hash"])
            else:
                self._scanned.add(name)
                corpus.admit_foreign(self.load_entry(name))
        return corpus

    def merge_foreign(self, corpus: Corpus) -> int:
        """Fold entries other workers persisted since the last scan into
        the live corpus. Lock-free: entry files are immutable and
        namespaced, dedup is by coverage key."""
        admitted = 0
        for name in self.entry_names():
            if name in self._scanned:
                continue
            eid = self._parse_entry_name(name)
            if split_entry_id(eid)[0] == corpus.worker_id:
                continue            # own files are written, never merged
            self._scanned.add(name)
            if corpus.admit_foreign(self.load_entry(name)):
                admitted += 1
        return admitted

    def sync(self, corpus: Corpus, worker_id: int, rounds_done: int,
             dry: int, op_hist, wall_s: float, op_yield=None,
             targeted_yield=None) -> dict:
        """One durability point: merge other workers' new entries, then
        persist this worker's admissions and scheduler state. Called at
        round boundaries (fuzz(..., sync_every=)); everything between two
        syncs is re-derived deterministically on resume."""
        merged = self.merge_foreign(corpus)
        self.write_worker_state(corpus, worker_id, rounds_done, dry,
                                op_hist, wall_s, op_yield=op_yield,
                                targeted_yield=targeted_yield)
        return dict(merged_foreign=merged)

    # -- read-only reporting -------------------------------------------
    def worker_ids(self) -> list[int]:
        out = []
        for n in sorted(os.listdir(self.state_dir)):
            if n.startswith("w") and n.endswith(".json") \
                    and not _is_tmp(n):
                out.append(int(n[1:-5]))
        return out

    def claimed_namespaces(self) -> dict:
        """{worker-id namespace: owner label} for every namespace with
        scheduler state in this dir: a plain worker owns its own id, a
        shard group owns worker_id*shards+s for each of its shards.
        The shard↔worker mapping means a group's namespaces NUMERICALLY
        overlap plain worker ids (group 0 at 2 shards owns 0 and 1), so
        mixing plain and sharded workers carelessly on one dir would
        mint colliding entry files; fuzz()/fuzz_sharded() consult this
        map at open and refuse a namespace another owner already
        claimed. Best-effort (a check, not a lock): two workers racing
        their FIRST sync can still pass — the guard is for the
        misconfiguration, which persists, not the race window."""
        out = {}
        for w in self.worker_ids():
            out[w] = f"worker w{w}"
        for g in self.shard_group_ids():
            gs = self.load_shard_group_state(g)
            for sh in gs.get("shard_states", []):
                out[int(sh["worker_id"])] = f"shard group g{g}"
        return out

    def shard_group_ids(self) -> list[int]:
        """Base worker ids of mesh-sharded groups syncing into this dir
        (their g<id>.json files; campaign_stats folds these into the
        rollup next to plain worker states)."""
        out = []
        for n in sorted(os.listdir(self.state_dir)):
            if n.startswith("g") and n.endswith(".json") \
                    and not _is_tmp(n):
                out.append(int(n[1:-5]))
        return out

    def coverage_keys(self) -> set[int]:
        """The campaign's coverage frontier: every sched_hash any worker
        ever admitted (entry files are immutable admission records, so
        this is exact even across evictions; cached per file on this
        handle for the same reason)."""
        for n in self.entry_names():
            if n not in self._hash_cache:
                self._hash_cache[n] = self.load_entry(n)["hash"]
        return set(self._hash_cache.values())

    # -- triage plane (r18, service/triage.py) -------------------------
    def triage_dir(self) -> str:
        """The standing triage history subdir (ADDITIVE: no store schema
        bump — pre-r18 stores open cleanly and simply have no triage/
        yet). Holds numbered snapshots (NNNN.json), the scenario row
        table the recipe classifier needs (ROWS.json), and the
        repro-health audit ledger (AUDIT.json)."""
        return os.path.join(self.dir, "triage")

    def triage_rows_path(self) -> str:
        return os.path.join(self.triage_dir(), "ROWS.json")

    def write_triage_rows(self, plan) -> None:
        """Persist the base scenario ROW TABLE the recipe classifier
        reads (op codes + the classifier-relevant guards/flags) — the
        read side of attribution must not need the Runtime. Derived
        deterministically from the KnobPlan, so every worker writes
        identical bytes; skipped once present (write-once)."""
        p = self.triage_rows_path()
        if os.path.exists(p):
            return
        os.makedirs(self.triage_dir(), exist_ok=True)
        P = int(plan.payload_words)
        pay = np.asarray(plan.base["payload"])
        base_torn = (pay[:, P - 2] & 1 if P >= 2
                     else np.zeros(plan.R, np.int32))
        _atomic_bytes(p, (json.dumps(dict(
            op=[int(x) for x in np.asarray(plan.base["op"])],
            drop_ok=[bool(x) for x in np.asarray(plan.drop_ok)],
            torn_ok=[bool(x) for x in np.asarray(plan.torn_ok)],
            base_torn=[int(x) for x in base_torn]),
            sort_keys=True, indent=1) + "\n").encode())

    def load_triage_rows(self) -> dict | None:
        """The persisted row table, or None (pre-r18 store / no worker
        wrote it yet) — attribution then reports everything under the
        explicit `base` class instead of guessing."""
        try:
            with open(self.triage_rows_path()) as f:
                return json.load(f)
        except (FileNotFoundError, ValueError):
            return None

    # -- crash buckets (plumbing for service/buckets.py) ---------------
    def bucket_path(self, key: str, suffix: str = ".json") -> str:
        return os.path.join(self.buckets_dir, key + suffix)

    def bucket_keys(self) -> list[str]:
        try:
            names = os.listdir(self.buckets_dir)
        except FileNotFoundError:
            return []
        return sorted(n[:-5] for n in names
                      if n.endswith(".json")
                      and not n.endswith(".trace.json")
                      and not _is_tmp(n))

    def write_bucket(self, key: str, record: dict,
                     knobs: dict | None = None) -> None:
        if knobs is not None:
            _atomic_npz(self.bucket_path(key, ".npz"),
                        {f"knob_{k}": np.asarray(v)
                         for k, v in knobs.items()})
        _atomic_json(self.bucket_path(key), record)

    def load_bucket(self, key: str) -> dict:
        with open(self.bucket_path(key)) as f:
            return json.load(f)

    def load_bucket_repro(self, key: str) -> tuple[int, dict]:
        """(seed, knobs) — the full replay handle of a bucket's kept
        repro (a mutated lane's behavior needs both)."""
        rec = self.load_bucket(key)
        p = self.bucket_path(key, ".npz")
        with np.load(p) as z:
            knobs = {k[5:]: np.array(z[k]) for k in z.files
                     if k.startswith("knob_")}
        return int(rec["repro"]["seed"]), knobs

    def append_bucket_log(self, rec: dict) -> None:
        # single-line O_APPEND writes are atomic on POSIX at this size;
        # this is telemetry (rates), the bucket dir is the deduped truth
        with open(os.path.join(self.dir, "buckets.jsonl"), "a") as f:
            f.write(json.dumps(rec) + "\n")

    def bucket_log(self) -> list[dict]:
        p = os.path.join(self.dir, "buckets.jsonl")
        if not os.path.exists(p):
            return []
        out = []
        with open(p) as f:
            for line in f:
                line = line.strip()
                if line:
                    out.append(json.loads(line))
        return out

    def bucket_log_deduped(self) -> list[dict]:
        """The observation log with replayed duplicates collapsed:
        rows dedup by (fingerprint, worker, round), first kept. The
        append-only log gains an IDENTICAL line whenever a killed
        worker's interrupted round re-runs on resume (the append-
        before-sync ordering re-observes the same representative lane),
        and fuzz logs one representative per distinct code per round —
        so within one (fp, worker, round) a second line is always a
        replay artifact, never a new observation. Rate/observation
        consumers (campaign_stats, merged_buckets) fold THIS view; the
        raw log stays the forensic record."""
        seen: set[tuple] = set()
        out = []
        for line in self.bucket_log():
            k = (line.get("fp_key", line.get("bucket")),
                 line.get("worker_id"), line.get("round"))
            if k in seen:
                continue
            seen.add(k)
            out.append(line)
        return out
