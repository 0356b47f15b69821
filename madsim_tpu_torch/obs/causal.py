"""Causal lineage: happens-before edges, crash explanation, divergence
depth (the counterpart of `madsim_tpu.obs.causal`).

The flight recorder answers *what* a lane dispatched; the lineage layer
answers *why*: every recorded event carries `parent` — the dispatch index
of the step that ENQUEUED it (-1 = external: a scenario row, a node boot,
a host-injected op) — and `lamport`, the acting node's Lamport clock
after the dispatch (clock = max(own, carried) + 1; the carried timestamp
rides in the event table's `ev_prov` provenance pair). Parent edges form
the happens-before DAG of the trajectory; walking them backward from a
crash yields the minimal causal chain that produced it.

Wrap contract: `parent` is a DISPATCH INDEX, not a ring slot, so it stays
meaningful after the ring wraps. A parent index either still sits in the
ring (the edge resolves) or was overwritten by wrap (the chain reports
`truncated=True` and stops there): a chain can be trusted as far as it
goes.

Everything here is host-side numpy over a `ring_records()` read, except
window replay (`explain_crash(replay=True)`, obs/timetravel.py), which
re-runs the lane from a harvested checkpoint.
"""

from __future__ import annotations

import hashlib

import numpy as np

from .rings import ring_records

# record fields copied into chain/edge dicts (lineage pair included)
_FIELDS = ("step", "now", "kind", "node", "src", "tag", "parent", "lamport")

# how many chain records (counted back from the crash dispatch) the
# fingerprint covers by default — deep enough to separate bugs that share
# a crash code, shallow enough that modest rings still reach full depth
FINGERPRINT_DEPTH = 8


def _rec_at(recs: dict, i: int) -> dict:
    return {k: int(recs[k][i]) for k in _FIELDS if k in recs}


def walk_lineage(recs: dict, from_step: int | None = None) -> dict:
    """Walk parent edges backward through one lane's ring — the shared
    spine of crash explanation (`explain_crash`) and green-support
    extraction (`obs/support.py`), factored out so the two cannot drift.

    `recs` is a `ring_records()` dict; `from_step` the DISPATCH INDEX to
    start from (default: the lane's last recorded dispatch). Returns
      chain          event records, OLDEST first, ENDING at `from_step`
      truncated      walk hit a parent overwritten by ring wrap — the
                     chain is a faithful SUFFIX of the full one
      root_external  walk reached parent == -1 (scenario row / boot /
                     host injection): the chain is causally complete

    Raises ValueError on a pre-r10 ring (no lineage columns), an empty
    ring, or a `from_step` the ring does not hold.
    """
    if "parent" not in recs:
        raise ValueError("no lineage columns: state predates r10 or was "
                         "built without cfg.trace_cap > 0")
    steps = np.asarray(recs["step"])
    n = len(steps)
    if n == 0:
        raise ValueError("empty ring — nothing to walk "
                         "(did the lane ever dispatch?)")
    by_step = {int(s): i for i, s in enumerate(steps)}
    if from_step is None:
        i = n - 1                          # the lane's last dispatch
    elif int(from_step) in by_step:
        i = by_step[int(from_step)]
    else:
        raise ValueError(f"dispatch step {from_step} is not in the ring "
                         "(overwritten by wrap, or never recorded)")
    chain = []
    truncated = False
    root_external = False
    while True:
        chain.append(_rec_at(recs, i))
        parent = int(recs["parent"][i])
        if parent < 0:
            root_external = True
            break
        if parent not in by_step:          # overwritten by ring wrap
            truncated = True
            break
        i = by_step[parent]
    chain.reverse()
    return dict(chain=chain, truncated=truncated,
                root_external=root_external)


def happens_before(recs: dict) -> list[tuple[int, int]]:
    """The resolvable happens-before edges of one lane's ring, as
    (parent_step, child_step) dispatch-index pairs. `recs` is a
    `ring_records()` dict; edges whose parent was overwritten by ring
    wrap (or is external, parent == -1) are omitted — they exist in the
    execution, just not in the surviving window."""
    if "parent" not in recs:
        raise ValueError("no lineage columns: state predates r10 or was "
                         "built without cfg.trace_cap > 0")
    steps = np.asarray(recs["step"])
    present = set(steps.tolist())
    return [(int(p), int(c)) for p, c in zip(recs["parent"], steps)
            if int(p) >= 0 and int(p) in present]


def explain_crash(state, lane: int = 0, *, replay: bool = False,
                  rt=None, ckpts=None, max_steps: int = 100_000,
                  chunk: int = 512, trace_cap: int | None = None,
                  export_trace: str | None = None) -> dict:
    """Walk parent edges backward from a lane's last recorded dispatch —
    for a crashed lane, the crash dispatch (the invariant/deadlock check
    runs inside the same step it implicates) — to the minimal causal
    chain the ring still holds.

    Returns a dict:
      chain       list of event records, OLDEST first, ENDING at the
                  crash dispatch; each carries step/now/kind/node/src/
                  tag/parent/lamport
      truncated   True when the walk hit a parent overwritten by ring
                  wrap (the chain is a faithful SUFFIX of the full one)
      root_external  True when the chain reached a parent of -1 — an
                  external cause (scenario row / node boot / injection)
      crashed / crash_code / crash_node   the lane's crash verdict
      lane, dropped   lane index and ring-wrap overwrite count

    replay=True does not settle for the truncated suffix: pass the
    runtime (`rt=`) and the sweep's harvested `ckpts=` (an
    obs.timetravel.CheckpointLog from `run(ckpt_every=...)`) and the
    chain is recovered by window replay from the nearest checkpoint with
    a ring that holds the whole window (`truncated=False` whenever a
    checkpoint precedes the chain's root), checked against the live lane
    on fingerprint and crash verdict; `export_trace=` writes a Perfetto
    trace of the window. The replayed chain stays bucket-compatible with
    the live truncated one (`fingerprints_match`).

    Raises (via ring_records) if the ring is compiled out or the lane
    was not sampled; raises ValueError on an empty ring or a pre-r10
    state without lineage columns.
    """
    if replay:
        if rt is None:
            raise ValueError("explain_crash(replay=True) needs rt= (and "
                             "usually ckpts= — a CheckpointLog harvested "
                             "with run(ckpt_every=...))")
        from .timetravel import time_travel_explain
        return time_travel_explain(rt, state, lane, ckpts=ckpts,
                                   max_steps=max_steps, chunk=chunk,
                                   trace_cap=trace_cap,
                                   export_trace=export_trace)
    recs = ring_records(state, lane)
    try:
        walk = walk_lineage(recs)
    except ValueError as e:
        if "empty ring" in str(e):
            raise ValueError(f"lane {lane} recorded no events — nothing "
                             "to explain (did the lane ever dispatch?)")
        raise

    def _lane_scalar(leaf):
        return (leaf[lane] if leaf.ndim else leaf).item()

    return dict(
        chain=walk["chain"],
        truncated=walk["truncated"],
        root_external=walk["root_external"],
        crashed=bool(_lane_scalar(state.crashed)),
        crash_code=int(_lane_scalar(state.crash_code)),
        crash_node=int(_lane_scalar(state.crash_node)),
        lane=int(lane),
        dropped=int(recs["dropped"]),
    )


def _chain_tokens(chain: list[dict]) -> list[tuple]:
    """The lane- and wrap-invariant content of a chain record: what the
    event WAS (kind/node/src/tag), never WHEN it ran (step, now, lamport
    are all shifted by seed and wrap point — hashing them would split one
    bug into a bucket per lane)."""
    return [(int(c["kind"]), int(c["node"]), int(c["src"]), int(c["tag"]))
            for c in chain]


def _digest(crash_sig: tuple, toks: list[tuple], marker: str = "") -> str:
    blob = repr((crash_sig, toks, marker)).encode()
    return hashlib.sha256(blob).hexdigest()[:16]


def causal_fingerprint(exp: dict, depth: int = FINGERPRINT_DEPTH) -> dict:
    """Hash an `explain_crash` chain into a crash-dedup fingerprint:
    one bug = one bucket, across lanes, seeds, and processes.

    The chain is consumed SUFFIX-first (the records nearest the crash),
    because that end is wrap-stable: ring wrap truncates chains at the
    ROOT end, so two observations of one bug truncated at different wrap
    points share their deepest suffix (obs/causal.py wrap contract — a
    chain is always a faithful suffix). The fingerprint therefore covers
    the last `depth` records plus the crash verdict (code, node), and
    carries the ladder of progressive suffix digests so a SHORTER
    truncated chain of the same bug can still be matched to the bucket
    (`fingerprints_match`) instead of opening a second one.

    The `truncated` flag is folded in honestly, as COMPLETENESS: a chain
    that reached its external root within `depth` records hashes a root
    marker (its causal history is the whole story), while a chain cut by
    wrap truncation — or by the depth cap itself — does not. Two complete
    chains of different length are different bugs even when their
    suffixes agree; a cut chain can never be distinguished from a deeper
    one on suffix evidence alone, so it matches by deepest common suffix.

    Returns {key, suffix_hashes, depth, complete, crash_code, crash_node,
    kind="causal"}: `key` is the canonical bucket id for THIS observation
    (the deepest digest, root marker folded in when complete), and
    `suffix_hashes[k-1]` the digest of the last k records — the match
    ladder. Raises ValueError on an empty chain.
    """
    chain = exp["chain"]
    if not chain:
        raise ValueError("cannot fingerprint an empty causal chain")
    crash_sig = (int(exp["crash_code"]), int(exp["crash_node"]))
    toks = _chain_tokens(chain)[-depth:]
    complete = (bool(exp["root_external"]) and not bool(exp["truncated"])
                and len(chain) <= depth)
    suffix_hashes = [_digest(crash_sig, toks[len(toks) - k:])
                     for k in range(1, len(toks) + 1)]
    key = _digest(crash_sig, toks, marker="root" if complete else "cut")
    return dict(key=key, suffix_hashes=suffix_hashes, depth=len(toks),
                complete=complete, crash_code=crash_sig[0],
                crash_node=crash_sig[1], kind="causal")


def code_fingerprint(crash_code: int, crash_node: int) -> dict:
    """The degraded fingerprint for lineage-less builds (cfg.trace_cap ==
    0): dedup by crash verdict alone. Same schema as `causal_fingerprint`
    so bucket stores handle both; `kind="code"` marks the lower
    resolution (distinct bugs sharing a code WILL share a bucket)."""
    key = f"code-{int(crash_code):08x}-n{int(crash_node)}"
    return dict(key=key, suffix_hashes=[], depth=0, complete=False,
                crash_code=int(crash_code), crash_node=int(crash_node),
                kind="code")


def race_fingerprint(cand: dict, diff: dict | None = None) -> dict:
    """Fingerprint a CONFIRMED schedule race (analyze/races.py) for
    bucket dedup: the same token pair at the same node is the same
    finding across lanes, seeds, nudges, and workers. The pair is
    order-normalized (a race is symmetric in its two events — the
    observed order is an artifact of which schedule was seen first)
    and hashes only the events' wrap-stable identity tokens, never
    step/now/lamport (`_chain_tokens` rationale).

    Same schema as `causal_fingerprint` so `service/buckets.py` stores
    and `merged_buckets` folds it unchanged; `kind="race"` matches by
    key equality only (`fingerprints_match` treats non-causal kinds
    that way). `crash_code`/`crash_node` carry the COMMUTED outcome's
    verdict when `diff` is given (what the race flips the run into) —
    0/-1 for races confirmed by fingerprint divergence alone."""
    ta = tuple(int(cand["a"][k]) for k in ("kind", "node", "src", "tag"))
    tb = tuple(int(cand["b"][k]) for k in ("kind", "node", "src", "tag"))
    toks = sorted((ta, tb))
    commuted = (diff or {}).get("commuted", {})
    code = int(commuted.get("crash_code", 0))
    node = int(commuted.get("crash_node", -1))
    key = "race-" + _digest((int(cand["node"]),), toks, marker="race")
    return dict(key=key, suffix_hashes=[], depth=2, complete=True,
                crash_code=code, crash_node=node, kind="race")


def fingerprints_match(a: dict, b: dict) -> bool:
    """Whether two fingerprints denote the same bug — the deepest-common-
    suffix rule. Equal keys always match. Otherwise two causal
    fingerprints match when their suffix digests agree at the deepest
    depth BOTH observed, unless both chains are complete (both reached
    their external root: different depths then mean genuinely different
    causal histories, not different wrap points)."""
    if a["key"] == b["key"]:
        return True
    if a.get("kind") != "causal" or b.get("kind") != "causal":
        return False
    if a["complete"] and b["complete"]:
        return False
    # a cut chain as long as (or longer than) a complete one cannot be
    # the same bug: the complete chain is the bug's WHOLE history, and a
    # cut chain always hides at least one more record than it shows
    # (truncation fires only when a parent existed but was overwritten,
    # and the depth cap only when deeper records existed) — so a same-bug
    # cut observation is strictly shorter than the complete chain
    if a["complete"] and b["depth"] >= a["depth"]:
        return False
    if b["complete"] and a["depth"] >= b["depth"]:
        return False
    m = min(a["depth"], b["depth"])
    if m == 0:
        return False
    return a["suffix_hashes"][m - 1] == b["suffix_hashes"][m - 1]


def sketch_divergence(state, lane_a: int, lane_b: int) -> dict:
    """Where two lanes' schedules first diverged, from their on-device
    prefix-coverage sketches (cfg.sketch_slots > 0). Returns
    {slot, step_bound, every, slots, bound}: `slot` is the first sketch
    index where the lanes differ, `step_bound` the corresponding upper
    bound on the first divergent dispatch index — the lanes' first
    `slot * every` dispatches hashed identically.

    `bound` names WHICH kind of answer this is, instead of callers
    inferring it from `slot == slots` (the r20 small fix):
      "sketch-slot"  a recorded slot genuinely differs — `step_bound`
                     is a real divergence bound;
      "exhausted"    NO recorded checkpoint differs (identical
                     schedules within the sketch window, or divergence
                     past slot `slots`, or the lanes halted before
                     filling the differing slot) — `slot == slots` and
                     `step_bound` is only the end of the recorded
                     window, NOT evidence of divergence.
    Consumers that need a true step: the divergence microscope
    (obs/timetravel.divergence_report) refines "sketch-slot" to an
    exact checkpoint-step by window replay and falls back to the whole
    run on "exhausted"."""
    # int32 bit patterns of the JAX package's uint32 sketches: equal
    # exactly where the uint32 values are
    sk = state.cov_sketch.cpu().numpy()
    if sk.ndim != 2 or sk.shape[1] == 0:
        raise ValueError("prefix sketch is compiled out "
                         "(cfg.sketch_slots == 0) or state is unbatched")
    every = int(np.atleast_1d(state.sketch_every.cpu().numpy())
                .reshape(-1)[0])
    a, b = sk[lane_a], sk[lane_b]
    differs = a != b
    slots = sk.shape[1]
    found = bool(differs.any())
    slot = int(differs.argmax()) if found else slots
    return dict(slot=slot, step_bound=(slot + 1) * every, every=every,
                slots=slots,
                bound="sketch-slot" if found else "exhausted")
