"""Lineage-driven fault injection: aim the faults, don't spray them (the
counterpart of `madsim_tpu.search.ldfi`).

`fault_perturb` (mutate.py op 7) drifts fault values and toggles flags
BLIND — it has no idea which message ever mattered. The causal plane
already knows: a green lane's ring holds the exact (src → dst, instant)
message edges and (node, deadline) timer firings its success depended
on (`obs/support.py`). This module is the LDFI loop (Alvaro et al.)
over that knowledge, batched:

  1. POOL supports across green lanes (`SupportPool`) — each support is
     the edge set one successful trajectory needed.
  2. RANK cut candidates by a greedy minimal-hitting-set heuristic: the
     edge that appears in the most yet-uncovered supports is the edge
     whose loss the protocol has demonstrably not been tested against
     in the most distinct ways — cut it first.
  3. SYNTHESIZE targeted knob vectors: ordinary `KnobPlan` rows
     (OP_PARTITION_ONEWAY / OP_RESET_PEER / OP_SET_SKEW / OP_SET_DUP)
     whose times and targets come from the extracted edges.

Everything stays ON the knob plane (DESIGN §23): synthesis only writes
host knob dicts that `KnobPlan.apply` bounds-checks like any mutant —
times clip to [0, tlimit], out-of-pool targets fall back to
NODE_RANDOM, values clip to the row's own [lo, hi]. No new kernel
exists here: a targeted round is the masked havoc kernel, a host splice
of the synthesized rows and the knob-write kernel, so it captures no
new graph.

A scenario can only be aimed where it has fault rows: synthesis maps a
"msg" candidate onto one-way-partition rows whose group mask the edge
actually crosses (direction from step.py: src bit 0 = which side's
sends vanish), then peer-reset / dup rows targeting the edge's
endpoints; a "timer" candidate onto clock-skew rows targeting the
timer's node, then peer-reset rows. A plan with none of these rows
yields no targeted vectors — `fuzz(ldfi=...)` then falls back to pure
havoc for the round (reported honestly via `targeted` counts).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..core import types as T
from .mutate import KnobPlan

# fault ops synthesis may retime/retarget, in preference order per
# candidate kind (see module docstring)
_MSG_OPS = (T.OP_PARTITION_ONEWAY, T.OP_RESET_PEER, T.OP_SET_DUP)
_TIMER_OPS = (T.OP_SET_SKEW, T.OP_RESET_PEER)


@dataclasses.dataclass
class LdfiConfig:
    """Knobs of the lineage-driven arm of a fuzz campaign.

    witness: a `harness.success_witness` finder locating the green
      outcome's dispatch (None = a lane's last dispatch).
    frac: fraction of each round's batch given to targeted vectors
      (the rest stays havoc — LDFI aims, havoc keeps exploring).
    lanes: green supports harvested per round (extraction is a host
      walk per lane — bound it).
    max_cuts: edges cut per synthesized vector. 1 is the classic LDFI
      single-fault probe; 2 the default (fault pairs are where
      retry-masks-a-bug stories live).
    lead: ticks before an edge's instant the fault fires — the cut
      must be in force when the message would have flown.
    rank_cap: candidates kept from the hitting-set ranking.
    replay: upgrade wrapped-ring supports by t=0 window replay
      (full fidelity at replay cost; `obs.support.extract_support`).
    """

    witness: object = None
    frac: float = 0.25
    lanes: int = 8
    max_cuts: int = 2
    lead: int = 1_000
    rank_cap: int = 16
    replay: bool = False


def _candidates(sup: dict):
    """A support's cut-candidate keys: ("msg", src, dst) / ("timer",
    node, -1), each with the sim-time instant it was observed at.
    External sends (src < 0) are not cuttable edges."""
    for src, dst, now in sup["msg_edges"]:
        if src >= 0:
            yield ("msg", int(src), int(dst)), int(now)
    for node, now in sup["timer_edges"]:
        yield ("timer", int(node), -1), int(now)


class SupportPool:
    """Supports pooled across lanes (and, sharded, across shards): the
    input to the hitting-set ranking. Each added support becomes one
    row — the set of candidate keys that trajectory depended on; the
    pool also keeps every instant each candidate was observed at, so
    synthesis can aim at real times. `truncated` counts supports that
    were honest suffixes (wrapped rings) — their rows are lower bounds,
    which only ever UNDER-counts a candidate's coverage."""

    def __init__(self):
        self.rows: list[frozenset] = []
        self.times: dict[tuple, list[int]] = {}
        self.seed_of: dict[tuple, int] = {}
        self.truncated = 0

    def __len__(self) -> int:
        return len(self.rows)

    def add(self, sup: dict, seed: int | None = None) -> bool:
        """Fold one `extract_support` result in; False when the support
        had no cuttable edge (nothing for the ranking to see). `seed`
        is the green lane's seed: edge INSTANTS are seed-specific
        (another seed's protocol runs the same edges at different
        times), so synthesis pins each vector to the seed whose
        timing it was aimed at — the LDFI move is replaying the SAME
        run with the cut injected, not spraying the cut at a fresh
        one."""
        keys = set()
        for key, t in _candidates(sup):
            keys.add(key)
            self.times.setdefault(key, []).append(t)
            if seed is not None:
                self.seed_of.setdefault((key, t), int(seed))
        if not keys:
            return False
        self.rows.append(frozenset(keys))
        if sup.get("truncated"):
            self.truncated += 1
        return True

    def merge(self, other: "SupportPool") -> None:
        """Pool another shard's supports in (fuzz_sharded merge point)."""
        self.rows.extend(other.rows)
        for key, ts in other.times.items():
            self.times.setdefault(key, []).extend(ts)
        for kt, s in other.seed_of.items():
            self.seed_of.setdefault(kt, s)
        self.truncated += other.truncated

    def ranked(self, cap: int = 16) -> list[dict]:
        """Greedy minimal hitting set: repeatedly take the candidate
        covering the most yet-uncovered supports (deterministic
        tie-break on the key itself), then pad with the remaining
        candidates by total coverage — up to `cap` entries of
        {key, kind, a, b, times, hits}."""
        hit = {k: {i for i, row in enumerate(self.rows) if k in row}
               for k in self.times}
        uncovered = set(range(len(self.rows)))
        picked: list[tuple] = []
        while uncovered and len(picked) < cap:
            k = max(sorted(hit), key=lambda k: len(hit[k] & uncovered))
            if not hit[k] & uncovered:
                break
            picked.append(k)
            uncovered -= hit.pop(k)
        for k in sorted(hit, key=lambda k: (-len(hit[k]), k)):
            if len(picked) >= cap:
                break
            picked.append(k)
        return [dict(key=k, kind=k[0], a=k[1], b=k[2],
                     times=sorted(self.times[k]),
                     hits=len({i for i, row in enumerate(self.rows)
                               if k in row}))
                for k in picked]


def _rows_by_op(plan: KnobPlan) -> dict[int, list[int]]:
    ops = np.asarray(plan.base["op"])
    out: dict[int, list[int]] = {}
    for r in range(plan.R):
        if plan.time_ok[r]:
            out.setdefault(int(ops[r]), []).append(r)
    return out


def _in_group_a(plan: KnobPlan, r: int, node: int) -> bool:
    """Whether `node` is in a partition row's group-A bitmask (payload
    packs membership 31 nodes/word — step.py encoding)."""
    pay = plan.base["payload"][r]
    w = node // 31
    return w < len(pay) and bool((int(pay[w]) >> (node % 31)) & 1)


def _confine(plan: KnobPlan, r: int, node: int) -> int:
    """Pool confinement at SYNTHESIS time (apply would catch it anyway,
    but falling back early keeps the vector honest about its target):
    an out-of-pool node becomes NODE_RANDOM."""
    if 0 <= node < plan.N and plan.pool_ok[r, node + 1]:
        return int(node)
    return T.NODE_RANDOM


def _retime_heal(plan: KnobPlan, kn: dict, r: int, when: int,
                 used: set) -> None:
    """Drag a cut row's paired OP_HEAL along, preserving the outage
    DURATION. A re-aimed partition whose scenario heal stays at its
    original (now far-future) instant degenerates into a permanent
    cut — and a permanently unreachable node makes protocols abort
    CLEANLY instead of exposing torn state: the oracle that would
    catch the inconsistency can never observe it (measured on the
    Percolator-lite flagship: 0/88 support-aimed permanent cuts
    crash, 13/88 crash once the heal rides along). Pairing rule: the
    nearest time-mutable OP_HEAL row at base time >= the cut row's
    base time; its base delta is the duration kept. Two cuts sharing
    one heal keep the LATER proposed heal (both outages stay open at
    least as long as the shorter one intended)."""
    ops = np.asarray(plan.base["op"])
    times = np.asarray(plan.base["time"])
    base_t = int(times[r])
    best, best_dt = -1, None
    for hr in range(plan.R):
        if int(ops[hr]) != T.OP_HEAL or not plan.time_ok[hr]:
            continue
        dt = int(times[hr]) - base_t
        if dt >= 0 and (best_dt is None or dt < best_dt):
            best, best_dt = hr, dt
    if best < 0:
        return
    new_t = np.int32(int(when) + best_dt)
    if best in used:
        new_t = max(np.int32(kn["row_time"][best]), new_t)
    kn["row_time"][best] = new_t
    kn["row_on"][best] = True
    used.add(best)


def _cut(plan: KnobPlan, kn: dict, cand: dict, t: int, lead: int,
         used: set) -> bool:
    """Aim one unused fault row of `kn` at candidate `cand` around
    instant `t`. Returns False when no row of this plan can express
    the cut (no matching fault op, or a one-way mask the edge does
    not cross)."""
    when = np.int32(max(0, int(t) - int(lead)))
    ops = _MSG_OPS if cand["kind"] == "msg" else _TIMER_OPS
    by_op = cand["_rows_by_op"]
    for op in ops:
        for r in by_op.get(int(op), []):
            if r in used:
                continue
            if op == T.OP_PARTITION_ONEWAY:
                # direction: src bit 0 = 0 cuts A -> not-A, 1 the
                # reverse (step.py) — usable only when the edge
                # actually crosses the row's group mask
                a_src = _in_group_a(plan, r, cand["a"])
                a_dst = _in_group_a(plan, r, cand["b"])
                if a_src == a_dst:
                    continue
                kn["row_flag"][r] = np.int32(0 if a_src else 1)
            elif op == T.OP_RESET_PEER:
                node = cand["b"] if cand["kind"] == "msg" else cand["a"]
                kn["row_node"][r] = np.int32(_confine(plan, r, node))
            elif op == T.OP_SET_DUP:
                kn["row_node"][r] = np.int32(_confine(plan, r, cand["a"]))
                kn["row_val"][r] = np.int32(
                    min(int(plan.val_hi[r]), T.DUP_RATE_CAP * 2 // 3))
            elif op == T.OP_SET_SKEW:
                kn["row_node"][r] = np.int32(_confine(plan, r, cand["a"]))
                # shove the clock hard in one direction; alternate sign
                # by instant so repeated cuts probe both skews
                sign = 1 if (t & 1) == 0 else -1
                kn["row_val"][r] = np.int32(sign * int(plan.val_hi[r]))
            kn["row_time"][r] = when
            kn["row_on"][r] = True
            used.add(r)
            if op == T.OP_PARTITION_ONEWAY:
                _retime_heal(plan, kn, r, int(when), used)
            return True
    return False


def synthesize(plan: KnobPlan, pool: SupportPool, n: int, *,
               max_cuts: int = 2, lead: int = 1_000,
               rank_cap: int = 16, with_seeds: bool = False):
    """Compile the pool's ranked candidates into `n` targeted knob
    vectors (host dicts off `plan.base_knobs()`): vector i cuts up to
    `max_cuts` candidates starting at rank i (wrapping), each at an
    observed instant minus `lead` — so the batch walks the ranking
    while every vector stays a legal mutant. Deterministic: same pool,
    same plan, same vectors. Returns [] when the pool is empty or the
    plan has no row that can express any candidate.

    with_seeds=True returns `(vectors, seeds)` where seeds[i] is the
    green seed whose timing vector i's FIRST cut was aimed at (None
    when the pool never learned one) — the drivers pin the targeted
    lane to that seed so the cut lands in the trajectory it was
    extracted from."""
    cands = pool.ranked(rank_cap)
    if not cands or n <= 0:
        return ([], []) if with_seeds else []
    by_op = _rows_by_op(plan)
    for c in cands:
        c["_rows_by_op"] = by_op
    out = []
    seeds: list[int | None] = []
    for i in range(int(n)):
        kn = plan.base_knobs()
        used: set[int] = set()
        cuts = 0
        pin = None
        for j in range(len(cands)):
            if cuts >= max_cuts:
                break
            cand = cands[(i + j) % len(cands)]
            ts = cand["times"]
            t = ts[(i // max(1, len(cands))) % len(ts)]
            if _cut(plan, kn, cand, t, lead, used):
                if pin is None:
                    pin = pool.seed_of.get((cand["key"], t))
                cuts += 1
        if cuts:
            out.append(kn)
            seeds.append(pin)
    for c in cands:
        del c["_rows_by_op"]
    return (out, seeds) if with_seeds else out
