"""Scenario scripts: the supervisor future, compiled to data.

(The port's own copy of `madsim_tpu.runtime.scenario` — host-only
Python, identical row encoding, so a scenario builds the same initial
event table in both packages.)

In madsim the supervisor is an async future on node 0 that sleeps to
checkpoints and calls `Handle::{kill, restart, pause, resume}` /
`NetSim::{clog_node, clog_link, ...}` (runtime/mod.rs:200-256,
net/mod.rs:98-157). Keeping that imperative loop on the host would force a
device sync per fault. Instead a Scenario is a static table of scheduled
supervisor ops baked into the initial event table, so fault injection happens
*inside* the jitted trace at full speed — and ops may take NODE_RANDOM
targets, resolved per-trajectory from the seed's PRNG, which is how one
scenario fuzzes thousands of distinct fault schedules at once.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..core import types as T


# -- recipe-family row classes (r18; service/triage.py attribution) --------
# Every supervisor op belongs to one chaos-recipe FAMILY — the row-class
# tags the campaign triage plane uses to attribute coverage keys and
# crash buckets to the fault shape that earned them (runtime/chaos.py
# recipes compose ops from exactly these families). Order IS precedence:
# a scenario mixing families classifies as the first present — most
# gray/specific first, so a gray_failure mix whose mutant kept its torn
# kill reads "torn_write" even while its latency rows stay on. "none"
# covers the classic lifecycle/partition/clog chaos (and a faultless
# script); the triage accounting contract adds an explicit "base" class
# for rows it cannot see at all — never a silent "other".
RECIPE_FAMILIES = ("conn_fault", "torn_write", "slow_disk", "clock_skew",
                   "asym_partition", "loss_latency", "none")


def row_recipe_class(op: int, torn: bool = False) -> str:
    """The recipe family one scenario row encodes. OP_SET_DISK splits on
    its torn flag (a torn-armed disk row is the torn_write_kill recipe's
    signature; a plain latency stall is slow_disk). The r19 connection-
    fault ops (reset-peer teardown, duplicate-delivery storm) class as
    conn_fault — first in precedence, so a mutant that kept its
    connection fault reads as the conn recipe even while gray rows
    stay on."""
    from ..core import types as _T
    if op in (_T.OP_RESET_PEER, _T.OP_SET_DUP):
        return "conn_fault"
    if op == _T.OP_SET_DISK:
        return "torn_write" if torn else "slow_disk"
    if op == _T.OP_SET_SKEW:
        return "clock_skew"
    if op == _T.OP_PARTITION_ONEWAY:
        return "asym_partition"
    if op in (_T.OP_SET_LOSS, _T.OP_SET_LATENCY):
        return "loss_latency"
    return "none"


def classify_recipe(row_classes) -> str:
    """Fold per-row classes into ONE family by RECIPE_FAMILIES
    precedence — the entry/bucket-level classifier (each coverage key
    gets exactly one family, so attribution sums to the total)."""
    present = set(row_classes)
    for fam in RECIPE_FAMILIES:
        if fam in present:
            return fam
    return "none"


@dataclasses.dataclass
class _Row:
    time: int
    op: int
    node: int = 0
    src: int = 0
    payload: tuple = ()
    # value words written RIGHT-ALIGNED into the payload (tail[-1] lands
    # at payload_words-1): the r17 value-carrying ops (OP_SET_SKEW /
    # OP_SET_DISK) keep their values past the pool segment so a
    # NODE_RANDOM pool and a value coexist in one row (step.py
    # _apply_super reads values from the tail, pools from the head)
    payload_tail: tuple = ()


class Scenario:
    """Builder for scheduled supervisor ops.

    Example (a MadRaft-style chaos schedule)::

        sc = Scenario()
        sc.at(T.sec(1)).partition([0, 1])        # cut {0,1} from the rest
        sc.at(T.sec(2)).heal()
        for t in range(5):
            sc.at(T.sec(3 + t)).kill_random()    # per-seed random victim
            sc.at(T.sec(3 + t) + T.ms(500)).restart_random()
        sc.at(T.sec(10)).halt()
    """

    def __init__(self):
        self.rows: list[_Row] = []

    # -- time cursor -------------------------------------------------------
    def at(self, time: int) -> "_At":
        return _At(self, int(time))

    def has_halt(self) -> bool:
        return any(r.op == T.OP_HALT for r in self.rows)

    def recipe_class(self) -> str:
        """This script's recipe family (the classifier over the
        describe()/parse() row table — triage attribution's view of a
        scenario): `classify_recipe` over every row's class, with
        OP_SET_DISK rows reading their torn flag from wherever build()
        would encode it (payload_tail for builder rows, the full
        payload's P-2 word for rows re-entered via KnobPlan)."""
        def torn_of(r):
            if r.op != T.OP_SET_DISK:
                return False
            vals = [0, 0] + list(r.payload_tail or r.payload)
            return bool(vals[-2])
        return classify_recipe(
            row_recipe_class(r.op, torn_of(r)) for r in self.rows)

    _OP_NAMES = {
        T.OP_INIT: "boot", T.OP_KILL: "kill", T.OP_RESTART: "restart",
        T.OP_PAUSE: "pause", T.OP_RESUME: "resume",
        T.OP_CLOG_NODE: "clog", T.OP_UNCLOG_NODE: "unclog",
        T.OP_CLOG_LINK: "clog_link", T.OP_UNCLOG_LINK: "unclog_link",
        T.OP_SET_LOSS: "set_loss", T.OP_SET_LATENCY: "set_latency",
        T.OP_HEAL: "heal", T.OP_PARTITION: "partition", T.OP_HALT: "halt",
        T.OP_PARTITION_ONEWAY: "partition_oneway",
        T.OP_SET_SKEW: "set_skew", T.OP_SET_DISK: "set_disk",
        T.OP_RESET_PEER: "reset_peer", T.OP_SET_DUP: "set_dup",
    }

    @staticmethod
    def _unpack_members(words):
        """Inverse of the 31-nodes/word packing (pools, partitions)."""
        return [w * 31 + b for w, word in enumerate(words)
                for b in range(31) if (int(word) >> b) & 1]

    def describe(self) -> str:
        """Faithful one-line-per-row rendering (repro reports): exact
        tick times, decoded pools/partitions/rates — a script re-entered
        from this text reproduces the original fault model."""
        out = []
        # the r17 value-carrying ops keep how many TAIL payload words?
        # (builder rows carry them in payload_tail; KnobPlan.to_scenario
        # rows bake them into the payload's end — the pool decode below
        # must not read value bits as phantom pool members)
        n_tail = {T.OP_SET_SKEW: 1, T.OP_SET_DISK: 2, T.OP_SET_DUP: 1}
        for r in self.rows:
            name = self._OP_NAMES.get(r.op, f"op{r.op}")
            if r.node == T.NODE_RANDOM:
                pool_words = r.payload
                k = n_tail.get(r.op, 0)
                if k and not r.payload_tail:
                    pool_words = r.payload[:-k]
                pool = self._unpack_members(pool_words)
                tgt = (f"random among {pool}" if pool else "random")
            else:
                tgt = f"node {r.node}"
            extra = ""
            if r.op in (T.OP_CLOG_LINK, T.OP_UNCLOG_LINK):
                extra = f" {r.src}->{r.node}"
                tgt = ""
            elif r.op == T.OP_PARTITION:
                tgt = ""
                extra = f" group_a={self._unpack_members(r.payload)}"
            elif r.op == T.OP_PARTITION_ONEWAY:
                tgt = ""
                extra = (f" group_a={self._unpack_members(r.payload)}"
                         f" dir={'in' if r.src & 1 else 'out'}")
            elif r.op in (T.OP_SET_SKEW, T.OP_SET_DISK, T.OP_SET_DUP):
                # builder rows keep values in payload_tail; rows round-
                # tripped through KnobPlan.to_scenario carry the full
                # payload with the values already right-aligned — the
                # tail IS the payload's tail either way
                vals = [0, 0] + list(r.payload_tail or r.payload)
                extra = (f" skew={vals[-1]}" if r.op == T.OP_SET_SKEW
                         else f" rate={vals[-1] / 1e6:g}"
                         if r.op == T.OP_SET_DUP
                         else f" lat={vals[-1]}us torn={vals[-2]}")
            elif r.op == T.OP_SET_LOSS:
                tgt = ""
                extra = f" rate={r.payload[0] / 1e6:g}"
            elif r.op == T.OP_SET_LATENCY:
                tgt = ""
                extra = (f" latency={r.payload[0]}us"
                         f"..{r.payload[1]}us")
            elif r.op in (T.OP_HALT, T.OP_HEAL):
                tgt = ""
            out.append(f"  t={r.time}us {name}"
                       f"{' ' + tgt if tgt else ''}{extra}")
        return "\n".join(out)

    @classmethod
    def parse(cls, text: str) -> "Scenario":
        """Inverse of `describe()` — the script RE-ENTRY contract: a
        describe()d script parses back into a Scenario whose `build()`
        encodes the identical rows (tests/test_grayfail.py round-trips
        every op in the decode table). Covers the built-in op table;
        extension custom ops (`opN` lines) are rejected — their payload
        encoding is the extension's, not the scenario grammar's."""
        import re
        by_name = {v: k for k, v in cls._OP_NAMES.items()}
        sc = cls()
        for raw in text.splitlines():
            line = raw.strip()
            if not line:
                continue
            m = re.match(r"t=(\d+)us (\w+)\s*(.*)$", line)
            if not m:
                raise ValueError(f"unparseable scenario line: {raw!r}")
            t, name, rest = int(m.group(1)), m.group(2), m.group(3)
            if name not in by_name:
                raise ValueError(
                    f"unknown scenario op {name!r} (extension custom ops "
                    f"don't round-trip through describe/parse): {raw!r}")
            op = by_name[name]
            at = sc.at(t)

            def target(rest):
                """(node, pool, rest) from a leading target clause."""
                mm = re.match(r"node (\d+)\s*(.*)$", rest)
                if mm:
                    return int(mm.group(1)), None, mm.group(2)
                mm = re.match(r"random among \[([\d,\s]*)\]\s*(.*)$", rest)
                if mm:
                    pool = [int(x) for x in mm.group(1).split(",") if
                            x.strip()]
                    return T.NODE_RANDOM, pool, mm.group(2)
                mm = re.match(r"random\s*(.*)$", rest)
                if mm:
                    return T.NODE_RANDOM, None, mm.group(1)
                raise ValueError(f"unparseable target in: {raw!r}")

            if op in (T.OP_CLOG_LINK, T.OP_UNCLOG_LINK):
                mm = re.match(r"(\d+)->(\d+)$", rest)
                s_, d = int(mm.group(1)), int(mm.group(2))
                (at.clog_link if op == T.OP_CLOG_LINK
                 else at.unclog_link)(s_, d)
            elif op == T.OP_PARTITION:
                mm = re.match(r"group_a=\[([\d,\s]*)\]$", rest)
                at.partition([int(x) for x in mm.group(1).split(",")
                              if x.strip()])
            elif op == T.OP_PARTITION_ONEWAY:
                mm = re.match(r"group_a=\[([\d,\s]*)\] dir=(out|in)$", rest)
                at.partition_oneway(
                    [int(x) for x in mm.group(1).split(",") if x.strip()],
                    direction=1 if mm.group(2) == "in" else 0)
            elif op == T.OP_SET_LOSS:
                at.set_loss(round(float(rest.split("=")[1]) * 1e6) / 1e6)
            elif op == T.OP_SET_LATENCY:
                mm = re.match(r"latency=(\d+)us\.\.(\d+)us$", rest)
                at.set_latency(int(mm.group(1)), int(mm.group(2)))
            elif op == T.OP_HALT:
                at.halt()
            elif op == T.OP_HEAL:
                at.heal()
            elif op == T.OP_SET_SKEW:
                node, pool, rest = target(rest)
                v = int(re.match(r"skew=(-?\d+)$", rest).group(1))
                if node == T.NODE_RANDOM:
                    at.set_skew_random(v, among=pool)
                else:
                    at.set_skew(node, v)
            elif op == T.OP_SET_DISK:
                node, pool, rest = target(rest)
                mm = re.match(r"lat=(\d+)us torn=(\d+)$", rest)
                lat, torn = int(mm.group(1)), bool(int(mm.group(2)))
                if node == T.NODE_RANDOM:
                    at.set_disk_random(lat, torn=torn, among=pool)
                else:
                    at.set_disk(node, lat, torn=torn)
            elif op == T.OP_SET_DUP:
                node, pool, rest = target(rest)
                rate = float(re.match(r"rate=([\d.e+-]+)$", rest).group(1))
                if node == T.NODE_RANDOM:
                    at.set_dup_random(rate, among=pool)
                else:
                    at.set_dup(node, rate)
            elif op == T.OP_RESET_PEER:
                node, pool, _ = target(rest)
                if node == T.NODE_RANDOM:
                    at._add(op, T.NODE_RANDOM,
                            payload=_At._pool(pool) if pool else ())
                else:
                    at.reset_peer(node)
            else:               # node-lifecycle / clog ops
                node, pool, _ = target(rest)
                method = {
                    T.OP_INIT: "boot", T.OP_KILL: "kill",
                    T.OP_RESTART: "restart", T.OP_PAUSE: "pause",
                    T.OP_RESUME: "resume", T.OP_CLOG_NODE: "clog_node",
                    T.OP_UNCLOG_NODE: "unclog_node"}[op]
                if node == T.NODE_RANDOM:
                    # re-enter the exact encoding the builders produce:
                    # NODE_RANDOM target + the 31-nodes/word pool words
                    at._add(op, T.NODE_RANDOM,
                            payload=_At._pool(pool) if pool else ())
                else:
                    getattr(at, method)(node)
        return sc

    def build(self, cfg: T.SimConfig):
        """-> dict of numpy arrays (time, op, node, src, payload[R, P])."""
        R = len(self.rows)
        P = cfg.payload_words
        out = dict(
            time=np.zeros(R, np.int32), op=np.zeros(R, np.int32),
            node=np.zeros(R, np.int32), src=np.zeros(R, np.int32),
            payload=np.zeros((R, P), np.int32),
        )
        n_pool_words = min(P, (cfg.n_nodes + 30) // 31)
        for i, r in enumerate(self.rows):
            if len(r.payload) + len(r.payload_tail) > P:
                raise ValueError(
                    f"scenario op {r.op} at t={r.time} needs "
                    f"{len(r.payload)}+{len(r.payload_tail)} payload words "
                    f"but cfg.payload_words={P} (pools pack 31 nodes per "
                    f"word; set_skew/set_disk values ride the tail words)")
            if (r.payload_tail and r.node == T.NODE_RANDOM
                    and P - len(r.payload_tail) < n_pool_words):
                # a value word landing INSIDE the pool segment would be
                # bit-decoded as phantom pool members by the NODE_RANDOM
                # resolution (step.py reads pools from the first
                # ceil(N/31) words) — refuse instead of mistargeting
                raise ValueError(
                    f"scenario op {r.op} at t={r.time}: its "
                    f"{len(r.payload_tail)} value word(s) overlap the "
                    f"{n_pool_words}-word NODE_RANDOM pool segment — "
                    f"raise cfg.payload_words past "
                    f"{n_pool_words + len(r.payload_tail)}")
            out["time"][i] = r.time
            out["op"][i] = r.op
            out["node"][i] = r.node
            out["src"][i] = r.src
            for j, w in enumerate(r.payload):
                out["payload"][i, j] = w
            # value words land right-aligned (tail[-1] at P-1), where
            # step.py _apply_super reads them past any pool segment
            for j, w in enumerate(r.payload_tail):
                out["payload"][i, P - len(r.payload_tail) + j] = w
        return out


class _At:
    def __init__(self, sc: Scenario, time: int):
        self._sc, self._t = sc, time

    def _add(self, op, node=0, src=0, payload=(), payload_tail=()):
        self._sc.rows.append(_Row(self._t, op, int(node), int(src),
                                  tuple(payload), tuple(payload_tail)))
        return self

    # -- node lifecycle (Handle::kill/restart/pause/resume) ----------------
    def boot(self, node):
        """Bring `node` up at this time instead of t=0 — the
        Handle::create_node analog (runtime/mod.rs:66-76): scheduling a
        boot makes the Runtime skip that node's automatic t=0 init, so the
        node simply does not exist (messages to it vanish) until now."""
        return self._add(T.OP_INIT, node)

    def kill(self, node):
        return self._add(T.OP_KILL, node)

    def restart(self, node):
        return self._add(T.OP_RESTART, node)

    def pause(self, node):
        return self._add(T.OP_PAUSE, node)

    def resume(self, node):
        return self._add(T.OP_RESUME, node)

    @staticmethod
    def _pool(among):
        """Candidate bitmask for random targets (None = everyone).
        Packed 31 nodes/word across payload words (the OP_PARTITION
        packing), so pools cover any N <= 31 * payload_words."""
        if among is None:
            return ()
        among = list(among)
        assert among, "among=[] would mean 'no restriction'; pass None for that"
        words = [0] * (1 + max(int(n) for n in among) // 31)
        for n in among:
            assert int(n) >= 0, "node ids are non-negative"
            words[int(n) // 31] |= 1 << (int(n) % 31)
        return tuple(words)

    def kill_random(self, among=None):
        """Kill a random alive node — target drawn per-seed at fire time.
        `among` restricts candidates (e.g. servers only, not clients)."""
        return self._add(T.OP_KILL, T.NODE_RANDOM, payload=self._pool(among))

    def restart_random(self, among=None):
        """Restart a random dead node."""
        return self._add(T.OP_RESTART, T.NODE_RANDOM,
                         payload=self._pool(among))

    def pause_random(self, among=None):
        return self._add(T.OP_PAUSE, T.NODE_RANDOM, payload=self._pool(among))

    def resume_random(self, among=None):
        return self._add(T.OP_RESUME, T.NODE_RANDOM,
                         payload=self._pool(among))

    # -- network faults (NetSim) ------------------------------------------
    def clog_node(self, node):
        return self._add(T.OP_CLOG_NODE, node)

    def unclog_node(self, node):
        return self._add(T.OP_UNCLOG_NODE, node)

    def clog_node_random(self):
        return self._add(T.OP_CLOG_NODE, T.NODE_RANDOM)

    def clog_link(self, src, dst):
        return self._add(T.OP_CLOG_LINK, dst, src)

    def unclog_link(self, src, dst):
        return self._add(T.OP_UNCLOG_LINK, dst, src)

    def partition(self, group_a):
        """Cut group_a <-> everyone else, both directions (disconnect2 x N^2
        collapsed into one op). Membership is packed 31 nodes per payload
        word (sign bit unused), so up to 31 * payload_words nodes."""
        words = [0] * (1 + max((int(n) for n in group_a), default=0) // 31)
        for n in group_a:
            n = int(n)
            words[n // 31] |= 1 << (n % 31)
        return self._add(T.OP_PARTITION, payload=tuple(words))

    def partition_oneway(self, group_a, direction: int = 0):
        """ASYMMETRIC cut (madsim `disconnect2` parity, r17): direction 0
        cuts A -> not-A — group_a's sends to the outside vanish while
        everything the outside sends A still arrives; direction 1 cuts the
        reverse. Directional entries are OR'd INTO the clog_link matrix,
        so one-way cuts compose (two opposite one-way cuts == a full
        partition); only `heal()` clears them. Membership packs 31 nodes
        per payload word, like `partition()`."""
        words = [0] * (1 + max((int(n) for n in group_a), default=0) // 31)
        for n in group_a:
            n = int(n)
            words[n // 31] |= 1 << (n % 31)
        return self._add(T.OP_PARTITION_ONEWAY, src=int(direction) & 1,
                         payload=tuple(words))

    def set_skew(self, node, skew: int):
        """Set `node`'s clock-RATE skew in 1/1024ths (r17): its local
        clock runs at (1 + skew/1024)x — handlers observe the drifted
        `ctx.now` and the node's timer delays stretch/shrink inversely,
        so a fast clock expires leases/timeouts early in global time.
        Clipped to ±SKEW_CAP (±50%) at application; 0 restores a
        synchronized clock."""
        return self._add(T.OP_SET_SKEW, node,
                         payload_tail=(int(skew),))

    def set_skew_random(self, skew: int, among=None):
        """Skew a random node's clock (pool-restricted like
        kill_random); the value rides the tail payload word, so pool and
        value coexist."""
        return self._add(T.OP_SET_SKEW, T.NODE_RANDOM,
                         payload=self._pool(among),
                         payload_tail=(int(skew),))

    def set_disk(self, node, latency: int = 0, torn: bool = False):
        """Set `node`'s disk fault state (r17): `latency` ticks are added
        to every emission the node makes (the fsync-stalled event loop —
        replies and timers leave late), and `torn=True` arms torn-write-
        on-kill mode (a kill flushes a random prefix of each fs file's
        unsynced tail to disk, so recovery can see a partially-written
        final record). `set_disk(n)` restores a healthy disk."""
        return self._add(T.OP_SET_DISK, node,
                         payload_tail=(int(bool(torn)), int(latency)))

    def set_disk_random(self, latency: int = 0, torn: bool = False,
                        among=None):
        """Disk-fault a random node (pool-restricted like kill_random)."""
        return self._add(T.OP_SET_DISK, T.NODE_RANDOM,
                         payload=self._pool(among),
                         payload_tail=(int(bool(torn)), int(latency)))

    def reset_peer(self, node):
        """Tear down every established connection/stream touching `node`,
        on BOTH sides, and bump the incarnation epochs (r19 — the madsim
        NetSim::reset_node parity): in-flight segments and RSTs from the
        torn incarnation are rejected by whatever connection comes next.
        Inert for models without the net/conn+stream state leaves."""
        return self._add(T.OP_RESET_PEER, node)

    def reset_peer_random(self, among=None):
        """Reset-peer a random node (pool-restricted like kill_random)."""
        return self._add(T.OP_RESET_PEER, T.NODE_RANDOM,
                         payload=self._pool(among))

    def set_dup(self, node, rate: float):
        """Set `node`'s duplicate-delivery rate (r19): each MESSAGE
        dispatched at the node is delivered one more time with this
        probability (fresh latency draw, byte-identical payload — the
        retransmit-storm regime; duplicates can duplicate again).
        Clipped to DUP_RATE_CAP (0.9) at application; `set_dup(n, 0)`
        restores exactly-once datagram delivery."""
        return self._add(T.OP_SET_DUP, node,
                         payload_tail=(int(rate * 1e6),))

    def set_dup_random(self, rate: float, among=None):
        """Dup-storm a random node (pool-restricted like kill_random);
        the rate rides the tail payload word, so pool and value
        coexist."""
        return self._add(T.OP_SET_DUP, T.NODE_RANDOM,
                         payload=self._pool(among),
                         payload_tail=(int(rate * 1e6),))

    def heal(self):
        """Clear all clogs/partitions (one-way cuts included)."""
        return self._add(T.OP_HEAL)

    def set_loss(self, rate: float):
        return self._add(T.OP_SET_LOSS, payload=(int(rate * 1e6),))

    def set_latency(self, lo: int, hi: int):
        return self._add(T.OP_SET_LATENCY, payload=(int(lo), int(hi)))

    # -- extension custom ops (plugin framework analog) --------------------
    def custom(self, op: int, node=0, src=0, payload=()):
        """Schedule an extension's supervisor op (op >= extension.OP_USER);
        dispatched to every registered Extension.on_op at fire time."""
        from ..core.extension import OP_USER
        assert op >= OP_USER, f"custom ops must be >= {OP_USER}"
        return self._add(op, node, src, payload)

    # -- end of simulation -------------------------------------------------
    def halt(self):
        return self._add(T.OP_HALT)
