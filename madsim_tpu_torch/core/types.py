"""Core constants, event kinds, supervisor opcodes, and static simulation config.

(The port's own copy of `madsim_tpu.core.types`, kept value-for-value
identical so configs, opcodes and `structural_signature()` mean the same
thing in both packages.)

TPU-native rethink of madsim's world: instead of an async executor with a
random-pop ready queue (reference: madsim/src/sim/task.rs:88-143) plus a
binary-heap timer wheel (madsim/src/sim/time/mod.rs:41-56), the whole
simulation is ONE fixed-shape event table. Every future occurrence — a message
delivery (madsim/src/sim/net/mod.rs:301-306 schedules messages as timers), a
protocol timer, a supervisor fault-injection op — is a row in the timer table.
The step function pops the earliest eligible row (random tie-break, mirroring
the seeded random ready-queue pop of madsim/src/sim/utils/mpsc.rs:75-85) and
dispatches it. All shapes are static so the step jit-compiles and vmaps over a
[seed_batch] leading axis.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Any

import numpy as np

# ---------------------------------------------------------------------------
# Time. Virtual time is int32 *ticks*; 1 tick == 1 microsecond. This bounds a
# trajectory at ~35 simulated minutes (2**31 us), far beyond any chaos test in
# the reference suite (which run simulated seconds). An overflow sets an oops
# bit instead of wrapping.
# ---------------------------------------------------------------------------
TICKS_PER_MS = 1_000
TICKS_PER_SEC = 1_000_000
T_INF = np.int32(2**31 - 1)

# ---------------------------------------------------------------------------
# Event kinds (t_kind column of the event table).
# ---------------------------------------------------------------------------
EV_FREE = 0    # empty slot
EV_MSG = 1     # message delivery (madsim: net/mod.rs:301-306 timer-scheduled)
EV_TIMER = 2   # protocol timer (madsim: time/sleep.rs)
EV_SUPER = 3   # supervisor op (madsim: Handle::kill/... runtime/mod.rs:214-245)

# ---------------------------------------------------------------------------
# Supervisor opcodes (t_tag column when t_kind == EV_SUPER).
# Mirrors the fault-injection surface of madsim::runtime::Handle
# (runtime/mod.rs:200-256) and NetSim (net/mod.rs:98-157).
# ---------------------------------------------------------------------------
OP_INIT = 1          # run program.init on node (node boot; NodeBuilder::init)
OP_KILL = 2          # Handle::kill — drop tasks, reset sim node state
OP_RESTART = 3       # Handle::restart — kill + re-run init closure
OP_PAUSE = 4         # Handle::pause
OP_RESUME = 5        # Handle::resume
OP_CLOG_NODE = 6     # NetSim::clog_node (disconnect)
OP_UNCLOG_NODE = 7   # NetSim::unclog_node (connect)
OP_CLOG_LINK = 8     # NetSim::clog_link (disconnect2); args (src=t_src, dst=t_node)
OP_UNCLOG_LINK = 9   # NetSim::unclog_link (connect2)
OP_SET_LOSS = 10     # update packet_loss_rate; payload[0] = rate * 1e6
OP_HALT = 11         # end of simulation (time limit)
OP_SET_LATENCY = 12  # payload[0]=lo ticks, payload[1]=hi ticks
OP_HEAL = 13         # clear the whole clog matrix + clogged nodes
OP_PARTITION = 14    # payload[0] = bitmask of group A; cuts A <-> not-A both
                     # ways (single-row analog of N^2 disconnect2 calls)
# --- gray-failure ops (r17) ------------------------------------------------
OP_PARTITION_ONEWAY = 15  # ASYMMETRIC cut (madsim disconnect2 parity):
                          # payload packs group A (31 nodes/word, the
                          # OP_PARTITION packing); t_src is the direction
                          # flag — 0 cuts A -> not-A (A's sends vanish,
                          # A still hears), 1 cuts not-A -> A. Directional
                          # entries are OR'd INTO the clog_link matrix
                          # (cuts compose); OP_HEAL clears them all.
OP_SET_SKEW = 16     # per-node clock skew: payload[LAST] = signed RATE in
                     # 1/1024ths (clipped to ±SKEW_CAP): node's local clock
                     # runs at (1 + skew/1024)x — observed `now` drifts and
                     # its timer delays stretch/shrink inversely. Target may
                     # be NODE_RANDOM with a pool in the LEADING payload
                     # words (value and pool coexist; see _apply_super).
OP_SET_DISK = 17     # per-node disk fault: payload[LAST] = disk latency in
                     # ticks (every emission of the node leaves that much
                     # later — the fsync-stall "limping node" model),
                     # payload[LAST-1] = torn-write flag (nonzero: a KILL of
                     # this node flushes a random PREFIX of each file's
                     # unsynced tail to disk — a partially-written final
                     # record instead of clean old-or-new; fs-layer models
                     # only). Same pool/value packing as OP_SET_SKEW.
# --- connection-fault ops (r19) ---------------------------------------------
OP_RESET_PEER = 18   # tear down ALL conn/stream fabric touching the target
                     # node, on BOTH sides (madsim NetSim::reset_node parity,
                     # sim/net/tcp/stream.rs:185-192: live TCP connections
                     # die; a kill alone deliberately leaves the survivor's
                     # half-open state): every cn_state entry touching the
                     # node drops to CLOSED, every stream ring/counter
                     # touching it is wiped, and both sides' incarnation
                     # epochs bump — so in-flight segments and RSTs from the
                     # torn incarnation are rejected by the successor
                     # connection (DESIGN §20). Inert for state schemas
                     # without the conn/stream leaf quartets (like torn
                     # mode for non-fs models). Target may be NODE_RANDOM
                     # with a pool, like every node-lifecycle op.
OP_SET_DUP = 19      # per-node duplicate-delivery rate: payload[LAST] =
                     # rate * 1e6 (the OP_SET_LOSS encoding). A dispatched
                     # MESSAGE at the node is re-armed for one more
                     # delivery with that probability instead of being
                     # freed — the retransmit-storm / datagram-duplication
                     # regime Go-Back-N's exactly-once claim must survive.
                     # Duplicates can duplicate again (geometric storm,
                     # bounded by the rate cap). Same pool/value packing
                     # as OP_SET_SKEW.

# bounds enforced wherever the values enter state (supervisor op apply,
# KnobPlan.apply): skew is a rate in 1/1024ths (±512 = ±50% clock rate),
# disk latency is capped at 10 simulated seconds, duplicate delivery at
# 0.9 (like the loss-mutation cap: past that lanes mostly stall)
SKEW_CAP = 512
DISK_LAT_CAP = 10_000_000
DUP_RATE_CAP = 900_000

# Node argument sentinel: draw a random target at fire time (fuzzing aid).
# KILL/PAUSE/CLOG pick a random *alive* node; RESTART picks a random *dead* one.
NODE_RANDOM = -1

# ---------------------------------------------------------------------------
# Crash codes (state.crash_code). User codes must be > 0.
# ---------------------------------------------------------------------------
CRASH_NONE = 0
CRASH_DEADLOCK = -1        # no eligible event and no HALT reached
                           # (madsim panics "the task will block forever",
                           #  task.rs:110-124)
CRASH_TIME_LIMIT = -2      # virtual-time limit exceeded (set_time_limit)
CRASH_INVARIANT = -3       # global invariant check failed (generic)
CRASH_SLO = -4             # tail-latency SLO invariant failed
                           # (harness.slo_invariant over the latency plane)
CRASH_RECOVERY = -5        # recovery invariant failed: per-window p99/queue
                           # never returned under threshold within the
                           # allowed windows after the last fault window
                           # (harness.recovery_invariant over the windowed
                           # telemetry plane, DESIGN §22)

# Oops bits (state.oops) — resource-exhaustion flags instead of UB. The
# reference grows Vecs unboundedly; static shapes require capacities.
OOPS_EVENT_OVERFLOW = 1    # event table full; an emission was dropped
OOPS_TIME_OVERFLOW = 2     # virtual clock would exceed int32 ticks

# ---------------------------------------------------------------------------
# Windowed-telemetry fault-marker bits (SimState.sr_fault, DESIGN §22): each
# virtual-time window records WHICH fault classes landed in it, so the
# recovery oracle (harness.recovery_invariant) and the sim-time renderers
# (obs/series.py) can name the last disturbed window without replaying.
# KILL counts only when it actually reset a node (the _apply_super
# reset mask — a NODE_RANDOM kill with no eligible target marks nothing);
# the matrix/knob ops mark when the scheduled op dispatched.
# ---------------------------------------------------------------------------
SRF_KILL = 1          # effective OP_KILL / the kill half of OP_RESTART
SRF_BOOT = 2          # effective OP_INIT / OP_RESTART boot
SRF_PARTITION = 4     # OP_CLOG_NODE/CLOG_LINK/PARTITION/PARTITION_ONEWAY
SRF_HEAL = 8          # OP_HEAL / OP_UNCLOG_NODE / OP_UNCLOG_LINK
SRF_NET = 16          # OP_SET_LOSS / OP_SET_LATENCY
SRF_GRAY = 32         # OP_SET_SKEW / OP_SET_DISK (r17 gray-failure knobs)
SRF_CONN = 64         # OP_RESET_PEER / OP_SET_DUP (r19 connection faults)
# the DISRUPTIVE subset: what the recovery oracle counts as "a fault
# happened here" (boot/heal are recovery actions, not disturbances)
SRF_DISRUPT = SRF_KILL | SRF_PARTITION | SRF_NET | SRF_GRAY | SRF_CONN


@dataclasses.dataclass(frozen=True)
class NetConfig:
    """Network fault model — madsim sim::net::config::Config
    (network.rs:49-69): packet loss rate + latency range.

    Latencies are ticks (us). Reference default: 1-10 ms latency, 0 loss.
    """

    packet_loss_rate: float = 0.0
    send_latency_min: int = 1 * TICKS_PER_MS
    send_latency_max: int = 10 * TICKS_PER_MS
    # per-op micro-jitter: 0..op_jitter_max ticks (INCLUSIVE) added to every
    # send's latency draw AND every timer's deadline. Inspired by — but
    # deliberately wider than — the reference's rand_delay
    # (net/mod.rs:151-156), which draws gen_range(0..5) (EXCLUSIVE, 0-4 us)
    # and wraps network ops only; jittering timer deadlines too widens
    # explored interleavings beyond what the reference perturbs.
    # STATIC gate, dynamic bound: 0 (default)
    # compiles the fold out entirely (zero extra draws on the emission
    # phase); > 0 compiles it in, and the bound then lives in
    # SimState.jitter where set-ops/overrides can tune it without
    # recompile. Enabled/disabled builds are distinct replay domains
    # (the config hash covers this field).
    op_jitter_max: int = 0

    def __post_init__(self):
        assert 0.0 <= self.packet_loss_rate <= 1.0, \
            f"packet_loss_rate {self.packet_loss_rate} not in [0, 1]"
        assert 0 <= self.send_latency_min <= self.send_latency_max, \
            (f"inverted latency range {self.send_latency_min}.."
             f"{self.send_latency_max}")
        assert self.op_jitter_max >= 0

    @staticmethod
    def from_toml(text: str) -> "NetConfig":
        """Parse the reference's TOML config shape (config.rs:35-66):

            [net]
            packet_loss_rate = 0.1
            send_latency = "1ms..10ms"   # or send_latency_min/max in ticks
        """
        data = _toml_loads(text).get("net", {})
        kw = {}
        if "packet_loss_rate" in data:
            kw["packet_loss_rate"] = float(data["packet_loss_rate"])
        if "send_latency" in data:  # "Xms..Yms" range string
            lo, hi = str(data["send_latency"]).split("..")
            kw["send_latency_min"] = _parse_dur(lo)
            kw["send_latency_max"] = _parse_dur(hi)
        if "send_latency_min" in data:
            kw["send_latency_min"] = int(data["send_latency_min"])
        if "send_latency_max" in data:
            kw["send_latency_max"] = int(data["send_latency_max"])
        if "op_jitter_max" in data:  # ticks or a "5us"-style duration
            kw["op_jitter_max"] = _parse_dur(str(data["op_jitter_max"]))
        return NetConfig(**kw)


def _toml_loads(text: str) -> dict:
    """stdlib tomllib when available (3.11+); otherwise a fallback parser
    for the flat `[section]` / `key = value` subset the config shape
    actually uses (this image ships 3.10 and no tomli — the container's
    packages are fixed, so the knob must not require one)."""
    try:
        import tomllib
        return tomllib.loads(text)
    except ImportError:
        pass
    out: dict = {}
    section = out
    for raw in text.splitlines():
        line = raw.strip()
        if not line or line.startswith("#"):
            continue
        header = line.split("#", 1)[0].strip()   # header may carry a comment
        if header.startswith("[") and header.endswith("]"):
            section = out.setdefault(header[1:-1].strip(), {})
            continue
        key, _, val = line.partition("=")
        val = val.strip()
        if not _:
            raise ValueError(f"unparseable config line: {raw!r}")
        try:
            if val[:1] in ('"', "'"):           # quoted string (anything
                q = val[0]                       # past the close quote —
                val = val[1:val.index(q, 1)]     # e.g. a comment — ignored)
            else:
                val = val.split("#", 1)[0].strip()  # bare value, no comment
                if val in ("true", "false"):
                    val = val == "true"
                else:
                    try:
                        val = int(val)
                    except ValueError:
                        val = float(val)
        except ValueError as e:
            raise ValueError(f"unparseable config line: {raw!r} ({e})") \
                from None
        section[key.strip()] = val
    return out


def _parse_dur(s: str) -> int:
    """'5ms' / '10us' / '1s' -> ticks."""
    s = s.strip()
    for suffix, mul in (("us", 1), ("ms", TICKS_PER_MS), ("s", TICKS_PER_SEC)):
        if s.endswith(suffix):
            return int(float(s[:-len(suffix)]) * mul)
    return int(s)


@dataclasses.dataclass(frozen=True)
class SimConfig:
    """Simulation configuration — split into a STRUCTURAL signature and
    DYNAMIC knobs (DESIGN §10 has the full field table).

    Structural fields shape/lower the XLA program: `n_nodes`,
    `event_capacity`, `payload_words`, `table_dtype`, `emission_write`,
    `collect_stats`, `trace_cap`'s power-of-two BUCKET, and the static
    jitter GATE (`net.op_jitter_max > 0`). Only these key a compile
    (`structural_signature()` — the `compile.PROGRAM_CACHE` key), so
    Runtimes differing in anything else share executables.

    Dynamic knobs become traced operands carried in SimState: `time_limit`
    (SimState.tlimit; `set_time_limit` / MADSIM_TEST_TIME_LIMIT), the
    NetConfig scalars (loss/lat_lo/lat_hi/jitter; supervisor ops and
    `apply_net_override` retune them), and `trace_cap`'s exact value
    within its bucket (SimState.trace_cap masks the ring down). They
    still change TRAJECTORIES — `hash()` covers every field, because the
    repro contract needs the config that actually ran — they just no
    longer cost a recompile.
    """

    n_nodes: int
    event_capacity: int = 128      # rows in the event table, per trajectory
    payload_words: int = 8         # int32 words per message/timer payload
    time_limit: int = 10 * TICKS_PER_SEC
    net: NetConfig = dataclasses.field(default_factory=NetConfig)
    collect_stats: bool = True
    # (the r3 opt-in "fused" Pallas scheduler was CUT in r5: three rounds
    # without on-hardware justification, a separate replay domain to
    # maintain, and the roofline (DESIGN §5) shows the select phase is
    # too small a slice of per-step bytes for a select-only kernel to
    # pay — the whole-step VMEM-resident kernel is the real Pallas play)
    # narrow event-table columns: "int16" stores t_kind/t_node/t_src in
    # half the bytes (the [batch, C] table dominates step cost — DESIGN
    # §5b; t_tag stays int32: service tags are 29-bit hashes, t_deadline
    # is virtual time). Values are identical either way, so trajectories
    # and fingerprints are BIT-IDENTICAL across this knob — a pure
    # bandwidth lever, not a replay domain.
    table_dtype: str = "int32"
    # flight-recorder ring (obs/): rows per lane in the on-device trace
    # ring. 0 (default) compiles the recorder out entirely — zero-size
    # ring leaves, no write code in the step. > 0 keeps the last
    # trace_cap dispatched events per SAMPLED lane (see
    # Runtime.init_batch(trace_lanes=...)) resident in SimState, so the
    # ring survives `lax.while_loop` and `run_fused` sweeps stop being
    # blind. The write consumes no randomness and touches no other
    # state, so all non-trace state is BIT-IDENTICAL across trace_cap
    # settings — an observation lever like table_dtype, not a replay
    # domain (the config hash does cover it, since the compiled program
    # differs).
    trace_cap: int = 0
    # prefix-coverage sketch (obs/causal.py, parallel/stats.py): number
    # of on-device checkpoint slots per lane. 0 (default) compiles the
    # sketch out (zero-size column, no fold code in the step). > 0 folds
    # the running `sched_hash` into slot j after the lane's
    # (j+1)*sketch_every-th dispatch, so two lanes' sketches first
    # differ at the slot whose prefix first diverged — a per-lane
    # divergence DEPTH (not just a terminal distinct/same bit) that
    # never leaves the device mid-run. Like trace_cap, an observation
    # lever: the fold consumes no randomness and touches no non-sketch
    # state, so trajectories are BIT-IDENTICAL across settings.
    # sketch_slots is STRUCTURAL (it shapes the column); sketch_every is
    # DYNAMIC (SimState.sketch_every — retune without recompile).
    sketch_slots: int = 0
    sketch_every: int = 64
    # sim-profiler counter plane (obs/profiler.py, DESIGN §16): False
    # (default) compiles the counters out entirely — zero-size columns,
    # no counter code in the step. True adds per-lane, on-device
    # counters written through the step's existing one-hot dispatch
    # machinery: per-node dispatch counts by event kind, per-node busy
    # virtual time, event-table occupancy high-water mark, message
    # drop/delay totals, per-node kill/restart counts. Counters SATURATE
    # at int32 max instead of wrapping. Like trace_cap, an observation
    # lever, not a replay domain: the writes consume no randomness and
    # touch no non-counter state, so trajectories are BIT-IDENTICAL
    # across settings and the pf_* columns are excluded from
    # fingerprints (TRACE_FIELDS). Per-lane masking rides
    # `init_batch(profile_lanes=...)` — a build can ship with
    # profile=True and flip lanes on per sweep (the masked-off overhead
    # bar is ≤3% on the tiny-step worst case, bench.py --mode prof_ab).
    profile: bool = False
    # SLO latency plane (obs/profiler.py, DESIGN §17): number of log2
    # buckets in the on-device request-latency histograms. 0 (default)
    # compiles the plane out entirely — zero-size columns, no latency
    # code in the step. > 0 adds, per lane:
    #   lh_sojourn [N, B]  queue-wait per dispatch (now − the dispatched
    #                      row's deadline), bucketed by floor-log2 ticks
    #                      at the acting node;
    #   lh_e2e     [N, B]  END-TO-END request latency: every pending row
    #                      carries the birth time of its causal ROOT
    #                      (ev_root_t — external/scenario rows mint
    #                      root = dispatch `now`, emissions inherit the
    #                      dispatching event's root through the same
    #                      broadcast-select as the r10 provenance pair),
    #                      and a dispatch of a model-declared COMPLETION
    #                      kind (complete_kinds below) folds now − root
    #                      into the completion node's histogram;
    #   lh_slo_miss [N]    completions whose e2e latency exceeded the
    #                      DYNAMIC per-lane SimState.slo_target knob
    #                      (slo_target below; 0 disables — retune or
    #                      fuzz the target without recompile).
    # Bucket j holds latencies in [2^(j-1), 2^j) ticks (bucket 0 = zero
    # ticks); 32 buckets cover the whole int32 tick range. Counts
    # SATURATE at int32 max (the §16 discipline). Like trace_cap, an
    # observation lever, not a replay domain: the writes consume no
    # randomness and touch no non-latency state, trajectories are
    # BIT-IDENTICAL across settings, and the lh_*/ev_root_t columns
    # ride TRACE_FIELDS out of fingerprints. Per-lane masking rides
    # `init_batch(latency_lanes=...)`. (Installing harness.slo_invariant
    # deliberately pierces this: an SLO miss becomes a crash code —
    # that runtime's replay domain includes the plane, see DESIGN §17.)
    latency_hist: int = 0
    # which dispatches COMPLETE a request, as ((event_kind, tag), ...)
    # pairs — e.g. ((EV_MSG, CRSP),) for "client saw its reply".
    # STRUCTURAL: the completion mask compiles into the step. Empty
    # (default) = no end-to-end tracking; the sojourn histogram still
    # fills (it needs no request notion).
    complete_kinds: tuple = ()
    # which dispatches START a request: ((event_kind, tag), ...) pairs
    # that MINT a fresh root (root = dispatch now) instead of
    # inheriting the chain's. External dispatches (scenario rows, node
    # boots, host injections) always mint — an OPEN-loop client whose
    # arrivals are scenario rows needs no root_kinds at all. Declare a
    # CLOSED-loop client's new-request timer here (e.g.
    # ((EV_TIMER, T_NEW),)), or its e2e would measure time since the
    # chain's external root (the node's boot), not per-request latency.
    # A pair may appear in BOTH complete_kinds and root_kinds (a reply
    # delivery that starts the next sequential call): the completion
    # measures against the INHERITED root, then the mint restarts the
    # chain. CAVEAT (DESIGN §17): roots ride the single-parent causal
    # chain, so pick completion events whose chain actually descends
    # from the request — a reply emitted while applying a REPLICATION
    # ack (raft-backed servers) descends from the ack chain, not the
    # request; measure such systems at a chain-correct point (e.g. the
    # request's arrival at the group) or use a direct-reply server.
    root_kinds: tuple = ()
    # initial SimState.slo_target in ticks (DYNAMIC knob — the per-lane
    # state field is what the miss counter compares against; 0 disables)
    slo_target: int = 0
    # windowed telemetry plane (obs/series.py, DESIGN §22): number of
    # sim-time WINDOWS in the on-device metric series. 0 (default)
    # compiles the plane out entirely — zero-size columns, no series
    # code in the step. > 0 adds, per lane, saturating per-window
    # series written through the step's one-hot dispatch machinery:
    #   sr_dispatch [W, N]  dispatches by (window, acting node);
    #   sr_busy     [W, N]  busy virtual ticks by (window, acting node);
    #   sr_qhw      [W]     event-table occupancy high-water inside the
    #                       window (dispatch + emission time, the
    #                       pf_qmax rule per window);
    #   sr_drop     [W]     messages lost in the window;
    #   sr_dup      [W]     duplicate re-arms fired in the window;
    #   sr_complete [W]     request completions (needs latency_hist +
    #                       complete_kinds — zero otherwise);
    #   sr_slo_miss [W]     completions over slo_target in the window;
    #   sr_lat      [W, B]  per-window e2e log2 histograms (compiled in
    #                       only when BOTH this plane and latency_hist
    #                       are — the per-window p99 source);
    #   sr_fault    [W]     SRF_* bitmask of fault classes that landed
    #                       in the window (the recovery oracle's axis).
    # A dispatch at virtual time `now` lands in window
    # min(now // window_len, W - 1): a dispatch exactly ON a window_len
    # boundary opens the NEXT window, and events past W*window_len
    # CLAMP into the last window (size W*window_len >= time_limit for
    # clean tails). Like trace_cap, an observation lever, not a replay
    # domain: the writes consume no randomness and touch no non-series
    # state, trajectories are BIT-IDENTICAL across settings, and the
    # sr_* columns ride TRACE_FIELDS out of fingerprints. Per-lane
    # masking rides `init_batch(series_lanes=...)`; the window COUNT is
    # STRUCTURAL (it shapes the columns), the window LENGTH is the
    # DYNAMIC SimState.window_len operand — retune without recompile
    # (Runtime.set_window_len). Installing harness.recovery_invariant
    # deliberately pierces the transparency contract exactly like
    # slo_invariant does for the latency plane (DESIGN §22).
    series_windows: int = 0
    # initial SimState.window_len in ticks per window (DYNAMIC knob,
    # like slo_target/sketch_every; default 1 simulated second)
    window_len: int = TICKS_PER_SEC
    # critical-path attribution plane (obs/spans.py, DESIGN §24): False
    # (default) compiles the plane out entirely — zero-size columns, no
    # span code in the step. True adds, per lane, carried span columns
    # riding the r10/r16 provenance broadcast-select (every pending row
    # carries its chain's accumulated queue-wait ticks, accumulated
    # network/disk-delay ticks, hop count, the dominant segment's
    # (node, magnitude), and the emitting dispatch's virtual time), and
    # at complete_kinds dispatches folds them through the one-hot
    # machinery into saturating tail-attribution counters:
    #   sa_tail       [N, 4]  per completion node: tail-request count,
    #                         queue-wait ticks, network/disk ticks, hops
    #                         — accumulated ONLY for completions over the
    #                         dynamic SimState.slo_target (tail requests
    #                         attribute; the healthy majority stays out);
    #   sa_bottleneck [N]     how often node n owned a tail request's
    #                         DOMINANT segment (largest queue+transit
    #                         hop) — the bottleneck-node histogram.
    # With trace_cap > 0 the ring also grows a `tr_qw` column (the
    # dispatch's own queue-wait), so a host parent-walk can split every
    # hop into wait vs transit (obs/spans.py `explain_latency`). Like
    # trace_cap, an observation lever, not a replay domain: the writes
    # consume no randomness and touch no non-span state, trajectories
    # are BIT-IDENTICAL across settings, and the ev_span/sa_* columns
    # ride TRACE_FIELDS out of fingerprints. Per-lane masking rides
    # `init_batch(span_lanes=...)`. Requires the latency plane
    # (latency_hist > 0) and complete_kinds — attribution is a property
    # of measured completions.
    span_attr: bool = False
    # emission-write lowering: how staged emissions land in the event
    # table. "onehot" = [E, C] one-hot masked-sum (VPU-friendly — the TPU
    # default); "scatter" = one XLA scatter per column at distinct slot
    # rows (O(E) work — the CPU default: the [E, C] product is the
    # dominant term of the measured n^1.8 cluster-width tax, DESIGN §5).
    # "auto" resolves by backend at trace time. Written VALUES are
    # identical across all three, so trajectories and fingerprints are
    # BIT-IDENTICAL — a lowering lever like table_dtype, not a replay
    # domain.
    emission_write: str = "auto"

    def __post_init__(self):
        assert self.n_nodes >= 1
        assert self.event_capacity >= 4
        assert self.payload_words >= 1
        assert self.trace_cap >= 0
        assert self.sketch_slots >= 0
        assert isinstance(self.profile, bool)
        assert 0 <= self.latency_hist <= 32, \
            "latency_hist is a log2 BUCKET COUNT; 32 covers int32 ticks"
        assert self.slo_target >= 0
        assert self.series_windows >= 0
        assert self.window_len >= 1, \
            "window_len is ticks per series window; must be >= 1"
        # normalize to a tuple of (kind, tag) int pairs (frozen dataclass:
        # go through object.__setattr__) so the signature/hash are stable
        # across list-vs-tuple spellings
        for field in ("complete_kinds", "root_kinds"):
            object.__setattr__(
                self, field,
                tuple((int(p[0]), int(p[1])) for p in getattr(self, field)))
            for pair in getattr(self, field):
                # messages/timers only: a supervisor op is an external
                # CAUSE (it mints a root by being external), never a
                # request boundary — and its scheduled row may carry a
                # NODE_RANDOM placeholder that would misattribute the
                # completion's node
                assert pair[0] in (EV_MSG, EV_TIMER), \
                    f"{field} entries are (EV_MSG|EV_TIMER, tag) " \
                    f"pairs: {pair}"
        if self.complete_kinds or self.root_kinds or self.slo_target:
            assert self.latency_hist > 0, \
                "complete_kinds/root_kinds/slo_target need the latency " \
                "plane compiled in (latency_hist > 0)"
        assert isinstance(self.span_attr, bool)
        if self.span_attr:
            assert self.latency_hist > 0 and self.complete_kinds, \
                "span_attr attributes measured completions: it needs " \
                "the latency plane (latency_hist > 0) AND complete_kinds"
        assert self.sketch_every >= 1
        assert self.table_dtype in ("int32", "int16")
        assert self.emission_write in ("auto", "onehot", "scatter")
        if self.table_dtype == "int16":
            assert self.n_nodes < 2**15, "int16 t_node caps nodes at 32767"

    @property
    def trace_cap_bucket(self) -> int:
        """Ring capacity as COMPILED: trace_cap rounded up to the next
        power of two (0 stays 0 — recorder compiled out). The exact
        trace_cap value rides dynamically in SimState and masks the ring
        down, so sweeping trace_cap within one bucket shares one
        executable; rows past trace_cap are never written."""
        return next_pow2(self.trace_cap)

    def structural_signature(self) -> tuple:
        """The shape/lowering-affecting slice of this config — what keys
        a step-program compile (`compile.PROGRAM_CACHE`). Two configs
        with equal signatures trace to the same program; their dynamic
        knobs (time_limit, NetConfig scalar values, exact trace_cap)
        ride as operands. `emission_write` stays raw here — 'auto'
        resolves per backend at trace time, and the cache keys the
        backend separately."""
        return ("simconfig-v8", self.n_nodes, self.event_capacity,
                self.payload_words, self.table_dtype, self.emission_write,
                bool(self.collect_stats), self.trace_cap_bucket,
                self.sketch_slots, self.net.op_jitter_max > 0,
                bool(self.profile),
                self.latency_hist, self.complete_kinds, self.root_kinds,
                # v7 (r21): the windowed-telemetry plane's window COUNT —
                # appended at the END so the _SIG_WORLD_IDX world-slice
                # indices (core/state.py) keep naming the same fields
                self.series_windows,
                # v8 (r23): the critical-path attribution plane's gate —
                # appended at the END, same rationale
                bool(self.span_attr))

    def hash(self) -> str:
        """Stable 8-hex-digit config hash, printed on test failure so a repro
        requires the same config — madsim sim::config::Config::hash
        (config.rs:27-31) and the MADSIM_CONFIG_HASH echo (macros lib.rs:189).
        Covers EVERY field (dynamic knobs change trajectories even though
        they no longer key compiles — replay domain != compile domain).
        """
        blob = json.dumps(dataclasses.asdict(self), sort_keys=True)
        return hashlib.sha256(blob.encode()).hexdigest()[:8]


def next_pow2(n: int) -> int:
    """Smallest power of two >= n (0 -> 0): the bucketing rule for
    capacity-like knobs whose exact value rides as a dynamic operand."""
    n = int(n)
    return 0 if n <= 0 else 1 << (n - 1).bit_length()


def ms(x: float) -> int:
    """Milliseconds -> ticks."""
    return int(x * TICKS_PER_MS)


def sec(x: float) -> int:
    """Seconds -> ticks."""
    return int(x * TICKS_PER_SEC)


PyTree = Any
