"""Canned chaos recipes — reusable Scenario builders.

(The port's own copy of `madsim_tpu.runtime.chaos`: host-only Python
over this package's Scenario, so a recipe builds the same rows in both
packages.)

The reference's chaos tests hand-roll the same supervisor futures over and
over (MadRaft's random_kill/random_partition loops; tonic-example's
crash-the-server); so did this repo's test files. These builders capture
the recurring shapes once. Each takes an optional `sc` to compose onto and
returns it, so recipes chain:

    sc = chaos.rolling_kills(rounds=4, among=range(5))
    sc = chaos.split_brain(at=sec(2), group=[0, 1], heal_after=sec(1), sc=sc)
"""

from __future__ import annotations

from ..core.types import ms, sec
from .scenario import Scenario


def rolling_kills(rounds: int = 4, first=ms(800), period=ms(900),
                  down=ms(500), among=None, sc: Scenario | None = None):
    """Kill a random eligible node every `period`, restarting it `down`
    later — the MadRaft random_kill loop."""
    sc = sc or Scenario()
    for t in range(rounds):
        sc.at(first + period * t).kill_random(among=among)
        sc.at(first + period * t + down).restart_random(among=among)
    return sc


def rolling_pauses(rounds: int = 4, first=ms(800), period=ms(900),
                   down=ms(300), among=None, sc: Scenario | None = None):
    """Pause/resume churn: nodes freeze (clock keeps moving — leases and
    timeouts expire around them) instead of dying."""
    sc = sc or Scenario()
    for t in range(rounds):
        sc.at(first + period * t).pause_random(among=among)
        sc.at(first + period * t + down).resume_random(among=among)
    return sc


def split_brain(at, group, heal_after, sc: Scenario | None = None):
    """Partition `group` from everyone else, heal after `heal_after`."""
    sc = sc or Scenario()
    sc.at(at).partition(group)
    sc.at(at + heal_after).heal()
    return sc


def flaky_network(at, loss: float, until, latency=None,
                  restore_loss: float = 0.0, restore_latency=None,
                  heal: bool = True, sc: Scenario | None = None):
    """Degrade the network for a window: raise loss (and optionally the
    latency range), then restore.

    `heal=True` (default) also emits OP_HEAL at the window end: the
    loss/latency scalars restore by themselves, but per-LINK state (clogs,
    partitions, one-way cuts) composed into the same window by other
    recipes has no scalar to restore through — without the heal a
    composed recipe could leak cuts past its window. A heal on a
    cut-free scenario clears nothing."""
    sc = sc or Scenario()
    sc.at(at).set_loss(loss)
    if latency is not None:
        sc.at(at).set_latency(*latency)
    sc.at(until).set_loss(restore_loss)
    if restore_latency is not None:
        sc.at(until).set_latency(*restore_latency)
    if heal:
        sc.at(until).heal()
    return sc


def madraft_churn(servers, rounds: int = 4, first=ms(800), period=ms(900),
                  down=ms(500), partition_at=sec(2), partition_group=(0, 1),
                  heal_after=sec(1), sc: Scenario | None = None):
    """The standard MadRaft fuzz mix: rolling kills over the servers plus
    one partition/heal cycle — the shape BASELINE.md configs 2/4 use."""
    sc = rolling_kills(rounds, first, period, down, among=servers, sc=sc)
    return split_brain(partition_at, list(partition_group), heal_after,
                       sc=sc)


# ---------------------------------------------------------------------------
# gray-failure recipes (r17, DESIGN §18): the fault shapes madsim simulates
# that clean kills and symmetric partitions cannot express — each is a
# knob-plane scenario, so the fuzzer mutates its times/targets/values for
# free (search/mutate.py fault_perturb).
# ---------------------------------------------------------------------------

def asymmetric_partition(at, group, heal_after, direction: int = 0,
                         sc: Scenario | None = None):
    """One-way cut for a window (madsim disconnect2 parity): direction 0
    silences `group`'s OUTBOUND traffic while it still hears everything —
    the classic gray failure where a node looks alive to itself (inbound
    heartbeats arrive) but the cluster stopped hearing it. Healed at
    window end (one-way cuts have no scalar to restore through)."""
    sc = sc or Scenario()
    sc.at(at).partition_oneway(group, direction=direction)
    sc.at(at + heal_after).heal()
    return sc


def clock_drift(at, skew: int, node=None, among=None, until=None,
                sc: Scenario | None = None):
    """Skew one node's clock rate by `skew`/1024 from `at` (a random
    pool-restricted node when `node` is None), restoring a synchronized
    clock at `until` when given. Positive skew = fast clock: leases and
    timeouts expire early in global time."""
    sc = sc or Scenario()
    if node is None:
        sc.at(at).set_skew_random(skew, among=among)
        if until is not None:
            # restore over the same pool: the restore targets a random
            # pool member too — with a 1-node pool it is exact; wider
            # pools model operators fixing one drifting clock at a time
            sc.at(until).set_skew_random(0, among=among)
    else:
        sc.at(at).set_skew(node, skew)
        if until is not None:
            sc.at(until).set_skew(node, 0)
    return sc


def slow_disk(at, latency, until, node=None, among=None,
              sc: Scenario | None = None):
    """Stall one node's disk for a window: every emission it makes
    (acks, replication, its own timers) leaves `latency` ticks late —
    the limping-but-alive node gray failure."""
    sc = sc or Scenario()
    if node is None:
        sc.at(at).set_disk_random(latency, among=among)
        sc.at(until).set_disk_random(0, among=among)
    else:
        sc.at(at).set_disk(node, latency)
        sc.at(until).set_disk(node, 0)
    return sc


def torn_write_kill(at, node, down=ms(500), sc: Scenario | None = None):
    """Power-fail `node` with a TORN final write: torn mode is armed one
    tick before the kill (same-instant ops would tie-break randomly
    against it), so the kill flushes a random prefix of each fs file's
    unsynced tail — recovery sees a partially-written final record
    instead of clean old-or-new. Restarts `down` later with a healthy
    disk."""
    sc = sc or Scenario()
    sc.at(at - 1).set_disk(node, 0, torn=True)
    sc.at(at).kill(node)
    sc.at(at + down).restart(node)
    sc.at(at + down + 1).set_disk(node, 0, torn=False)
    return sc


# ---------------------------------------------------------------------------
# connection-fault recipes (r19, DESIGN §20): TCP-grade transport faults —
# the fault shapes madsim's NetSim::reset_node injects that datagram-level
# loss/latency cannot express. Knob-plane scenarios like everything else,
# so the fuzzer mutates times/targets/rates for free (fault_perturb).
# ---------------------------------------------------------------------------

def conn_reset_storm(rounds: int = 3, first=ms(300), period=ms(450),
                     node=None, among=None, sc: Scenario | None = None):
    """Repeatedly tear down every connection touching the target (a
    random pool member when `node` is None) — the reset_node churn
    regime: established sessions die mid-pipeline on BOTH sides, and
    whatever was in flight belongs to a dead incarnation. Sound
    transports re-handshake onto a fresh epoch; unsound ones accept the
    dead incarnation's retransmits into the new window."""
    sc = sc or Scenario()
    for t in range(rounds):
        if node is None:
            sc.at(first + period * t).reset_peer_random(among=among)
        else:
            sc.at(first + period * t).reset_peer(node)
    return sc


def retransmit_storm(at, rate: float, until, node=None, among=None,
                     sc: Scenario | None = None):
    """Duplicate-delivery window: every datagram dispatched at the target
    is redelivered with probability `rate` (duplicates can duplicate
    again — a geometric storm) from `at` until `until` — the regime a
    Go-Back-N transport's exactly-once claim must survive."""
    sc = sc or Scenario()
    if node is None:
        sc.at(at).set_dup_random(rate, among=among)
        sc.at(until).set_dup_random(0, among=among)
    else:
        sc.at(at).set_dup(node, rate)
        sc.at(until).set_dup(node, 0)
    return sc


def half_open_churn(node, rounds: int = 2, first=ms(300), period=ms(600),
                    down=ms(150), sc: Scenario | None = None):
    """Kill/restart churn that leaves HALF-OPEN connections behind — a
    kill alone deliberately does NOT tear the survivors' conn state
    (conn.py: only a reset does), so peers keep talking to an
    ESTABLISHED ghost until a reset-peer pulse at the end of each round
    finally tears both sides down. Composes with gray_failure like
    every recipe."""
    sc = sc or Scenario()
    for t in range(rounds):
        t0 = first + period * t
        sc.at(t0).kill(node)
        sc.at(t0 + down).restart(node)
        sc.at(t0 + down + ms(100)).reset_peer(node)
    return sc


def gray_failure(at, until, group=(0,), skew: int = 256,
                 disk_latency=ms(20), direction: int = 0,
                 sc: Scenario | None = None):
    """The composed gray-failure window: one-way partition the group,
    drift the first member's clock fast, and stall its disk — then
    restore EVERYTHING at `until`, including an OP_HEAL so the one-way
    cuts (which have no restore scalar) cannot leak past the window."""
    sc = sc or Scenario()
    members = list(group)
    sc.at(at).partition_oneway(members, direction=direction)
    sc.at(at).set_skew(members[0], skew)
    sc.at(at).set_disk(members[0], disk_latency)
    sc.at(until).set_skew(members[0], 0)
    sc.at(until).set_disk(members[0], 0)
    sc.at(until).heal()
    return sc
