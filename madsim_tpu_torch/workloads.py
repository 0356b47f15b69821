"""The port's named workloads, built exactly as the JAX package builds them.

  flagship_runtime   the batched MadRaft chaos sweep behind the repo's
                     headline metric (bench.py `_make_runtime`): 5 Raft
                     nodes, 96 event rows, 8 payload words, log capacity
                     32, 24 commands per leader stint, 5% packet loss and
                     8 rolling kill / restart / partition / heal cycles;
                     optionally with the flight recorder (trace_cap).
  plane_flagship_runtime the flagship with the sim profiler and the
                     latency plane compiled in (profile=True,
                     latency_hist=24), e2e measured from the leader's
                     propose timer to its append replies, and the
                     flight recorder (trace_cap=64)
  all_planes_flagship_runtime  the plane flagship with every other
                     observation plane compiled in too: the prefix
                     sketch (32 slots at the default sketch_every=64),
                     the series plane (16 windows of 625 ms) and the span
                     plane, at an SLO target that some completions miss
  crashrich_wal_kv_runtime  bench.py `_make_crashrich_runtime("wal_kv")`:
                     WAL-KV with an unsynced WAL under six kill/restart
                     pairs of its server, whose lanes really crash
  compacting_runtime the flagship's shapes with a long tail of halts,
                     the regime `Runtime.run_compacting` is for: lanes
                     halt at a commit index of 28 or at 10 simulated s
  pingpong_runtime   the golden pingpong workload with the flight
                     recorder compiled out (trace_cap=0, the default) or
                     in (trace_cap=64: the golden build itself)
  saturating_runtime the search regime of bench.py
                     `_make_saturating_runtime`: the same 4-node pingpong
                     chaos (fixed latency, no loss, random kill/restart),
                     whose schedule space seeds alone exhaust quickly
  all_knobs_runtime  4-node pingpong whose scenario carries every kind of
                     fuzzer knob (value, direction, torn and pool rows; the
                     jitter gate on): the edge-case plan of the search
                     kernels' checks
  build_pingpong     the frozen golden workloads of
  build_wal_kv       tests/_grayfail_golden.py, built with no JAX: pingpong
                     with the recorder (trace_cap=64), and the WAL-KV
                     kill/restart chaos matrix on the simulated filesystem.
                     Their leaf digests, through `run` and `run_fused`
                     (run parameters in GOLDEN_RUNS), are frozen in
                     tests/data/golden_r22_leaves.json.
"""

from __future__ import annotations

from .core.types import NetConfig, SimConfig, ms, sec
from .runtime.scenario import Scenario

# run parameters of the frozen goldens (tests/_grayfail_golden.py RUNS)
PINGPONG_RUN = dict(seeds=64, max_steps=4000, chunk=256)
GOLDEN_RUNS = dict(pingpong=PINGPONG_RUN,
                   wal_kv=dict(seeds=32, max_steps=30_000, chunk=512))

# golden leaves that belong to the flight recorder and lineage planes: the
# golden run had the recorder compiled in, this port's run has it out
RECORDER_LEAVES = (".ev_prov", ".lamport", ".trace_cap", ".trace_on",
                   ".trace_pos", ".tr_now", ".tr_step", ".tr_kind",
                   ".tr_node", ".tr_src", ".tr_tag", ".tr_parent",
                   ".tr_lamport")


def flagship_runtime(device=None, n_nodes: int = 5, trace_cap: int = 0,
                     time_limit: int = sec(600), halt_on_commit: int = 0,
                     **planes):
    """bench.py's flagship; trace_cap > 0 compiles the flight recorder
    and lineage in, `planes` other observation-plane fields of SimConfig
    (they change no other leaf)."""
    from .models.raft import make_raft_runtime
    n = n_nodes
    cfg = SimConfig(n_nodes=n, event_capacity=max(96, 16 * n),
                    time_limit=time_limit, payload_words=8,
                    trace_cap=trace_cap,
                    net=NetConfig(packet_loss_rate=0.05), **planes)
    sc = Scenario()
    for t in range(8):  # rolling chaos, one cycle per simulated second
        sc.at(sec(1 + t)).kill_random()
        sc.at(sec(1 + t) + ms(400)).restart_random()
        sc.at(sec(1 + t) + ms(600)).partition([t % n, (t + 1) % n])
        sc.at(sec(1 + t) + ms(900)).heal()
    return make_raft_runtime(n, log_capacity=32, n_cmds=24, scenario=sc,
                             cfg=cfg, device=device,
                             halt_on_commit=halt_on_commit)


# the plane flagship's latency config: a request starts at the leader's
# propose timer and completes at each append reply
# (madsim_tpu/models/raft.py:35-37 tags)
def plane_config() -> dict:
    from .core.types import EV_MSG, EV_TIMER
    from .models.raft import AER, T_PROPOSE
    return dict(profile=True, latency_hist=24,
                complete_kinds=((EV_MSG, AER),),
                root_kinds=((EV_TIMER, T_PROPOSE),))


def plane_flagship_runtime(device=None, n_nodes: int = 5,
                           trace_cap: int = 64):
    """The flagship with the profiler and the latency plane on every
    lane and the flight recorder (its ring's tr_qlen and tr_lat columns
    too)."""
    return flagship_runtime(device, n_nodes=n_nodes, trace_cap=trace_cap,
                            **plane_config())


# the all-planes flagship's extra planes: 32 sketch slots witness 2048
# steps at sketch_every=64, 16 windows of 625 ms cover the 9.9 simulated
# s of a 2048-step run, and the SLO target sits inside the e2e
# distribution (PERF.md gives the share of completions it misses)
ALL_PLANES_SLO = 5_000_000


def all_planes_config() -> dict:
    return dict(plane_config(), sketch_slots=32, series_windows=16,
                window_len=ms(625), span_attr=True,
                slo_target=ALL_PLANES_SLO)


def all_planes_flagship_runtime(device=None, n_nodes: int = 5,
                                trace_cap: int = 64):
    """The plane flagship with the sketch, series and span planes on
    every lane too (the ring's tr_qw column with them)."""
    return flagship_runtime(device, n_nodes=n_nodes, trace_cap=trace_cap,
                            **all_planes_config())


def crashrich_wal_kv_runtime(device=None, trace_cap: int = 0):
    """bench.py `_make_crashrich_runtime("wal_kv")`: an unsynced WAL
    under six kill/restart pairs of the server, so acknowledged writes
    are lost across crashes and the clients' read-your-writes checks
    crash their lanes."""
    from .models.wal_kv import make_wal_kv_runtime
    sc = Scenario()
    for t in range(6):
        sc.at(ms(150) + ms(250) * t).kill(0)
        sc.at(ms(210) + ms(250) * t).restart(0)
    cfg = SimConfig(n_nodes=3, event_capacity=256, payload_words=8,
                    time_limit=sec(10), trace_cap=trace_cap,
                    net=NetConfig(send_latency_min=ms(1),
                                  send_latency_max=ms(8)))
    return make_wal_kv_runtime(n_clients=2, n_ops=12, wal_cap=64,
                               sync_wal=False, scenario=sc, cfg=cfg,
                               device=device)


def compacting_runtime(device=None):
    """The flagship's shapes (5 Raft nodes, C=96, P=8, 5% loss, 8 chaos
    cycles) halting when a node commits index 28, else at 10 simulated
    seconds: the flagship itself never halts early (a 600 s limit, no
    commit target), and at this target the halts spread over steps
    ~900-2600, the long tail that early-exit compaction is for."""
    return flagship_runtime(device, time_limit=sec(10), halt_on_commit=28)


def pingpong_runtime(device=None, trace_cap: int = 0):
    from .models.pingpong import PingPong, state_spec
    from .runtime.runtime import Runtime
    sc = Scenario()
    sc.at(ms(40)).kill_random()
    sc.at(ms(400)).restart_random()
    cfg = SimConfig(n_nodes=4, time_limit=sec(5), trace_cap=trace_cap,
                    net=NetConfig(send_latency_min=ms(1),
                                  send_latency_max=ms(1)))
    return Runtime(cfg, [PingPong(4, target=6)], state_spec(), scenario=sc,
                   device=device)


def saturating_runtime(device=None):
    """bench.py's saturating search regime, which is this pingpong build:
    where blind seed sweeps go dry and the fuzzer's knob mutations keep
    finding schedules."""
    return pingpong_runtime(device)


def all_knobs_runtime(device=None):
    """Pingpong under skew, slow and torn disks, a one-way cut, duplicate
    delivery and pool-restricted kill/restart, with jitter on: its knob
    plan has value, direction and torn rows, pools and dup slots."""
    from .models.pingpong import PingPong, state_spec
    from .runtime.runtime import Runtime
    sc = Scenario()
    sc.at(ms(5)).set_skew(1, 300)
    sc.at(ms(8)).set_disk(2, ms(2), torn=True)
    sc.at(ms(10)).set_disk(3, ms(1))
    sc.at(ms(12)).partition_oneway([0, 2], direction=1)
    sc.at(ms(15)).set_dup(1, 0.3)
    sc.at(ms(20)).kill_random(among=[0, 1])
    sc.at(ms(40)).restart_random(among=[0, 1])
    sc.at(ms(60)).heal()
    cfg = SimConfig(n_nodes=4, time_limit=sec(2),
                    net=NetConfig(send_latency_min=ms(1),
                                  send_latency_max=ms(1), op_jitter_max=40))
    return Runtime(cfg, [PingPong(4, target=6)], state_spec(), scenario=sc,
                   device=device)


def build_pingpong(device=None):
    """The saturating pingpong chaos workload with the recorder compiled
    in, so ring columns are covered too."""
    return pingpong_runtime(device, trace_cap=64)


def build_wal_kv(device=None):
    """The WAL-KV kill/restart chaos matrix: stable storage, persist
    masks, recovery — the fs-layer workload."""
    from .models.wal_kv import SERVER, make_wal_kv_runtime
    sc = Scenario()
    for t in range(4):
        sc.at(ms(250) + ms(400) * t).kill(SERVER)
        sc.at(ms(250) + ms(400) * t + ms(120)).restart(SERVER)
    return make_wal_kv_runtime(n_clients=2, n_ops=12, wal_cap=8,
                               sync_wal=True, scenario=sc, device=device)


GOLDEN_WORKLOADS = dict(pingpong=build_pingpong, wal_kv=build_wal_kv)
