"""The port's named workloads, built exactly as the JAX package builds them.

  flagship_runtime   the batched MadRaft chaos sweep behind the repo's
                     headline metric (bench.py `_make_runtime`): 5 Raft
                     nodes, 96 event rows, 8 payload words, log capacity
                     32, 24 commands per leader stint, 5% packet loss and
                     8 rolling kill / restart / partition / heal cycles;
                     optionally with the flight recorder (trace_cap).
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


def flagship_runtime(device=None, n_nodes: int = 5, trace_cap: int = 0):
    """bench.py's flagship; trace_cap > 0 compiles the flight recorder
    and lineage in (they change no other leaf)."""
    from .models.raft import make_raft_runtime
    n = n_nodes
    cfg = SimConfig(n_nodes=n, event_capacity=max(96, 16 * n),
                    time_limit=sec(600), payload_words=8,
                    trace_cap=trace_cap,
                    net=NetConfig(packet_loss_rate=0.05))
    sc = Scenario()
    for t in range(8):  # rolling chaos, one cycle per simulated second
        sc.at(sec(1 + t)).kill_random()
        sc.at(sec(1 + t) + ms(400)).restart_random()
        sc.at(sec(1 + t) + ms(600)).partition([t % n, (t + 1) % n])
        sc.at(sec(1 + t) + ms(900)).heal()
    return make_raft_runtime(n, log_capacity=32, n_cmds=24, scenario=sc,
                             cfg=cfg, device=device)


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
