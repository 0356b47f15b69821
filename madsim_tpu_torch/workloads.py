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
  echo_config3_runtime  BASELINE.md config 3 (scripts/baseline_configs.py
                     `config3`): the tonic-style RPC echo service, one
                     server and two clients of 10 calls each, under 10%
                     packet loss and a server kill/restart
  kv_config4_runtime BASELINE.md config 4 (scripts/baseline_configs.py
                     `config4`): the replicated KV store on Raft, 5
                     servers and 3 clients of 6 ops on 3 keys, log 32,
                     5% loss, three kill_random/restart_random pairs
                     among the servers, 8 s
  kv_default_runtime `models.raft_kv.make_kv_runtime()` at its defaults
                     (log 64, 128 event rows, 20 s)
  kv_snapshot_runtime the reference's compaction chaos config
                     (tests/test_kv_snapshot.py:88): log 12 with
                     compact_threshold 4 (the window slides), 10 ops a
                     client, four kill/restart pairs and a partition
  bank_chaos_runtime the reference's bank chaos config
                     (tests/test_bank.py:29): log 48, 96 event rows,
                     13 payload words, four kill/restart pairs and a
                     partition
  chain_runtime      chain replication at make_chain_runtime's shapes
                     (C=384, 6 nodes, 12 payload words) under the
                     reference's loss chaos (tests/test_chain.py:76): 20
                     ops a client, 5% loss, a replica killed at 250 ms
  chain_buggy_runtime the reference's short master wait
                     (tests/test_chain.py:86): the tail paused through
                     the impatient master's reconfiguration; the
                     two-tails invariant crashes lanes with 501
  ministream_runtime the streaming dataflow under mapper chaos
                     (tests/test_ministream.py:32): three kill/restart
                     pairs among the mappers
  ministream_overtake_runtime  the alignment bug (tests/test_ministream.py
                     :46, strict_barrier=False): lanes crash with 401
  percolator_runtime Percolator-lite at make_percolator_runtime's
                     defaults (C=256, 5 nodes), no faults
  percolator_gray_runtime  the reference's slow-disk recipe
                     (tests/test_grayfail.py:446-454): server 0's disk
                     100-700 ms at 20 ms, 12 ops a client; lanes crash
                     with 501
  shardkv_runtime    bench.py's sharded KV (bench.py:276-283): a 3-node
                     controller group, two 3-node kv groups, 2 clients of
                     64 ops, log 192, max_cfg 8, 160 event rows, 600 s
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


def echo_config3_runtime(device=None):
    """BASELINE.md config 3 as scripts/baseline_configs.py `config3`
    builds it: 3 nodes (the server and two clients, node_prog [0, 1, 1]),
    48 event rows, a 6 s limit, 10% packet loss, the server killed at
    300 ms and restarted at 700 ms, 10 calls a client with a 60 ms retry
    timeout; no halt_when (every lane runs to its time limit)."""
    from .models.rpc_echo import EchoClient, EchoServer, server_state_spec
    from .runtime.runtime import Runtime
    sc = Scenario()
    sc.at(ms(300)).kill(0)
    sc.at(ms(700)).restart(0)
    cfg = SimConfig(n_nodes=3, event_capacity=48, time_limit=sec(6),
                    net=NetConfig(packet_loss_rate=0.1))
    return Runtime(cfg, [EchoServer(), EchoClient(target=10,
                                                  timeout=ms(60))],
                   server_state_spec(), node_prog=[0, 1, 1], scenario=sc,
                   device=device)


def kv_config4_runtime(device=None):
    """BASELINE.md config 4 exactly as scripts/baseline_configs.py
    `config4` builds it: make_kv_runtime(n_raft=5, n_clients=3,
    n_keys=3, n_ops=6, log_capacity=32) on 8 nodes, 96 event rows, 12
    payload words, 5% loss, servers killed at 700 + 900 t ms and
    restarted at 1200 + 900 t ms (t = 0, 1, 2), an 8 s limit."""
    from .models.raft_kv import make_kv_runtime
    sc = Scenario()
    for t in range(3):
        sc.at(ms(700 + 900 * t)).kill_random(among=range(5))
        sc.at(ms(1200 + 900 * t)).restart_random(among=range(5))
    cfg = SimConfig(n_nodes=8, event_capacity=96, payload_words=12,
                    time_limit=sec(8), net=NetConfig(packet_loss_rate=0.05))
    return make_kv_runtime(n_raft=5, n_clients=3, n_keys=3, n_ops=6,
                           log_capacity=32, scenario=sc, cfg=cfg,
                           device=device)


def kv_default_runtime(device=None):
    """make_kv_runtime() at its defaults: 5 servers, 3 clients of 12 ops
    on 4 keys, log 64, 128 event rows, 12 payload words, 20 s."""
    from .models.raft_kv import make_kv_runtime
    return make_kv_runtime(device=device)


def _chaos_servers(n_raft: int, first: int, every: int):
    """Four kill_random/restart_random pairs among the servers (the
    restart 500 ms after each kill), a partition of nodes 0 and 1 at
    2 s and a heal at 3 s."""
    sc = Scenario()
    for t in range(4):
        sc.at(ms(first + every * t)).kill_random(among=range(n_raft))
        sc.at(ms(first + 500 + every * t)).restart_random(
            among=range(n_raft))
    sc.at(sec(2)).partition([0, 1])
    sc.at(sec(3)).heal()
    return sc


def kv_snapshot_runtime(device=None):
    """The reference's tests/test_kv_snapshot.py:88 config: 5 servers and
    3 clients of 10 ops on 3 keys, log 12 with compact_threshold 4 (the
    log window slides; the invariant takes its pairwise form), 128 event
    rows, 1-10 ms latency, 5% loss, kills at 900 + 900 t ms, a 12 s
    limit."""
    from .models.raft_kv import make_kv_runtime
    cfg = SimConfig(n_nodes=8, event_capacity=128, payload_words=12,
                    time_limit=sec(12),
                    net=NetConfig(packet_loss_rate=0.05,
                                  send_latency_min=ms(1),
                                  send_latency_max=ms(10)))
    return make_kv_runtime(5, 3, n_keys=3, n_ops=10, log_capacity=12,
                           scenario=_chaos_servers(5, 900, 900), cfg=cfg,
                           compact_threshold=4, device=device)


def bank_chaos_runtime(device=None):
    """The reference's tests/test_bank.py:29 config: 5 servers and 3
    clients of 8 ops over 6 accounts, log 48, 96 event rows, 13 payload
    words, 5% loss, kills at 800 + 800 t ms, an 8 s limit."""
    from .models.bank import make_bank_runtime
    cfg = SimConfig(n_nodes=8, event_capacity=96, payload_words=13,
                    time_limit=sec(8), net=NetConfig(packet_loss_rate=0.05))
    return make_bank_runtime(n_raft=5, n_clients=3, n_ops=8,
                             log_capacity=48,
                             scenario=_chaos_servers(5, 800, 800), cfg=cfg,
                             device=device)


def chain_runtime(device=None):
    """tests/test_chain.py:76-83: make_chain_runtime(3, 2, 20) on 6 nodes,
    384 event rows, 12 payload words, 1-8 ms latency, 5% loss, a random
    replica killed at 250 ms, a 12 s limit."""
    from .models.chain import make_chain_runtime
    sc = Scenario()
    sc.at(ms(250)).kill_random(among=range(1, 4))
    cfg = SimConfig(n_nodes=6, event_capacity=384, payload_words=12,
                    time_limit=sec(12),
                    net=NetConfig(packet_loss_rate=0.05,
                                  send_latency_min=ms(1),
                                  send_latency_max=ms(8)))
    return make_chain_runtime(3, 2, 20, scenario=sc, cfg=cfg, device=device)


def chain_buggy_runtime(device=None):
    """tests/test_chain.py:86-100: the tail (node 3) paused at 150 ms and
    resumed at 330 ms under a 400 ms lease and a 1 ms master wait, an 8 s
    limit; the two-tails invariant crashes lanes with 501."""
    from .models.chain import make_chain_runtime
    sc = Scenario()
    sc.at(ms(150)).pause(3)
    sc.at(ms(330)).resume(3)
    cfg = SimConfig(n_nodes=6, event_capacity=384, payload_words=12,
                    time_limit=sec(8),
                    net=NetConfig(send_latency_min=ms(1),
                                  send_latency_max=ms(8)))
    return make_chain_runtime(3, 2, 20, scenario=sc, cfg=cfg,
                              lease=ms(400), master_wait=ms(1),
                              device=device)


def _mapper_chaos():
    """tests/test_ministream.py:36-40: kill a random mapper at 300 +
    700 t ms and restart one at 600 + 700 t ms (t = 0, 1, 2)."""
    from .models.ministream import MAP_A, MAP_B
    sc = Scenario()
    for t in range(3):
        sc.at(ms(300 + 700 * t)).kill_random(among=(MAP_A, MAP_B))
        sc.at(ms(600 + 700 * t)).restart_random(among=(MAP_A, MAP_B))
    return sc


def ministream_runtime(device=None):
    """tests/test_ministream.py:32-44: k=8, 4 epochs, 160 event rows, 5%
    loss, the mapper chaos, a 60 s limit."""
    from .models.ministream import make_ministream_runtime
    return make_ministream_runtime(k=8, epochs=4, scenario=_mapper_chaos(),
                                   device=device)


def ministream_overtake_runtime(device=None):
    """tests/test_ministream.py:46-52: strict_barrier=False under 5% loss;
    the exactly-once oracle crashes lanes with 401."""
    from .models.ministream import make_ministream_runtime
    return make_ministream_runtime(k=8, epochs=4, strict_barrier=False,
                                   device=device)


def percolator_runtime(device=None):
    """make_percolator_runtime() at its defaults: 2 shard servers and 3
    clients of 9 ops over 6 keys, 256 event rows, 8 payload words, 10 s
    (tests/test_grayfail.py:438-443)."""
    from .models.percolator import make_percolator_runtime
    return make_percolator_runtime(device=device)


def percolator_gray_runtime(device=None):
    """tests/test_grayfail.py:446-454: chaos.slow_disk(100 ms, 20 ms,
    700 ms, node=0) with 12 ops a client; lanes crash with 501."""
    from .models.percolator import make_percolator_runtime
    from .runtime import chaos
    sc = chaos.slow_disk(ms(100), ms(20), ms(700), node=0)
    return make_percolator_runtime(n_ops=12, scenario=sc, device=device)


def shardkv_runtime(device=None):
    """bench.py:276-283 (`_shardkv_mode`): make_shard_runtime(n_groups=2,
    rg=3, rc=3, n_clients=2, n_ops=64, max_cfg=8, log_capacity=192) on 11
    nodes, 160 event rows, 12 payload words, 1-10 ms latency, a 600 s
    limit."""
    from .models.shard_kv import make_shard_runtime
    cfg = SimConfig(n_nodes=11, event_capacity=160, payload_words=12,
                    time_limit=sec(600),
                    net=NetConfig(send_latency_min=ms(1),
                                  send_latency_max=ms(10)))
    return make_shard_runtime(n_groups=2, rg=3, rc=3, n_clients=2,
                              n_ops=64, max_cfg=8, log_capacity=192,
                              cfg=cfg, device=device)


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
