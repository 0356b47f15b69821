"""The port's named workloads, built exactly as the JAX package builds them.

  flagship_runtime   the batched MadRaft chaos sweep behind the repo's
                     headline metric (bench.py `_make_runtime`): 5 Raft
                     nodes, 96 event rows, 8 payload words, log capacity
                     32, 24 commands per leader stint, 5% packet loss and
                     8 rolling kill / restart / partition / heal cycles.
  pingpong_runtime   the frozen golden pingpong workload
                     (tests/_grayfail_golden.py `build_pingpong`) with the
                     flight recorder compiled out (trace_cap=0), whose
                     engine leaves are recorded in
                     tests/data/golden_r22_leaves.json.
"""

from __future__ import annotations

from .core.types import NetConfig, SimConfig, ms, sec
from .runtime.scenario import Scenario

# run parameters of the frozen pingpong golden (tests/_grayfail_golden.py)
PINGPONG_RUN = dict(seeds=64, max_steps=4000, chunk=256)

# golden leaves that belong to the flight recorder and lineage planes: the
# golden run had the recorder compiled in, this port's run has it out
RECORDER_LEAVES = (".ev_prov", ".lamport", ".trace_cap", ".trace_on",
                   ".trace_pos", ".tr_now", ".tr_step", ".tr_kind",
                   ".tr_node", ".tr_src", ".tr_tag", ".tr_parent",
                   ".tr_lamport")


def flagship_runtime(device=None, n_nodes: int = 5):
    from .models.raft import make_raft_runtime
    n = n_nodes
    cfg = SimConfig(n_nodes=n, event_capacity=max(96, 16 * n),
                    time_limit=sec(600), payload_words=8,
                    net=NetConfig(packet_loss_rate=0.05))
    sc = Scenario()
    for t in range(8):  # rolling chaos, one cycle per simulated second
        sc.at(sec(1 + t)).kill_random()
        sc.at(sec(1 + t) + ms(400)).restart_random()
        sc.at(sec(1 + t) + ms(600)).partition([t % n, (t + 1) % n])
        sc.at(sec(1 + t) + ms(900)).heal()
    return make_raft_runtime(n, log_capacity=32, n_cmds=24, scenario=sc,
                             cfg=cfg, device=device)


def pingpong_runtime(device=None):
    from .models.pingpong import PingPong, state_spec
    from .runtime.runtime import Runtime
    sc = Scenario()
    sc.at(ms(40)).kill_random()
    sc.at(ms(400)).restart_random()
    cfg = SimConfig(n_nodes=4, time_limit=sec(5), trace_cap=0,
                    net=NetConfig(send_latency_min=ms(1),
                                  send_latency_max=ms(1)))
    return Runtime(cfg, [PingPong(4, target=6)], state_spec(), scenario=sc,
                   device=device)
