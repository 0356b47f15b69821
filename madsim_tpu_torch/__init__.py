"""madsim_tpu_torch — the PyTorch/CUDA port of madsim_tpu.

The batched deterministic simulator of `madsim_tpu`, written for PyTorch
with every state tensor carrying an explicit leading [B] lane axis, and
its device kernels hand-written in CUDA for NVIDIA Hopper (csrc/). The
JAX package stays the reference: for the same config and seeds this
package reproduces its final state leaf for leaf. Entry points run on
CUDA unless the caller passes device="cpu".

    from madsim_tpu_torch import Runtime, Scenario, SimConfig, ms, sec
"""

from .core.api import Ctx, Program
from .core.extension import Extension
from .core.state import (CheckpointMismatch, LaneCheckpoint, SimState,
                         checkpoint_lane, seed_batch_from)
from .core.types import (
    CRASH_DEADLOCK,
    CRASH_INVARIANT,
    CRASH_TIME_LIMIT,
    EV_MSG,
    EV_SUPER,
    EV_TIMER,
    NODE_RANDOM,
    NetConfig,
    SimConfig,
    ms,
    sec,
)
from .harness.simtest import SimFailure, run_seeds, simtest
from .obs.timetravel import (CheckpointLog, ReplayDivergence,
                             divergence_report, full_chain_replay,
                             replay_window)
from .runtime.runtime import Runtime
from .runtime.scenario import Scenario

__all__ = [
    "Ctx", "Program", "Extension", "SimState", "SimConfig", "NetConfig",
    "Runtime", "Scenario", "simtest", "run_seeds", "SimFailure", "ms", "sec",
    "NODE_RANDOM", "EV_MSG", "EV_TIMER", "EV_SUPER", "CRASH_DEADLOCK",
    "CRASH_TIME_LIMIT", "CRASH_INVARIANT",
    "LaneCheckpoint", "CheckpointMismatch", "checkpoint_lane",
    "seed_batch_from", "CheckpointLog", "replay_window",
    "full_chain_replay", "divergence_report", "ReplayDivergence",
]
