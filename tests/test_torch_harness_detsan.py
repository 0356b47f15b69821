"""The determinism sanitizer on whole sweeps, against the JAX package
(tolerance: zero), on the CPU: `detsan_check` on Raft (make_raft_runtime(3,
8), through `run_fused`) and on wal_kv (through `run`, with an explicit
lane permutation) at 512 steps, each report (ok, batch, leaves, diffs,
perm) equal to the JAX package's. The JAX side runs on the
non-partitionable threefry stream (see _torch_parity), once per module.
"""

import numpy as np
import pytest

from _torch_parity import one_cpu_thread, reference_stream  # noqa: F401
from madsim_tpu.harness import simtest as jsim
from madsim_tpu_torch.harness import simtest as sim

SEEDS = np.arange(16)
# case: (fused, perm)
CASES = {"raft": (True, None), "wal_kv": (False, SEEDS[::-1].copy())}

pytestmark = pytest.mark.usefixtures("one_cpu_thread")


def _jax_runtime(name):
    from madsim_tpu.models.raft import make_raft_runtime
    from madsim_tpu.models.wal_kv import make_wal_kv_runtime
    return make_raft_runtime(3, 8) if name == "raft" \
        else make_wal_kv_runtime()


def _port_runtime(name):
    from madsim_tpu_torch.models.raft import make_raft_runtime
    from madsim_tpu_torch.models.wal_kv import make_wal_kv_runtime
    return make_raft_runtime(3, 8, device="cpu") if name == "raft" \
        else make_wal_kv_runtime(device="cpu")


@pytest.fixture(scope="module")
def jax_detsan():
    with reference_stream():
        return {name: jsim.detsan_check(_jax_runtime(name), SEEDS, 512,
                                        chunk=64, fused=fused, perm=perm)
                for name, (fused, perm) in CASES.items()}


@pytest.mark.parametrize("name", sorted(CASES))
def test_detsan_check_reports_as_the_jax_package(jax_detsan, name):
    fused, perm = CASES[name]
    got = sim.detsan_check(_port_runtime(name), SEEDS, 512, chunk=64,
                           fused=fused, perm=perm)
    assert got == jax_detsan[name]
    assert got["ok"] and got["diffs"] == [] and got["batch"] == 16
