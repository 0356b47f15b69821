"""The port's Percolator-lite (`models/percolator.py`) against the JAX
package (tolerance: zero), on the CPU.

The cases are the reference's tests/test_grayfail.py:438-454: green at
`make_percolator_runtime()`'s defaults (no faults: every client done, no
crash); the slow-disk recipe (`chaos.slow_disk` on server 0, 12 ops a
client), whose snapshot audit crashes the same lanes with 501 in both
packages; and one kill/restart of server 0, whose boot replays the
commit WAL from the simulated disk (`fs.mount`, `file_len`, `read_at`).
Seed 201 is green's lane that crashes at the defaults (see CASES). Each
run is held leaf for leaf through `run`. Fewer seeds (1-6, JAX: 24
and 32) and, for the restart case, 6 ops a client: the port's eager CPU
step costs 20-40 ms (ROADMAP F24). The JAX side runs on the
non-partitionable threefry stream (see _torch_parity).
"""

import numpy as np
import pytest

import madsim_tpu as J
import madsim_tpu_torch as P
from _torch_parity import (assert_same, jax_leaves, one_cpu_thread,  # noqa
                           reference_stream)
from madsim_tpu.models import percolator as jp
from madsim_tpu.runtime import chaos as jchaos
from madsim_tpu_torch import interop, workloads
from madsim_tpu_torch.models import percolator as tp

pytestmark = pytest.mark.usefixtures("one_cpu_thread")


def _green(pkg, kw):
    if pkg is P:
        return workloads.percolator_runtime(**kw)
    return jp.make_percolator_runtime()


def _gray(pkg, kw):
    if pkg is P:
        return workloads.percolator_gray_runtime(**kw)
    sc = jchaos.slow_disk(J.ms(100), J.ms(20), J.ms(700), node=0)
    return jp.make_percolator_runtime(n_ops=12, scenario=sc)


def _restart(pkg, kw):
    sc = pkg.Scenario()
    sc.at(pkg.ms(300)).kill(0)
    sc.at(pkg.ms(500)).restart(0)
    mod = jp if pkg is J else tp
    return mod.make_percolator_runtime(n_ops=6, scenario=sc, **kw)


# case: maker(package, device keywords), seeds. Seed 201 is the first of
# the three of 4096 (201, 2745, 3654) whose lane crashes with 501 at the
# defaults with no fault injected, in the JAX package as in the port: the
# lite design rolls back a lock older than its TTL without consulting the
# primary, so a committed transaction whose secondary commit came late
# loses that write, and the snapshot audit sees the fracture.
CASES = {"green": (_green, (0, 1)), "green_ttl_hole": (_green, (201,)),
         "slow_disk": (_gray, tuple(range(6))),
         "server_restart": (_restart, (0, 1, 2))}


@pytest.mark.parametrize("case", sorted(CASES))
def test_percolator_matches_reference(case):
    make, lanes = CASES[case]
    seeds = np.asarray(lanes, dtype=np.uint32)
    with reference_stream():
        jrt = make(J, {})
        s, _ = jrt.run(jrt.init_batch(seeds), 80_000, 256)
        ref = jax_leaves(s)
    rt = make(P, dict(device="cpu"))
    t, _ = rt.run(rt.init_batch(seeds), 80_000, 256)
    got = interop.state_to_numpy(t)
    assert_same(ref, got, what=case)
    assert got[".halted"].all()
    crashed = got[".crashed"]
    if case in ("slow_disk", "green_ttl_hole"):
        assert crashed.any()
        assert (got[".crash_code"][crashed] == tp.CRASH_SNAPSHOT).all()
        return
    assert not crashed.any()
    assert (got[".node_state['c_done']"][:, tp.N_SERVERS:] == 1).all()
    if case == "server_restart":
        # the restarted server rebuilt its log count from the synced WAL
        # on the simulated disk, and went on appending to it
        log_n = got[".node_state['log_n']"][:, 0]
        dlen = got[".node_state['fs_dlen']"][:, 0, tp.LOG]
        assert (log_n > 0).all() and (dlen == 3 * log_n).all()
        assert got[".alive"][:, 0].all()
