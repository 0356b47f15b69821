"""The port's lineage-driven fault injection (`harness/witness.py`,
`obs/support.py`, `search/ldfi.py`, `fuzz(ldfi=...)`) against the JAX
package, on the CPU (tolerance: zero).

  * every synthetic case of the JAX package's tests/test_ldfi.py goes
    through both packages' `walk_lineage`, `support_from_records`,
    `success_witness`, `SupportPool` (`add`, `merge`, `ranked`) and
    `synthesize` (seeds pinned, the dragged heal), and the outputs (and
    the refusals' messages) are equal;
  * `extract_support` on live lanes of the LDFI echo runtime
    (tests/test_ldfi.py `_echo_ldfi_rt`, the port's
    `workloads.ldfi_echo_runtime`), with the ring at 64 slots and at 4
    (it wraps; `replay=True` replays each lane from t=0), equal to the
    JAX package's as tests/data/test_torch_ldfi_golden.npz records it
    (the `slow` test_golden_is_the_jax_packages_output runs the
    reference again); the port runs chunks of 32 steps, the reference
    256 (the lanes halt within 40 steps, where a halted lane is a fixed
    point);
  * `fuzz(ldfi=...)` without the flight recorder raises the same
    ValueError.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_ldfi.py -q
"""

import types

import numpy as np
import pytest

import test_ldfi as jt
from _torch_parity import (assert_golden_is_reference, equal_results,  # noqa
                           golden, json_part, one_cpu_thread, part_json,
                           reference_stream)

pytestmark = pytest.mark.usefixtures("one_cpu_thread")

MODULE = "test_torch_ldfi"
SEEDS = np.arange(3, dtype=np.uint32)
LIVE_STEPS = 3000


def _jax():
    from madsim_tpu.core import types as T
    from madsim_tpu.harness.witness import success_witness
    from madsim_tpu.obs.causal import walk_lineage
    from madsim_tpu.obs.support import support_from_records
    from madsim_tpu.search.ldfi import SupportPool, synthesize
    from madsim_tpu import SimConfig, sec
    from madsim_tpu.models.rpc_echo import make_echo_runtime
    from madsim_tpu.obs.support import extract_support
    from madsim_tpu.search import LdfiConfig, fuzz
    from madsim_tpu.search.mutate import KnobPlan

    def bare():
        return make_echo_runtime(
            n_nodes=4, target=3,
            cfg=SimConfig(n_nodes=4, event_capacity=256,
                          time_limit=sec(20), trace_cap=64))
    return types.SimpleNamespace(
        T=T, success_witness=success_witness, walk_lineage=walk_lineage,
        support_from_records=support_from_records, SupportPool=SupportPool,
        synthesize=synthesize, KnobPlan=KnobPlan, echo=jt._echo_ldfi_rt,
        bare=bare, extract_support=extract_support, LdfiConfig=LdfiConfig,
        fuzz=fuzz)


def _port():
    from madsim_tpu_torch import SimConfig, sec, workloads
    from madsim_tpu_torch.core import types as T
    from madsim_tpu_torch.harness import success_witness
    from madsim_tpu_torch.models.rpc_echo import make_echo_runtime
    from madsim_tpu_torch.obs.causal import walk_lineage
    from madsim_tpu_torch.obs.support import (extract_support,
                                              support_from_records)
    from madsim_tpu_torch.search import LdfiConfig, fuzz
    from madsim_tpu_torch.search.ldfi import SupportPool, synthesize
    from madsim_tpu_torch.search.mutate import KnobPlan

    def echo(trace_cap=64, target=3):
        return workloads.ldfi_echo_runtime(trace_cap=trace_cap,
                                           target=target, device="cpu")

    def bare():
        return make_echo_runtime(
            n_nodes=4, target=3,
            cfg=SimConfig(n_nodes=4, event_capacity=256,
                          time_limit=sec(20), trace_cap=64), device="cpu")
    return types.SimpleNamespace(
        T=T, success_witness=success_witness, walk_lineage=walk_lineage,
        support_from_records=support_from_records, SupportPool=SupportPool,
        synthesize=synthesize, KnobPlan=KnobPlan, echo=echo, bare=bare,
        extract_support=extract_support, LdfiConfig=LdfiConfig, fuzz=fuzz)


def _raised(fn):
    try:
        return ("ok", fn())
    except Exception as e:  # noqa: BLE001 - the refusal is the output
        return ("raised", type(e).__name__, str(e))


def _sup(msg=(), timer=(), truncated=False):
    return dict(msg_edges=list(msg), timer_edges=list(timer),
                depth=len(msg) + len(timer), witness_step=0,
                truncated=truncated, root_external=not truncated)


def _pool_state(pool):
    return dict(rows=sorted(sorted(r) for r in pool.rows),
                times=dict(sorted(pool.times.items())),
                seed_of=dict(sorted(pool.seed_of.items())),
                truncated=pool.truncated, len=len(pool))


# -- the synthetic cases (tests/test_ldfi.py), one function of a package --
CHAIN = [jt._msg(0, -1, 0, 1, 10), jt._msg(1, 0, 1, 0, 20),
         jt._msg(2, 1, 0, 1, 30), jt._msg(3, 2, 1, 0, 40)]
DIAMOND = [jt._msg(0, -1, 0, 1, 10), jt._msg(1, 0, 1, 2, 20),
           jt._msg(2, 0, 1, 3, 25), jt._msg(3, 2, 3, 0, 40)]
WRAPPED = [jt._msg(5, 2, 0, 1, 50), jt._msg(6, 5, 1, 0, 60),
           jt._msg(7, 6, 0, 1, 70)]
FILTERED = [jt._msg(0, -1, 0, 1, 10, tag=7), jt._timer(1, 0, 1, 30, tag=9),
            jt._msg(2, 1, 1, 2, 40, tag=7), jt._msg(3, 2, 2, 1, 50, tag=8)]


def case_walk(M):
    return [M.walk_lineage(jt._recs(CHAIN)),
            M.walk_lineage(jt._recs(DIAMOND), from_step=3),
            M.walk_lineage(jt._recs(WRAPPED), from_step=7),
            _raised(lambda: M.walk_lineage(jt._recs(CHAIN[:1]),
                                           from_step=99)),
            _raised(lambda: M.walk_lineage(jt._recs([])))]


def case_support(M):
    w = M.success_witness(kinds=(M.T.EV_MSG,), tags=(7,), node=2)
    return [M.support_from_records(jt._recs(CHAIN[:2])),
            M.support_from_records(jt._recs(FILTERED), w),
            M.support_from_records(jt._recs(FILTERED),
                                   M.success_witness(tags=(9,))),
            M.support_from_records(jt._recs(FILTERED),
                                   M.success_witness(node=3)),
            M.support_from_records(
                jt._recs(CHAIN[:1]),
                M.success_witness(kinds=(M.T.EV_SUPER,))),
            M.support_from_records(jt._recs([])),
            M.support_from_records(jt._recs(WRAPPED[:2]))]


def case_pool(M):
    pool = M.SupportPool()
    out = [pool.add(_sup(msg=[(-1, 2, 10)])), len(pool)]
    a, b, c, d = (0, 1, 5), (1, 2, 6), (2, 0, 7), (0, 2, 8)
    out += [pool.add(_sup(msg=[a, b]), seed=3), pool.add(_sup(msg=[a, c])),
            pool.add(_sup(msg=[d]), seed=5),
            pool.add(_sup(timer=[(2, 7)], truncated=True), seed=9)]
    out += [pool.ranked(8), pool.ranked(2), pool.ranked(0),
            _pool_state(pool)]
    p1, p2 = M.SupportPool(), M.SupportPool()
    p1.add(_sup(msg=[(0, 1, 5)]), seed=1)
    p2.add(_sup(msg=[(0, 1, 9)], truncated=True), seed=2)
    p2.add(_sup(timer=[(2, 7)]))
    p2.add(_sup(msg=[(0, 1, 5)]), seed=4)
    p1.merge(p2)
    out += [_pool_state(p1), p1.ranked(16)]
    return out


def _two_support_pool(M):
    pool = M.SupportPool()
    pool.add(dict(msg_edges=[(1, 0, 5000), (0, 1, 9000)],
                  timer_edges=[(2, 4000)], depth=3, witness_step=9,
                  truncated=False, root_external=True), seed=11)
    pool.add(dict(msg_edges=[(1, 0, 7000)], timer_edges=[], depth=1,
                  witness_step=5, truncated=False, root_external=True))
    return pool


def _one_edge_pool(M, seed=None):
    pool = M.SupportPool()
    pool.add(dict(msg_edges=[(1, 0, 5000)], timer_edges=[], depth=1,
                  witness_step=3, truncated=False, root_external=True),
             seed=seed)
    return pool


def case_synthesize(M):
    plan = M.KnobPlan.from_runtime(M.echo(), dup_slots=2)
    out = [M.synthesize(plan, _two_support_pool(M), 6),
           M.synthesize(plan, _two_support_pool(M), 4, max_cuts=1),
           M.synthesize(plan, _two_support_pool(M), 5, max_cuts=3,
                        lead=250, rank_cap=2, with_seeds=True),
           M.synthesize(plan, _one_edge_pool(M), 1, max_cuts=1, lead=1000),
           M.synthesize(plan, _one_edge_pool(M, seed=42), 2, max_cuts=1,
                        with_seeds=True),
           M.synthesize(plan, _one_edge_pool(M), 1, max_cuts=1,
                        with_seeds=True),
           M.synthesize(plan, M.SupportPool(), 4),
           M.synthesize(plan, _two_support_pool(M), 0),
           M.synthesize(M.KnobPlan.from_runtime(M.bare(), dup_slots=2),
                        _two_support_pool(M), 4)]
    return out


def case_ldfi_needs_the_recorder(M):
    return _raised(lambda: M.fuzz(M.echo(trace_cap=0), max_steps=500,
                                  batch=8, max_rounds=1, dry_rounds=2,
                                  chunk=32, ldfi=M.LdfiConfig()))


CASES = {f.__name__[5:]: f for f in (case_walk, case_support, case_pool,
                                      case_synthesize,
                                      case_ldfi_needs_the_recorder)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_synthetic_case_equals_the_reference(case):
    with reference_stream():
        ref = CASES[case](_jax())
    equal_results(ref, CASES[case](_port()), case)


def test_synthesized_vectors_are_legal_mutants_with_their_heal():
    """The reference's bounds and heal-drag checks, on the port's
    vectors."""
    M = _port()
    T = M.T
    plan = M.KnobPlan.from_runtime(M.echo(), dup_slots=2)
    base = plan.base_knobs()
    vecs = M.synthesize(plan, _two_support_pool(M), 6)
    assert vecs
    for kn in vecs:
        changed = [r for r in range(plan.R)
                   if any(kn[f][r] != base[f][r]
                          for f in ("row_time", "row_node", "row_val",
                                    "row_flag", "row_on"))]
        assert changed
        for r in changed:
            node = int(kn["row_node"][r])
            assert plan.time_ok[r] and bool(kn["row_on"][r])
            assert node == T.NODE_RANDOM or (
                0 <= node < plan.N and plan.pool_ok[r, node + 1])
            assert plan.val_lo[r] <= int(kn["row_val"][r]) <= plan.val_hi[r]
    (vec,) = M.synthesize(plan, _one_edge_pool(M), 1, max_cuts=1,
                          lead=1000)
    ops, times = plan.base["op"], plan.base["time"]
    (heal,) = [r for r in range(plan.R) if ops[r] == T.OP_HEAL]
    (cut,) = [r for r in range(plan.R) if ops[r] == T.OP_PARTITION_ONEWAY
              and vec["row_time"][r] == 4000]
    assert int(vec["row_flag"][cut]) == 0
    assert int(vec["row_time"][heal]) == 4000 + int(times[heal]) \
        - int(times[cut])


# -- live lanes -------------------------------------------------------------
def _live_supports(M, trace_cap, chunk):
    """extract_support on every lane of SEEDS run to the halt, with
    replay=True (the wrapped ring's lanes replay from t=0)."""
    rt = M.echo(trace_cap=trace_cap)
    state = rt.run_fused(rt.init_batch(SEEDS), LIVE_STEPS, chunk)
    witness = M.success_witness(kinds=(M.T.EV_MSG,))
    return [[M.extract_support(state, lane, replay=True, rt=rt,
                               seed=int(SEEDS[lane]),
                               max_steps=LIVE_STEPS, chunk=chunk),
             M.extract_support(state, lane, witness=witness)]
            for lane in range(len(SEEDS))]


LIVE_CASES = {"ring64": 64, "ring4_wraps": 4}


def _live_reference(case):
    with reference_stream():
        return {"supports": json_part(
            _live_supports(_jax(), LIVE_CASES[case], 256))}


@pytest.mark.parametrize("case", sorted(LIVE_CASES))
def test_extract_support_on_live_lanes(case):
    ref = part_json(golden(MODULE, case)["supports"])
    got = part_json(json_part(_live_supports(_port(), LIVE_CASES[case],
                                             32)))
    assert got == ref
    sups = [s for pair in got for s in pair]
    assert all(s is not None for s in sups)
    if LIVE_CASES[case] == 4:
        # the wrapped ring's supports came from full replays
        assert all(pair[0]["replayed"] and not pair[0]["truncated"]
                   for pair in got)
        assert all(pair[1]["truncated"] for pair in got)


# the recording against the JAX package (tests/_torch_golden.py)
REFERENCES = {case: (lambda c=case: _live_reference(c))
              for case in LIVE_CASES}


@pytest.mark.slow
@pytest.mark.parametrize("case", sorted(REFERENCES))
def test_golden_is_the_jax_packages_output(case):
    assert_golden_is_reference(MODULE, case, REFERENCES[case]())
