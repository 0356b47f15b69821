"""The port's prefix-coverage sketch (`cov_sketch`), its readers,
`summarize`, and the all-planes flagship against the JAX package
(tolerance: zero), on the CPU.

Covers the sketched wal_kv (trace_cap=64, sketch_slots=4) through `run`
and `run_fused`, sketch_every retuned between two runs and at 1;
`divergence_profile`, `consensus_allreduce`, `first_divergence_slots`,
`sketch_divergence` and the `cov_divergence` counter track;
`summarize(rt, state)` and `schedule_representatives`; a `fuzz`
campaign with the divergence bonus; and
`workloads.all_planes_flagship_runtime` (every observation plane on the
flagship) at B=8 for 192 steps: every leaf, the digests and
`summarize` equal to the JAX package's, the fingerprints the plane-off
flagship's, and its checkpoint crossing both ways. The JAX side runs on
the non-partitionable threefry stream (see _torch_parity).
"""

import numpy as np
import pytest
import torch

import madsim_tpu as J
from _torch_parity import (assert_same, equal_results, jax_leaves,  # noqa
                           jax_state_like, one_cpu_thread, reference_stream)
from madsim_tpu_torch import interop, workloads
from madsim_tpu_torch.core.state import TRACE_FIELDS

pytestmark = pytest.mark.usefixtures("one_cpu_thread")

SEEDS = np.arange(6, dtype=np.uint32)
SKETCH = dict(trace_cap=64, sketch_slots=4, sketch_every=16)


def _readers(stats, obs, rt, state) -> dict:
    sk = state.cov_sketch
    sk = (sk.cpu().numpy().view(np.uint32) if isinstance(sk, torch.Tensor)
          else np.asarray(sk))
    return dict(profile=stats.divergence_profile(state),
                consensus=stats.consensus_allreduce(
                    state.cov_sketch if isinstance(state.cov_sketch,
                                                   torch.Tensor) else sk),
                slots=stats.first_divergence_slots(sk),
                pair=obs.sketch_divergence(state, 0, 3),
                same=obs.sketch_divergence(state, 2, 2),
                tracks=[e for e in obs.counter_track_events(state, 1)
                        if e["name"] == "cov_divergence"],
                summary=stats.summarize(rt, state, seeds=SEEDS),
                summary_lanes=stats.summarize(rt, state),
                reps=stats.schedule_representatives(state, SEEDS))


@pytest.fixture(scope="module")
def sketch():
    import jax.numpy as jnp
    from _grayfail_golden import build_wal_kv as jbuild
    from madsim_tpu import obs as jobs
    from madsim_tpu.parallel import stats as jstats
    from madsim_tpu_torch import obs as tobs
    from madsim_tpu_torch.parallel import stats as tstats
    out = {}
    with reference_stream():
        jrt = jbuild().derived(**SKETCH)
        s, _ = jrt.run(jrt.init_batch(SEEDS), 96, 32)
        out["ref"] = jax_leaves(s)
        out["ref_readers"] = _readers(jstats, jobs, jrt, s)
        out["ref_fused"] = jax_leaves(jrt.run_fused(jrt.init_batch(SEEDS),
                                                    96, 32))
        # sketch_every retuned between two runs (a state leaf: the same
        # compiled step), then every dispatch a checkpoint
        r, _ = jrt.run(jrt.init_batch(SEEDS), 16, 16)
        out["ref_16"] = jax_leaves(r)
        r = r.replace(sketch_every=jnp.full_like(r.sketch_every, 24))
        r, _ = jrt.run(r, 32, 32)
        out["ref_retuned"] = jax_leaves(r)
        r = jrt.init_batch(SEEDS)
        r = r.replace(sketch_every=jnp.full_like(r.sketch_every, 1))
        r, _ = jrt.run(r, 8, 8)
        out["ref_every1"] = jax_leaves(r)
    rt = workloads.build_wal_kv(device="cpu").derived(**SKETCH)
    t, _ = rt.run(rt.init_batch(SEEDS), 96, 32)
    out.update(rt=rt, state=t, port=interop.state_to_numpy(t),
               readers=_readers(tstats, tobs, rt, t))
    out["port_fused"] = interop.state_to_numpy(
        rt.run_fused(rt.init_batch(SEEDS), 96, 32))
    r, _ = rt.run(rt.init_batch(SEEDS), 16, 16)
    out["port_16"] = interop.state_to_numpy(r)
    r = r.replace(sketch_every=torch.full_like(r.sketch_every, 24))
    r, _ = rt.run(r, 32, 32)
    out["retuned"] = interop.state_to_numpy(r)
    r = rt.init_batch(SEEDS)
    r = r.replace(sketch_every=torch.full_like(r.sketch_every, 1))
    r, _ = rt.run(r, 8, 8)
    out["every1"] = interop.state_to_numpy(r)
    return out


def test_sketched_wal_kv_matches_reference_leaf_for_leaf(sketch):
    assert_same(sketch["ref"], sketch["port"], what="sketch run")
    assert_same(sketch["ref_fused"], sketch["port_fused"],
                what="sketch run_fused")
    assert (sketch["port"][".cov_sketch"] != 0).any()


def test_sketch_every_retuned_mid_run(sketch):
    """16 steps at sketch_every=16, then 32 at 24 (slot 0 rewritten at
    step 24, slot 1 written at 48); and every dispatch a checkpoint."""
    assert_same(sketch["ref_16"], sketch["port_16"], what="16 steps")
    assert_same(sketch["ref_retuned"], sketch["retuned"],
                what="sketch_every retuned")
    sk16, sk = sketch["port_16"][".cov_sketch"], sketch["retuned"][".cov_sketch"]
    assert (sk16[:, 1] == 0).all() and (sk[:, 1] != 0).all()
    assert (sk[:, 0] != sk16[:, 0]).all()
    assert_same(sketch["ref_every1"], sketch["every1"],
                what="sketch_every=1")
    assert (sketch["every1"][".cov_sketch"] != 0).all()


def test_sketch_changes_no_other_leaf_and_no_fingerprint(sketch):
    off = workloads.build_wal_kv(device="cpu").derived(trace_cap=64)
    t, _ = off.run(off.init_batch(SEEDS), 96, 32)
    plain = interop.state_to_numpy(t)
    keys = [k for k in plain if k[1:].split("[")[0] not in TRACE_FIELDS]
    assert_same(plain, sketch["port"], keys=keys, what="sketch off/on")
    np.testing.assert_array_equal(off.fingerprints(t),
                                  sketch["rt"].fingerprints(sketch["state"]))


@pytest.mark.parametrize("what", [
    "profile", "consensus", "slots", "pair", "same", "tracks", "summary",
    "summary_lanes", "reps"])
def test_sketch_readers_match_reference(sketch, what):
    equal_results(sketch["ref_readers"][what], sketch["readers"][what],
                  what)


def test_consensus_breaks_ties_toward_the_smallest_uint32():
    """A slot whose modal values tie (including values past 2^31, whose
    int32 bits are negative) takes the smallest uint32, as the JAX
    package's sort does."""
    import jax.numpy as jnp
    from madsim_tpu.parallel import stats as jstats
    from madsim_tpu_torch.parallel import stats as tstats
    rng = np.random.default_rng(3)
    sk = rng.choice(np.asarray([5, 2**31 + 7, 2**32 - 1, 9], np.uint32),
                    size=(40, 6)).astype(np.uint32)
    sk[:4, 0] = [2**31 + 7, 2**31 + 7, 5, 5]
    with reference_stream():
        want = np.asarray(jstats._consensus_modal(jnp.asarray(sk)))
    np.testing.assert_array_equal(want, tstats.consensus_allreduce(sk))
    np.testing.assert_array_equal(
        want, tstats.consensus_allreduce(torch.as_tensor(sk.view(np.int32))))


FUZZ = dict(max_steps=96, batch=8, max_rounds=3, chunk=48, div_bonus=1.0,
            rng_seed=4)


def test_fuzz_with_the_divergence_bonus_builds_the_reference_corpus():
    from _grayfail_golden import build_wal_kv as jbuild
    from madsim_tpu.search import Corpus as JCorpus
    from madsim_tpu.search import KnobPlan as JPlan
    from madsim_tpu.search import fuzz as jfuzz
    from madsim_tpu_torch.search import Corpus as TCorpus
    from madsim_tpu_torch.search import KnobPlan as TPlan
    from madsim_tpu_torch.search import fuzz as tfuzz
    kw = dict(FUZZ)
    div = kw.pop("div_bonus")
    with reference_stream():
        jrt = jbuild().derived(sketch_slots=4, sketch_every=16)
        jc = JCorpus(JPlan.from_runtime(jrt), div_bonus=div,
                     rng=np.random.default_rng(FUZZ["rng_seed"]))
        ref = jfuzz(jrt, corpus=jc, **kw)
    rt = workloads.build_wal_kv(device="cpu").derived(sketch_slots=4,
                                                      sketch_every=16)
    tc = TCorpus(TPlan.from_runtime(rt), div_bonus=div,
                 rng=np.random.default_rng(FUZZ["rng_seed"]))
    got = tfuzz(rt, corpus=tc, **kw)
    equal_results(ref, got, "fuzz")
    assert len(jc.entries) == len(tc.entries) > 0
    for a, b in zip(jc.entries, tc.entries):
        equal_results(a, b, "corpus entry")
    equal_results(jc.consensus_sketch(), tc.consensus_sketch(), "consensus")


# --------------------------------------------------------------------------
# The all-planes flagship (chip_smoke's `planes_all` phase), B=8
# --------------------------------------------------------------------------
FLAG_SEEDS = np.arange(8, dtype=np.uint32)
FLAG_STEPS = 192


def _flag_readers(stats, rt, state) -> dict:
    return dict(profile=stats.profile_counters(state),
                latency=stats.latency_counters(state),
                series=stats.series_counters(state),
                attribution=stats.attribution_counters(state),
                burst=stats.lane_burst(state),
                p99=stats.lane_e2e_p99(state),
                summary=stats.summarize(rt, state, seeds=FLAG_SEEDS))


@pytest.fixture(scope="module")
def flagship(tmp_path_factory):
    import bench
    from madsim_tpu.parallel import stats as jstats
    from madsim_tpu.runtime import checkpoint as jckpt
    from madsim_tpu_torch.parallel import stats as tstats
    from madsim_tpu_torch.runtime import checkpoint
    d = tmp_path_factory.mktemp("allplanes")
    planes = workloads.all_planes_config()
    with reference_stream():
        jrt = bench._make_runtime().derived(trace_cap=64, **planes)
        s, _ = jrt.run(jrt.init_batch(FLAG_SEEDS), FLAG_STEPS, 64)
        ref, ref_readers = jax_leaves(s), _flag_readers(jstats, jrt, s)
        jckpt.save(str(d / "jax.npz"), s)
        like = jrt.init_batch(FLAG_SEEDS)
    rt = workloads.all_planes_flagship_runtime(device="cpu")
    t, _ = rt.run(rt.init_batch(FLAG_SEEDS), FLAG_STEPS, 64)
    loaded = checkpoint.load(str(d / "jax.npz"), rt.init_batch(FLAG_SEEDS))
    checkpoint.save(str(d / "port.npz"), t)
    with reference_stream():
        back = jax_leaves(jckpt.load(str(d / "port.npz"), like))
    plain = workloads.flagship_runtime(device="cpu", trace_cap=64)
    p, _ = plain.run(plain.init_batch(FLAG_SEEDS), FLAG_STEPS, 64)
    return dict(ref=ref, ref_readers=ref_readers, rt=rt, state=t,
                port=interop.state_to_numpy(t),
                readers=_flag_readers(tstats, rt, t),
                loaded=interop.state_to_numpy(loaded), back=back,
                plain=p, plain_rt=plain)


def test_all_planes_flagship_matches_reference_leaf_for_leaf(flagship):
    assert_same(flagship["ref"], flagship["port"], what="all planes")
    port = flagship["port"]
    for leaf in (".sr_dispatch", ".sr_complete", ".sr_lat", ".ev_span",
                 ".pf_dispatch", ".lh_e2e"):
        assert port[leaf].any(), leaf
    assert (port[".cov_sketch"] != 0).any()


@pytest.mark.parametrize("what", [
    "profile", "latency", "series", "attribution", "burst", "p99",
    "summary"])
def test_all_planes_flagship_readers_match_reference(flagship, what):
    equal_results(flagship["ref_readers"][what], flagship["readers"][what],
                  what)


def test_all_planes_change_no_other_leaf_and_no_fingerprint(flagship):
    plain = interop.state_to_numpy(flagship["plain"])
    keys = [k for k in plain if k[1:].split("[")[0] not in TRACE_FIELDS]
    assert_same(plain, flagship["port"], keys=keys, what="planes off/on")
    np.testing.assert_array_equal(
        flagship["plain_rt"].fingerprints(flagship["plain"]),
        flagship["rt"].fingerprints(flagship["state"]))


def test_all_planes_checkpoints_cross_load_both_ways(flagship):
    assert_same(flagship["ref"], flagship["loaded"], what="jax -> port")
    assert_same(flagship["port"], flagship["back"], what="port -> jax")
