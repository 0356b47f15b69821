"""The port's schedule search against the JAX package (tolerance: zero), on
the CPU.

Covers the knob plans (`KnobPlan.from_runtime`, `to_scenario`), the havoc
mutator (`ops/mutate.py` against `_mutate_batch` / `_mutate_batch_masked`),
the knob write (`ops/apply_knobs.py` against `_apply_batch`, leaf for leaf
over the whole state), the coverage digest (`ops/coverage.py` against
`_coverage_digest`), and a fixed-seed campaign through the entry points
`fuzz`, `explore` and `pct_sweep` on bench.py's saturating runtime. The
JAX side runs on the non-partitionable threefry stream (see
_torch_parity); inputs are made from seeds with numpy.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_same, jax_leaves, reference_stream
from madsim_tpu_torch import interop, workloads

B = 64
T_INF = 2 ** 31 - 1
PLAN_FIELDS = ("n_init", "R", "D", "N", "payload_words", "jitter_gate",
               "time_ok", "node_ok", "drop_ok", "pool_ok", "val_ok",
               "val_lo", "val_hi", "dir_ok", "torn_ok", "net0")


def _jax_all_knobs_runtime():
    """The JAX twin of `workloads.all_knobs_runtime`: every knob kind."""
    import madsim_tpu as M
    from madsim_tpu.models.pingpong import PingPong, state_spec
    ms = M.ms
    sc = M.Scenario()
    sc.at(ms(5)).set_skew(1, 300)
    sc.at(ms(8)).set_disk(2, ms(2), torn=True)
    sc.at(ms(10)).set_disk(3, ms(1))
    sc.at(ms(12)).partition_oneway([0, 2], direction=1)
    sc.at(ms(15)).set_dup(1, 0.3)
    sc.at(ms(20)).kill_random(among=[0, 1])
    sc.at(ms(40)).restart_random(among=[0, 1])
    sc.at(ms(60)).heal()
    cfg = M.SimConfig(n_nodes=4, time_limit=M.sec(2),
                      net=M.NetConfig(send_latency_min=ms(1),
                                      send_latency_max=ms(1),
                                      op_jitter_max=40))
    return M.Runtime(cfg, [PingPong(4, target=6)], state_spec(), scenario=sc)


def _jax_runtime(name):
    import bench
    return dict(flagship=bench._make_runtime,
                saturating=bench._make_saturating_runtime,
                faults=_jax_all_knobs_runtime)[name]()


def _port_runtime(name):
    return dict(flagship=lambda: workloads.flagship_runtime(device="cpu"),
                saturating=lambda: workloads.saturating_runtime(
                    device="cpu"),
                faults=lambda: workloads.all_knobs_runtime(
                    device="cpu"))[name]()


_PLANS: dict = {}


def _plans(name):
    """(JAX runtime, JAX plan, port runtime, port plan), built once."""
    if name not in _PLANS:
        from madsim_tpu.search.mutate import KnobPlan as JPlan
        from madsim_tpu_torch.search.mutate import KnobPlan as TPlan
        jrt, trt = _jax_runtime(name), _port_runtime(name)
        _PLANS[name] = (jrt, JPlan.from_runtime(jrt, dup_slots=2),
                        trt, TPlan.from_runtime(trt, dup_slots=2))
    return _PLANS[name]


def _knob_batch(name, seed):
    """B knob vectors of runtime `name`: base lanes, lanes stacked through
    six havoc steps, and foreign lanes at the wrap boundaries (row times
    and dup times next to T_INF, latency and jitter at their caps,
    out-of-range values and flags, extreme nudges); losses on the float32
    grid the mutator's one-rounding rule needs (ops/mutate.py)."""
    from madsim_tpu_torch.ops.mutate import mutate_batch_plain
    _, jplan, _, tplan = _plans(name)
    rng = np.random.default_rng(seed)
    kb = jplan.base_batch(B)
    guards, _ = tplan._device_tables("cpu")
    mut = interop.knobs_to_numpy(mutate_batch_plain(
        interop.knobs_to_torch(kb, "cpu"),
        torch.tensor([0, seed], dtype=torch.int32), guards, 6)[0])
    for k in kb:
        kb[k][B // 4:B // 2] = mut[k][B // 4:B // 2]
    edge = slice(B // 2, B)
    n = B - B // 2
    R, D = jplan.R, jplan.D
    kb["row_time"][edge] = rng.choice(
        [-5, 0, 1, T_INF - 2, T_INF - 1, T_INF - 100], (n, R))
    kb["row_val"][edge] = rng.integers(-2 ** 31, 2 ** 31 - 1, (n, R))
    kb["row_flag"][edge] = rng.integers(-3, 4, (n, R))
    kb["row_on"][edge] = rng.random((n, R)) < 0.7
    kb["dup_src"][edge] = rng.integers(-2, R + 2, (n, D))
    kb["dup_time"][edge] = rng.choice([-3, 0, T_INF - 1, T_INF - 7], (n, D))
    kb["dup_on"][edge] = rng.random((n, D)) < 0.5
    kb["lat_lo"][edge] = rng.choice([0, 4_999, 30_000_000], n)
    kb["lat_hi"][edge] = rng.choice([0, 19_999, 30_000_000], n)
    kb["jitter"][edge] = rng.choice([0, 1_000_000, 4_999], n)
    kb["prio_nudge"][edge] = rng.choice([0, 2 ** 31 - 1, -(2 ** 31)], n)
    kb["loss"][edge] = rng.choice(np.float32([0.0, 0.05, 0.3, 0.9, 0.95,
                                              0.99, 2.0 ** -20]), n)
    return kb


def _equal(a, b, where=""):
    """Deep equality of results: dicts, lists, numpy arrays, scalars."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and sorted(a) == sorted(b), where
        for k in a:
            _equal(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _equal(x, y, f"{where}[{i}]")
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, where
        np.testing.assert_array_equal(a, b, err_msg=where)
    else:
        assert type(a) is type(b) and a == b, (where, a, b)


# --------------------------------------------------------------------------
# Knob plans
# --------------------------------------------------------------------------
@pytest.mark.parametrize("name", ["flagship", "saturating", "faults"])
def test_knob_plan_and_scenario_rendering_match(name):
    _, jplan, _, tplan = _plans(name)
    for f in PLAN_FIELDS:
        _equal(getattr(jplan, f), getattr(tplan, f), f)
    _equal(jplan.base, tplan.base, "base")
    _equal(jplan.base_knobs(), tplan.base_knobs(), "base_knobs")
    kb = _knob_batch(name, 5)
    for i in range(0, B, 5):
        kn = {k: v[i] for k, v in kb.items()}
        assert jplan.to_scenario(kn).describe() == \
            tplan.to_scenario(kn).describe(), i
    if name == "faults":      # every knob kind is present
        assert jplan.val_ok.any() and jplan.dir_ok.any()
        assert jplan.torn_ok.any() and jplan.D == 2
        assert not jplan.pool_ok[:, 1:].all()


# --------------------------------------------------------------------------
# The havoc mutator
# --------------------------------------------------------------------------
def test_randint_wrap_boundaries_match():
    """The two draws of the mutator whose span nears 2^32: the full-range
    nudge and `1 << mag` (every mag, including the int32 wrap at 31)."""
    from madsim_tpu_torch.core import prng
    keys = np.random.default_rng(1).integers(0, 2 ** 32, (256, 2),
                                             dtype=np.uint32)
    mags = np.arange(256, dtype=np.int32) % 32
    maxv = np.left_shift(np.int32(1), mags)
    with reference_stream():
        full = np.asarray(jax.vmap(lambda k: jax.random.randint(
            k, (), -(2 ** 31) + 1, 2 ** 31 - 1, dtype=jnp.int32))(keys))
        bounded = np.asarray(jax.vmap(lambda k, m: jax.random.randint(
            k, (), 0, m, dtype=jnp.int32))(keys, maxv))
    tk = torch.as_tensor(keys.view(np.int32))
    np.testing.assert_array_equal(
        prng.randint_raw(tk, -(2 ** 31) + 1, 2 ** 31 - 1).numpy(), full)
    np.testing.assert_array_equal(
        prng.randint_raw(tk, 0, torch.as_tensor(maxv)).numpy(), bounded)


@pytest.mark.parametrize("name,havoc,masked", [
    ("flagship", 3, True), ("faults", 0, False), ("faults", 3, False),
    ("faults", 6, True)])
def test_mutate_matches_reference(name, havoc, masked):
    from madsim_tpu.search.mutate import _mutate_batch, _mutate_batch_masked
    from madsim_tpu_torch.ops.mutate import mutate_batch_plain
    _, jplan, _, tplan = _plans(name)
    kb = _knob_batch(name, havoc + 11)
    mask = np.random.default_rng(havoc).random(B) < 0.6
    guards_t = {k: torch.as_tensor(np.array(v))
                for k, v in jplan._guards().items()}
    kb_t = interop.knobs_to_torch(kb, "cpu")
    for seed in (0, 7, 2 ** 32 - 1):
        key = np.asarray(jax.random.PRNGKey(np.uint32(seed)))
        with reference_stream():
            kj = {k: jnp.asarray(v) for k, v in kb.items()}
            if masked:
                ref = _mutate_batch_masked(kj, key, jplan._guards(), havoc,
                                           jnp.asarray(mask))
            else:
                ref = _mutate_batch(kj, key, jplan._guards(), havoc)
            ref = ({k: np.asarray(v) for k, v in ref[0].items()},
                   np.asarray(ref[1]), np.asarray(ref[2]))
        key_t = torch.as_tensor(np.array(key).view(np.int32))
        got = mutate_batch_plain(kb_t, key_t, guards_t, havoc,
                                 torch.as_tensor(mask) if masked else None)
        _equal(ref[0], interop.knobs_to_numpy(got[0]), "knobs")
        _equal(ref[1], got[1].numpy(), "hist")
        _equal(ref[2], got[2].numpy(), "last_op")
        # the entry point: KnobPlan.mutate / mutate_masked
        via = (tplan.mutate_masked(kb, key, mask, havoc=havoc) if masked
               else tplan.mutate(kb, key, havoc=havoc))
        _equal(ref[0], interop.knobs_to_numpy(via[0]), "plan knobs")
        _equal(ref[1], via[1].numpy(), "plan hist")
        _equal(ref[2], via[2].numpy(), "plan last_op")
        if havoc:
            assert ref[1].sum() > 0
    if name == "faults" and havoc == 6:
        assert (ref[1] > 0).all()          # all eight operators landed


# --------------------------------------------------------------------------
# The knob write
# --------------------------------------------------------------------------
@pytest.mark.parametrize("name", ["flagship", "faults"])
def test_apply_knobs_matches_reference_leaf_for_leaf(name):
    from madsim_tpu.search.mutate import _apply_batch
    jrt, jplan, trt, tplan = _plans(name)
    kb = _knob_batch(name, 3)
    rng = np.random.default_rng(4)
    # foreign lanes: targets outside every pool and outside [-1, N-1],
    # times and values outside their bounds, losses outside [0, 0.99]
    f = slice(0, B // 8)
    n = B // 8
    kb["row_node"][f] = rng.integers(-5, jplan.N + 4, (n, jplan.R))
    kb["row_time"][f] = rng.integers(-10 ** 6, 2 ** 31 - 1, (n, jplan.R))
    kb["loss"][f] = rng.choice(np.float32([-0.5, 1.5, 0.995]), n)
    kb["lat_lo"][f] = rng.integers(-10 ** 5, 4 * 10 ** 7, n)
    kb["lat_hi"][f] = rng.integers(-10 ** 5, 4 * 10 ** 7, n)
    kb["jitter"][f] = rng.integers(-10, 2 * 10 ** 6, n)
    seeds = np.arange(B, dtype=np.uint32)
    with reference_stream():
        s = _apply_batch(jrt.init_batch(seeds),
                         {k: jnp.asarray(v) for k, v in kb.items()},
                         {k: jnp.asarray(v) for k, v in jplan.base.items()},
                         jplan._guards(), jplan.n_init, jplan.jitter_gate)
        ref = jax_leaves(s)
    got = interop.state_to_numpy(tplan.apply(trt.init_batch(seeds), kb))
    assert set(ref) == set(got)
    assert_same(ref, got, what=f"apply_knobs on {name}")


def test_apply_repro_knobs_replays_one_vector_on_every_lane():
    from madsim_tpu.search.mutate import apply_repro_knobs as japply
    from madsim_tpu_torch.search.mutate import apply_repro_knobs as tapply
    jrt, jplan, trt, _ = _plans("faults")
    kn = {k: v[B // 4 + 1] for k, v in _knob_batch("faults", 8).items()}
    seeds = np.arange(6, dtype=np.uint32)
    with reference_stream():
        ref = jax_leaves(japply(jrt, jrt.init_batch(seeds), kn)[0])
    got, plan = tapply(trt, trt.init_batch(seeds), kn)
    assert plan.D == 2
    assert_same(ref, interop.state_to_numpy(got), what="apply_repro_knobs")


# --------------------------------------------------------------------------
# The coverage digest
# --------------------------------------------------------------------------
def _hash_sets():
    rng = np.random.default_rng(9)
    top = np.uint32(1 << 31)
    dup = rng.integers(0, 2 ** 32, (40, 2), dtype=np.uint32)
    dup = dup[rng.integers(0, 40, 300)]                 # many repeats
    dup[::7, 0] |= top
    return {
        "repeats_top_bit": dup,
        "all_equal": np.full((128, 2), [top | 5, top | 9], np.uint32),
        "all_distinct": np.stack([
            np.arange(2000, dtype=np.uint64) * 2654435761 % 2 ** 32,
            np.arange(2000, dtype=np.uint64) % 2 << 31], 1).astype(
                np.uint32),
        "low_word_only": np.stack([np.zeros(64, np.uint32),
                                   rng.permutation(64).astype(np.uint32)
                                   | top], 1),
        "one": np.array([[top, 1]], np.uint32),
        "extremes": np.array([[0, 0], [2 ** 32 - 1, 2 ** 32 - 1],
                              [top, 0], [top - 1, 2 ** 32 - 1], [0, top],
                              [2 ** 32 - 1, 0], [0, 0]], np.uint32)}


@pytest.mark.parametrize("case", sorted(_hash_sets()))
def test_coverage_digest_matches_reference(case):
    from madsim_tpu.parallel.stats import _coverage_digest
    from madsim_tpu_torch.ops.coverage import coverage_digest, \
        coverage_digest_plain
    h = _hash_sets()[case]
    with reference_stream():
        pairs, n = _coverage_digest(jnp.asarray(h))
        pairs, n = np.asarray(pairs), int(n)
    t = torch.as_tensor(h.view(np.int32))
    for fn in (coverage_digest_plain, coverage_digest):
        got_pairs, got_n = fn(t)
        assert got_n.dtype == torch.int32 and got_n.ndim == 0
        assert int(got_n) == n == len(np.unique(h, axis=0))
        np.testing.assert_array_equal(got_pairs.numpy().view(np.uint32),
                                      pairs)


# --------------------------------------------------------------------------
# The campaign: fuzz, explore and pct_sweep on the saturating runtime
# --------------------------------------------------------------------------
CAMPAIGN = dict(max_steps=600, batch=32, max_rounds=4, chunk=32,
                rng_seed=3)


@pytest.fixture(scope="module")
def campaign():
    import bench
    from madsim_tpu.parallel.explore import explore as jexplore
    from madsim_tpu.search import Corpus as JCorpus
    from madsim_tpu.search import KnobPlan as JPlan
    from madsim_tpu.search import fuzz as jfuzz
    from madsim_tpu.search import pct_sweep as jpct
    from madsim_tpu_torch.parallel.explore import explore as texplore
    from madsim_tpu_torch.search import Corpus as TCorpus
    from madsim_tpu_torch.search import KnobPlan as TPlan
    from madsim_tpu_torch.search import fuzz as tfuzz
    from madsim_tpu_torch.search import pct_sweep as tpct
    explore_kw = {k: CAMPAIGN[k] for k in ("max_steps", "batch",
                                           "max_rounds", "chunk")}
    nudges = np.array([0, 1, -1, 77, 2 ** 31 - 1, -(2 ** 31), 5, 0],
                      np.int32)
    out = {}
    with reference_stream():
        jrt = bench._make_saturating_runtime()
        jc = JCorpus(JPlan.from_runtime(jrt),
                     rng=np.random.default_rng(CAMPAIGN["rng_seed"]))
        out["jax"] = dict(fuzz=jfuzz(jrt, corpus=jc, **CAMPAIGN),
                          corpus=jc.entries,
                          explore=jexplore(jrt, **explore_kw))
        kn = jc.entries[-1]["knobs"]
        out["jax"]["pct"] = jpct(jrt, 4, nudges, 600, chunk=32)
        out["jax"]["pct_knobs"] = jpct(jrt, 4, nudges, 600, chunk=32,
                                       knobs=kn)
    trt = workloads.saturating_runtime(device="cpu")
    tc = TCorpus(TPlan.from_runtime(trt),
                 rng=np.random.default_rng(CAMPAIGN["rng_seed"]))
    out["port"] = dict(fuzz=tfuzz(trt, corpus=tc, **CAMPAIGN),
                       corpus=tc.entries,
                       explore=texplore(trt, **explore_kw),
                       pct=tpct(trt, 4, nudges, 600, chunk=32),
                       pct_knobs=tpct(trt, 4, nudges, 600, chunk=32,
                                      knobs=kn))
    return out


def test_fuzz_campaign_matches_reference(campaign):
    ref, got = campaign["jax"]["fuzz"], campaign["port"]["fuzz"]
    _equal(ref, got, "fuzz")
    assert got["rounds"] == CAMPAIGN["max_rounds"]
    assert sum(got["mutation_ops"].values()) > 0
    assert sum(got["mutation_yield"].values()) == got["corpus_size"]


def test_fuzz_corpus_admits_the_same_entries(campaign):
    ref, got = campaign["jax"]["corpus"], campaign["port"]["corpus"]
    assert len(ref) == len(got) > 0
    _equal(ref, got, "corpus")


def test_explore_matches_reference_and_fuzz_beats_it(campaign):
    _equal(campaign["jax"]["explore"], campaign["port"]["explore"],
           "explore")
    assert campaign["port"]["fuzz"]["distinct_schedules"] \
        > campaign["port"]["explore"]["distinct_schedules"]


@pytest.mark.parametrize("which", ["pct", "pct_knobs"])
def test_pct_sweep_matches_reference(campaign, which):
    ref, got = campaign["jax"][which], campaign["port"][which]
    _equal(ref, got, which)
    assert got["distinct_schedules"] >= 2


def test_observer_sees_every_round():
    from madsim_tpu_torch.parallel.explore import explore
    from madsim_tpu_torch.search import fuzz

    class Rec:
        def __init__(self):
            self.rounds, self.done = [], None

        def on_round(self, rec):
            self.rounds.append(rec)

        def on_done(self, rec):
            self.done = rec

    kw = dict(max_steps=200, batch=8, max_rounds=2, chunk=32)
    for run, kind in ((fuzz, "fuzz_round"), (explore, "round")):
        obs = Rec()
        res = run(workloads.saturating_runtime(device="cpu"),
                  observer=obs, **kw)
        assert [r["kind"] for r in obs.rounds] == [kind] * res["rounds"]
        assert obs.done["distinct_total"] == res["distinct_schedules"]


# --------------------------------------------------------------------------
# The port's boundary
# --------------------------------------------------------------------------
@pytest.mark.parametrize("kw,item", [
    (dict(ldfi=True), "P13"), (dict(corpus_dir=True), "P14")])
def test_unported_fuzz_branches_are_refused(kw, item, tmp_path):
    """Both branches were refused until they were ported (ROADMAP P13,
    P14); each now runs as the JAX package's does: `ldfi=` on a runtime
    without the flight recorder raises the reference's ValueError, and
    `corpus_dir=` runs a durable campaign (tests/test_torch_campaign.py
    and tests/test_torch_ldfi.py hold both to the reference)."""
    from madsim_tpu_torch.search import LdfiConfig, fuzz
    rt = workloads.saturating_runtime(device="cpu")
    if item == "P13":
        with pytest.raises(ValueError, match="flight recorder"):
            fuzz(rt, max_steps=10, batch=2, max_rounds=1,
                 ldfi=LdfiConfig())
    else:
        res = fuzz(rt, max_steps=10, batch=2, max_rounds=1, chunk=16,
                   corpus_dir=str(tmp_path / "store"))
        assert res["rounds_done_total"] == 1
        assert res["corpus_dir"] == str(tmp_path / "store")


def test_a_knob_plan_runs_on_cuda_unless_a_device_is_named(monkeypatch):
    """A plan built without a device (a stored plan, say) resolves it as a
    Runtime does: CUDA, or an error where there is none; never the CPU."""
    import dataclasses
    from madsim_tpu_torch.search.mutate import KnobPlan
    _, _, trt, tplan = _plans("faults")
    assert tplan.device == torch.device("cpu") == trt.device
    fields = {f.name: getattr(tplan, f.name)
              for f in dataclasses.fields(KnobPlan) if f.name != "device"}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        KnobPlan(**fields)
    assert KnobPlan(**fields, device="cpu").device == torch.device("cpu")


def test_kernel_wrappers_take_the_plain_versions_on_the_cpu():
    from madsim_tpu_torch.ops.apply_knobs import apply_knobs
    from madsim_tpu_torch.ops.coverage import coverage_digest
    from madsim_tpu_torch.ops.mutate import mutate_batch, mutate_batch_plain
    _, _, trt, tplan = _plans("faults")
    kb = interop.knobs_to_torch(_knob_batch("faults", 2), "cpu")
    guards, base = tplan._device_tables("cpu")
    key = torch.tensor([1, 2], dtype=torch.int32)
    before = [w.launches for w in (mutate_batch, apply_knobs,
                                   coverage_digest)]
    _equal(interop.knobs_to_numpy(mutate_batch(kb, key, guards, 2)[0]),
           interop.knobs_to_numpy(mutate_batch_plain(kb, key, guards,
                                                     2)[0]))
    s = tplan.apply(trt.init_batch(np.arange(B)), kb)
    coverage_digest(s.sched_hash)
    assert [w.launches for w in (mutate_batch, apply_knobs,
                                 coverage_digest)] == before
    with pytest.raises(ValueError, match="havoc"):
        mutate_batch(kb, key, guards, -1)
    with pytest.raises(TypeError, match="dtype"):
        mutate_batch(dict(kb, loss=kb["loss"].double()), key, guards, 1)


# --------------------------------------------------------------------------
# The havoc kernel's launch logic, with a stand-in launcher on host memory
# --------------------------------------------------------------------------
def _up16(x):
    return (x + 15) // 16 * 16


def _tile_bytes(T, R, D, N):
    """csrc/mutate.cu `tile_layout`, region by region: the four guard
    lists, val_lo, val_hi, flags, pool, the draws (48 bytes a lane and
    drawing thread, four threads a lane), the randint and word draw lists
    (3 and 2 uint16 a lane and thread), the lane keys (two words a lane),
    then the tile's four int32 row arrays, row_on, the two int32 dup
    arrays and dup_on."""
    items = 4 * T
    guards = [16 * R, 4 * R, 4 * R, R, R * (N + 1)]
    draws = [48 * items, 2 * 3 * items, 2 * 2 * items, 8 * T]
    rows = [4 * T * R] * 4 + [T * R, 4 * T * D, 4 * T * D, T * D]
    return sum(_up16(x) for x in guards + draws + rows)


def _host(ptr, count, dtype):
    import ctypes
    size = np.dtype(dtype).itemsize
    return np.frombuffer((ctypes.c_char * (count * size)).from_address(ptr),
                         dtype=dtype, count=count)


def _mutate_standin(ref, stream, tiles):
    """csrc/mutate.cu on host memory, read from the parameter block as the
    kernel reads it: refuses (cudaErrorInvalidValue) what the launcher
    refuses, then takes one tile of `tile` lanes a block, the last one
    ragged, each through the plain version with the lanes' own keys of
    split(key, B); records (first lane, lanes, vec) a block in `tiles`."""
    from madsim_tpu_torch.core import prng
    from madsim_tpu_torch.ops import mutate as mu
    p = ref._obj
    B, R, D, N, T = p.B, p.R, p.D, p.N, p.tile
    if not (R >= 1 and D >= 0 and N >= 1 and p.havoc >= 0
            and 32 <= T <= 128 and T % 32 == 0
            and p.smem == _tile_bytes(T, R, D, N) <= mu.SMEM_MAX):
        return 1
    tiled = [n for n in mu.KNOB_KEYS if n.startswith(("row_", "dup_"))]
    if p.vec and any(getattr(p, side + n) % 16
                     for n in tiled for side in ("in_", "out_")):
        return 1
    shapes = mu.knob_shapes(B, R, D)
    np_dt = {torch.int32: np.int32, torch.bool: np.bool_,
             torch.float32: np.float32}

    def knob(side, n):
        dt, shape = shapes[n]
        return _host(getattr(p, side + n), int(np.prod(shape)),
                     np_dt[dt]).reshape(shape)

    guards = {n: torch.as_tensor(_host(getattr(p, n), int(np.prod(sh)),
                                       np_dt[dt]).reshape(sh).copy())
              for n, (dt, sh) in mu.guard_shapes(R, N).items()}
    key = torch.as_tensor(_host(p.key, 2, np.int32).copy())
    lane_keys = prng.split(key, B)
    mask = _host(p.mask, B, np.bool_) if p.mask else None
    hist = _host(p.hist, 8, np.int32)
    last_op = _host(p.last_op, B, np.int32)
    for b0 in range(0, B, T):
        lanes = slice(b0, min(b0 + T, B))
        tiles.append((b0, lanes.stop - b0, p.vec))
        kn = {n: torch.as_tensor(knob("in_", n)[lanes].copy())
              for n in mu.KNOB_KEYS}
        out, h, last = mu.mutate_lanes(
            kn, lane_keys[lanes], guards, p.havoc,
            None if mask is None else torch.as_tensor(mask[lanes].copy()))
        for n in mu.KNOB_KEYS:
            knob("out_", n)[lanes] = out[n].numpy()
        hist += h.numpy()
        last_op[lanes] = last.numpy()
    return 0


def test_mutate_tile_and_shared_memory_by_plan():
    """The tile the launcher takes from R, D and N: 64 lanes for the
    flagship's plan (R=33, D=2, N=5), 128 for all_knobs' (R=9, D=2, N=4);
    32 lanes past the 56 KB target while they fit the card; refused where
    no 32-lane tile fits."""
    from madsim_tpu_torch.ops.mutate import SMEM_MAX, mutate_tile
    for name, want in (("flagship", 64), ("faults", 128)):
        tplan = _plans(name)[3]
        R, D, N = tplan.R, tplan.D, tplan.N
        assert mutate_tile(R, D, N) == (want, _tile_bytes(want, R, D, N))
    assert _tile_bytes(64, 33, 2, 5) == 53488
    assert mutate_tile(300, 2, 5) == (32, _tile_bytes(32, 300, 2, 5))
    assert 56 * 1024 < _tile_bytes(32, 300, 2, 5) <= SMEM_MAX
    with pytest.raises(NotImplementedError, match="shared memory"):
        mutate_tile(600, 2, 5)


@pytest.mark.parametrize("name,B,havoc,masked,offset", [
    ("flagship", 101, 3, False, False), ("flagship", 101, 3, True, False),
    ("flagship", 1, 6, False, False), ("faults", 300, 6, True, False),
    ("faults", 130, 0, False, False), ("flagship", 70, 3, False, True)])
def test_mutate_launch_tiles_every_lane_once(monkeypatch, name, B, havoc,
                                             masked, offset):
    """The kernel's path on the CPU with a stand-in launcher: ceil(B / T)
    tiles, the last one ragged, cover every lane once, and the result is
    `mutate_batch_plain`'s; 16-byte copies only where every knob array is
    16-byte aligned (a row_time one element into its allocation turns
    them off). One launch."""
    import chip_smoke
    from madsim_tpu_torch.ops.mutate import (mutate_batch,
                                             mutate_batch_plain, mutate_tile)
    tplan = _plans(name)[3]
    kb = interop.knobs_to_torch(_knob_batch(name, B), "cpu")
    kb = {n: v[np.arange(B) % v.shape[0]].contiguous()
          for n, v in kb.items()}
    if offset:
        kb["row_time"] = chip_smoke.unaligned(kb["row_time"])
    guards, _ = tplan._device_tables("cpu")
    key = torch.tensor([B, -7], dtype=torch.int32)
    mask = (torch.as_tensor(np.random.default_rng(B).random(B) < 0.5)
            if masked else None)
    tiles = []
    monkeypatch.setattr(mutate_batch, "_fn",
                        lambda ref, st: _mutate_standin(ref, st, tiles))
    before = mutate_batch.launches
    got = mutate_batch.run(kb, key, guards, havoc, mask)
    assert mutate_batch.launches == before + 1
    want = mutate_batch_plain(kb, key, guards, havoc, mask)
    _equal(interop.knobs_to_numpy(want[0]), interop.knobs_to_numpy(got[0]),
           "knobs")
    _equal(want[1].numpy(), got[1].numpy(), "hist")
    _equal(want[2].numpy(), got[2].numpy(), "last_op")
    T = mutate_tile(tplan.R, tplan.D, tplan.N)[0]
    assert [(b0, n) for b0, n, _ in tiles] == [
        (b0, min(T, B - b0)) for b0 in range(0, B, T)]
    assert {v for _, _, v in tiles} == {0 if offset else 1}


def test_knobs_cross_between_numpy_and_torch():

    kb = _knob_batch("faults", 1)
    t = interop.knobs_to_torch(kb, "cpu")
    assert t["row_on"].dtype == torch.bool and t["loss"].dtype == \
        torch.float32
    _equal(kb, interop.knobs_to_numpy(t), "round trip")
