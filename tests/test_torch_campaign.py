"""The port's durable campaigns (`service/store.py`, `service/buckets.py`,
`service/campaign.py`, `service/worker.py`, `fuzz(corpus_dir=...)`)
against the JAX package, on the CPU (tolerance: zero).

  * the store contracts of tests/test_campaign.py (save, load and the
    next round's draws; version and signature mismatch, not a corpus
    dir, a missing dir, a kill mid-write, half-synced entries
    quarantined, evicted coverage surviving a resume), one parametrised
    test;
  * a campaign split at a round boundary equals the continuous one,
    file for file, and without `ldfi` no entry carries an origin;
  * the crash-rich wal_kv campaign (bench.py `_make_crashrich_runtime
    ("wal_kv", trace_cap=128)`, B=24, 1 round) and the durable LDFI
    echo campaign (tests/test_ldfi.py's: B=12, 3 rounds, `LdfiConfig
    (lanes=4, frac=0.25)`) equal, result and store file for file, to
    the JAX package's as tests/data/test_torch_campaign_golden.npz
    records them; both stores are compared with their wall-clock fields
    (`_torch_parity.WALL_CLOCK_FIELDS`) rewritten from the round
    counters (`freeze_clock`); the port runs chunks of 128 or 32 steps
    where the reference runs 512 or 256 (every lane halts first, and a
    halted lane is a fixed point);
  * two workers sharing buckets (worker 1 replays worker 0's seeds);
  * `store_signature` and the scenario rows equal across the packages
    for the same config (the LDFI echo, crash-rich wal_kv, grayfail mix
    and bench.py's aimed regime, `workloads.aimed_asym_runtime`);
  * the recorded JAX store opened by the port's `CorpusStore`, and the
    port's `replay_bucket` reproducing the JAX bucket's crash code,
    fingerprint and chain;
  * (`slow`) a worker process SIGKILLed after its first sync and run
    again ends with the store of an uninterrupted in-process campaign.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_campaign.py -q
"""

import json
import os
import shutil
import signal
import subprocess
import time

import numpy as np
import pytest

from _torch_parity import (assert_golden_is_reference,  # noqa
                           assert_same_tree, freeze_clock, golden,
                           json_part, one_cpu_thread, part_json,
                           reference_stream, store_tree, write_tree)
from madsim_tpu_torch import workloads
from madsim_tpu_torch.obs.causal import causal_fingerprint, fingerprints_match
from madsim_tpu_torch.search import LdfiConfig, fuzz
from madsim_tpu_torch.search.corpus import Corpus, split_entry_id
from madsim_tpu_torch.search.fuzz import WORKER_SEED_STRIDE
from madsim_tpu_torch.search.mutate import N_MUT_OPS, KnobPlan
from madsim_tpu_torch.service import (CorpusStore, StoreMismatch,
                                      campaign_report, replay_bucket,
                                      store_signature, worker_cmd)
from madsim_tpu_torch.service.store import CORPUS_VERSION

pytestmark = pytest.mark.usefixtures("one_cpu_thread")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODULE = "test_torch_campaign"

# the recorded campaigns: the runtime of each package, the fuzz arguments,
# the port's chunk (the reference's is in the arguments)
CRASHRICH = dict(max_steps=4096, batch=24, max_rounds=1, dry_rounds=3,
                 chunk=512)
ECHO_LDFI = dict(max_steps=3000, batch=12, max_rounds=3, dry_rounds=4,
                 chunk=256)
PORT_CHUNK = dict(crashrich=128, echo_ldfi=32)


def _crashrich(device="cpu"):
    return workloads.crashrich_wal_kv_runtime(device=device, trace_cap=128)


def _echo(device="cpu"):
    return workloads.ldfi_echo_runtime(device=device)


def _comparable(result: dict) -> dict:
    """A fuzz result less its host paths and times (`corpus_dir`,
    `phase_s`)."""
    return {k: v for k, v in result.items()
            if k not in ("corpus_dir", "phase_s")}


# -- the JAX package's campaigns (recorded) --------------------------------
def _jax_campaign(case, corpus_dir):
    from bench import _make_crashrich_runtime
    from madsim_tpu.search import LdfiConfig as JLdfi, fuzz as jfuzz
    from test_ldfi import _echo_ldfi_rt
    if case == "crashrich":
        return jfuzz(_make_crashrich_runtime("wal_kv", trace_cap=128),
                     corpus_dir=corpus_dir, **CRASHRICH)
    return jfuzz(_echo_ldfi_rt(), corpus_dir=corpus_dir,
                 ldfi=JLdfi(lanes=4, frac=0.25), **ECHO_LDFI)


def _campaign_reference(case):
    import tempfile
    from bench import _make_crashrich_runtime
    from madsim_tpu.service import replay_bucket as jreplay
    d = tempfile.mkdtemp(prefix="jax_campaign_")
    try:
        with reference_stream():
            res = _jax_campaign(case, d)
            freeze_clock(d)
            out = {"result": json_part(_comparable(res)),
                   "store": store_tree(d)}
            if case == "crashrich":
                key = sorted(os.listdir(os.path.join(d, "buckets")))[0][:-5]
                crashed, code, exp = jreplay(
                    _make_crashrich_runtime("wal_kv", trace_cap=128), d,
                    key, CRASHRICH["max_steps"], chunk=512)
                out["replay"] = json_part(dict(key=key, crashed=crashed,
                                               code=code, explain=exp))
        return out
    finally:
        shutil.rmtree(d, ignore_errors=True)


def _port_campaign(case, corpus_dir, **kw):
    args = dict(CRASHRICH if case == "crashrich" else ECHO_LDFI,
                chunk=PORT_CHUNK[case])
    args.update(kw)
    if case == "crashrich":
        return fuzz(_crashrich(), corpus_dir=corpus_dir, **args)
    return fuzz(_echo(), corpus_dir=corpus_dir,
                ldfi=LdfiConfig(lanes=4, frac=0.25), **args)


# -- the store contracts ----------------------------------------------------
def _observe_round(corpus, plan, n=8, hash0=100, round_no=0, crashed=None,
                   sketches=None):
    knobs = KnobPlan.stack([plan.base_knobs() for _ in range(n)])
    corpus.observe(
        knobs, seeds=np.arange(n), crashed=(crashed if crashed is not None
                                            else np.zeros(n, bool)),
        hashes_u64=np.arange(hash0, hash0 + n, dtype=np.uint64),
        codes=np.full(n, 7), parent_ids=np.full(n, -1),
        round_no=round_no, sketches=sketches)


def _synced(tmp_path, max_entries=4096, n=8):
    rt = _echo()
    plan = KnobPlan.from_runtime(rt)
    store = CorpusStore(str(tmp_path / "corpus"),
                        signature=store_signature(rt, plan))
    c = Corpus(plan, rng=np.random.default_rng(0), max_entries=max_entries)
    c.track_evictions = True
    _observe_round(c, plan, n=n)
    store.sync(c, 0, rounds_done=1, dry=0,
               op_hist=np.zeros(N_MUT_OPS, np.int64), wall_s=0.5)
    return store, rt, plan, c


def _reopen(store, rt, plan, **kw):
    return CorpusStore(store.dir, signature=store_signature(rt, plan)
                       ).load_corpus(plan, worker_id=0, rng_seed=0, **kw)


def contract_next_round_draws_bit_identical(tmp_path):
    rt = _echo()
    plan = KnobPlan.from_runtime(rt)
    c1 = Corpus(plan, rng=np.random.default_rng(7))
    c1.track_evictions = True
    sk = np.arange(24, dtype=np.uint32).reshape(8, 3) % 5
    _observe_round(c1, plan, round_no=0, sketches=sk,
                   crashed=np.asarray([1, 0, 0, 0, 0, 0, 0, 1], bool))
    _observe_round(c1, plan, n=4, hash0=300, round_no=1)
    store = CorpusStore(str(tmp_path / "corpus"),
                        signature=store_signature(rt, plan))
    store.sync(c1, 0, rounds_done=2, dry=0,
               op_hist=np.zeros(N_MUT_OPS, np.int64), wall_s=1.0)
    c2 = CorpusStore(store.dir, signature=store_signature(rt, plan)
                     ).load_corpus(plan, worker_id=0, rng_seed=7)
    assert [e["id"] for e in c2.entries] == [e["id"] for e in c1.entries]
    assert [e["energy"] for e in c2.entries] \
        == [e["energy"] for e in c1.entries]
    assert c2.coverage_keys() == c1.coverage_keys()
    assert c2.crash_codes == c1.crash_codes
    assert c2._slot_counts == c1._slot_counts
    p1, i1 = c1.schedule(16)
    p2, i2 = c2.schedule(16)
    assert (i1 == i2).all()
    key = np.asarray([0, 3], np.uint32)
    m1, h1, l1 = plan.mutate(p1, key)
    m2, h2, l2 = plan.mutate(p2, key)
    assert (h1 == h2).all() and (l1 == l2).all()
    for k in m1:
        assert (m1[k] == m2[k]).all(), k


def contract_version_mismatch_rejects(tmp_path):
    store, rt, plan, _ = _synced(tmp_path)
    p = os.path.join(store.dir, "MANIFEST.json")
    with open(p) as f:
        man = json.load(f)
    man["version"] = CORPUS_VERSION + 1
    with open(p, "w") as f:
        json.dump(man, f)
    with pytest.raises(StoreMismatch, match="version"):
        CorpusStore(store.dir, signature=store_signature(rt, plan))


def contract_signature_mismatch_rejects(tmp_path):
    store, _, _, _ = _synced(tmp_path)
    other = _crashrich()
    with pytest.raises(StoreMismatch, match="structurally different"):
        CorpusStore(store.dir, signature=store_signature(
            other, KnobPlan.from_runtime(other)))


def contract_not_a_corpus_dir_rejects(tmp_path):
    d = tmp_path / "x"
    d.mkdir()
    with open(d / "MANIFEST.json", "w") as f:
        json.dump({"format": "something-else"}, f)
    with pytest.raises(StoreMismatch, match="not a corpus"):
        CorpusStore(str(d))


def contract_missing_dir_without_create(tmp_path):
    with pytest.raises(FileNotFoundError):
        CorpusStore(str(tmp_path / "nope"), create=False)


def contract_kill_mid_write_leaves_loadable_store(tmp_path):
    store, rt, plan, c = _synced(tmp_path)
    for rel in ("entries/w0000-000000000099.npz.tmp-777",
                "state/w0000.json.tmp-777",
                "buckets/deadbeef.json.tmp-777",
                "MANIFEST.json.tmp-777"):
        with open(os.path.join(store.dir, rel), "w") as f:
            f.write("torn half-write garbage")
    c2 = _reopen(store, rt, plan)
    assert c2.coverage_keys() == c.coverage_keys()
    assert CorpusStore(store.dir, create=False).bucket_keys() == []
    assert len(store.entry_names()) == len(c.entries)


def contract_half_synced_own_entries_quarantined(tmp_path):
    store, rt, plan, c = _synced(tmp_path)
    orphan = dict(c.entries[0], id=(0 << 40) | 42, hash=999_999)
    store.write_entry(orphan)        # counter 42 >= next_counter 8
    c2 = _reopen(store, rt, plan)
    assert 999_999 not in c2.coverage_keys()
    assert all(e["id"] != orphan["id"] for e in c2.entries)


def contract_evicted_coverage_survives_resume(tmp_path):
    store, rt, plan, c = _synced(tmp_path, max_entries=4)
    assert len(c.entries) == 4 and len(c.coverage_keys()) == 8
    c2 = _reopen(store, rt, plan, max_entries=4)
    assert c2.coverage_keys() == c.coverage_keys()
    assert len(c2.entries) == 4


def contract_durable_fuzz_rejects_mismatched_namespace(tmp_path):
    rt = _echo()
    corpus = Corpus(KnobPlan.from_runtime(rt),
                    rng=np.random.default_rng(0), worker_id=0)
    with pytest.raises(ValueError, match="worker_id"):
        fuzz(rt, max_steps=200, batch=8, max_rounds=1, chunk=32,
             corpus=corpus, corpus_dir=str(tmp_path / "c"), worker_id=3)


CONTRACTS = {f.__name__[9:]: f for f in (
    contract_next_round_draws_bit_identical,
    contract_version_mismatch_rejects, contract_signature_mismatch_rejects,
    contract_not_a_corpus_dir_rejects, contract_missing_dir_without_create,
    contract_kill_mid_write_leaves_loadable_store,
    contract_half_synced_own_entries_quarantined,
    contract_evicted_coverage_survives_resume,
    contract_durable_fuzz_rejects_mismatched_namespace)}


@pytest.mark.parametrize("contract", sorted(CONTRACTS))
def test_store_contract(contract, tmp_path):
    CONTRACTS[contract](tmp_path)


# -- campaigns ---------------------------------------------------------------
def test_split_campaign_equals_continuous(tmp_path):
    """Interrupted at a round boundary and resumed (with the run-twice
    guard on its first round), a campaign ends with the uninterrupted
    one's store, file for file; a third call on the finished campaign is
    a no-op. Without ldfi nothing records an
    origin or a targeted count."""
    kw = dict(max_steps=3000, batch=12, dry_rounds=9, chunk=32)
    da, db = str(tmp_path / "a"), str(tmp_path / "b")
    fuzz(_echo(), max_rounds=1, corpus_dir=da, **kw)
    # the resume's first round runs twice under the run-twice guard
    ra = fuzz(_echo(), max_rounds=3, corpus_dir=da, verify_resume=True,
              **kw)
    rb = fuzz(_echo(), max_rounds=3, corpus_dir=db, **kw)
    assert ra["rounds"] == 2 and ra["rounds_done_total"] == 3
    assert rb["rounds"] == 3
    assert ra["distinct_schedules"] == rb["distinct_schedules"]
    for d in (da, db):
        freeze_clock(d)
    assert_same_tree(store_tree(db), store_tree(da), "split")
    r3 = fuzz(_echo(), max_rounds=3, corpus_dir=da, **kw)
    assert r3["rounds"] == 0
    assert r3["distinct_schedules"] == ra["distinct_schedules"]
    store = CorpusStore(da, create=False)
    assert all("origin" not in store.load_entry(n)
               for n in store.entry_names())
    assert "targeted_yield" not in store.load_worker_state(0)


@pytest.fixture(scope="module")
def crashrich_store(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("crashrich") / "camp")
    res = _port_campaign("crashrich", d, worker_id=0)
    return d, res


def test_crashrich_campaign_equals_the_reference(crashrich_store, tmp_path):
    d, res = crashrich_store
    ref = golden(MODULE, "crashrich")
    assert part_json(json_part(_comparable(res))) == part_json(ref["result"])
    assert res["crashes"] > 0 and res["buckets_total"] >= 1
    frozen = str(tmp_path / "frozen")
    shutil.copytree(d, frozen)
    freeze_clock(frozen)
    assert_same_tree(ref["store"], store_tree(frozen), "crashrich")


def test_two_workers_share_buckets(crashrich_store):
    """Worker 1 replays worker 0's seeds (the base_seed offset cancels
    the worker stride): it admits nothing new and observes the same
    buckets."""
    d, r0 = crashrich_store
    r1 = _port_campaign("crashrich", d, worker_id=1,
                        base_seed=-WORKER_SEED_STRIDE)
    store = CorpusStore(d, create=False)
    assert {split_entry_id(store.load_entry(n)["id"])[0]
            for n in store.entry_names()} == {0}
    assert r1["distinct_schedules"] == r0["distinct_schedules"]
    assert r1["buckets_total"] == r0["buckets_total"]
    assert not r1["buckets_opened"]
    per_bucket = {}
    for li in store.bucket_log():
        per_bucket.setdefault(li["bucket"], []).append(li["worker_id"])
    assert per_bucket
    for key, ws in per_bucket.items():
        assert sorted(ws) == [0, 1], (key, ws)
    assert campaign_report(d)["buckets_merged"] == len(store.bucket_keys())


def test_durable_ldfi_campaign_equals_the_reference(tmp_path):
    d = str(tmp_path / "camp")
    res = _port_campaign("echo_ldfi", d)
    ref = golden(MODULE, "echo_ldfi")
    assert part_json(json_part(_comparable(res))) == part_json(ref["result"])
    t = res["targeted"]
    assert t["supports"] >= 1 and t["lanes_run"] >= 1
    store = CorpusStore(d, create=False)
    origins = [store.load_entry(n).get("origin")
               for n in store.entry_names()]
    assert origins.count("targeted") == t["admitted"]
    assert store.load_worker_state(0)["targeted_yield"] == t["admitted"]
    assert len(res["phase_s"]) == res["rounds"]
    freeze_clock(d)
    assert_same_tree(ref["store"], store_tree(d), "echo_ldfi")


def test_store_signature_is_the_reference_s():
    import madsim_tpu.search.mutate as jmut
    import madsim_tpu.service.store as jstore
    from bench import (_make_aimed_asym_runtime, _make_crashrich_runtime,
                       _make_grayfail_runtime)
    from test_ldfi import _echo_ldfi_rt
    pairs = [(_echo_ldfi_rt(), _echo()),
             (_make_crashrich_runtime("wal_kv", trace_cap=128),
              _crashrich()),
             (_make_grayfail_runtime("mix"),
              workloads.grayfail_runtime("mix", device="cpu")),
             (_make_aimed_asym_runtime(),
              workloads.aimed_asym_runtime(device="cpu"))]
    for jrt, prt in pairs:
        for dup in (0, 2):
            a = jstore.store_signature(jrt, jmut.KnobPlan.from_runtime(
                jrt, dup_slots=dup))
            b = store_signature(prt, KnobPlan.from_runtime(
                prt, dup_slots=dup))
            assert json.dumps(a, sort_keys=True) \
                == json.dumps(b, sort_keys=True)
        # the same scenario rows, so a store's knob vectors mean the same
        jrows, prows = jrt.scenario.build(jrt.cfg), prt.scenario.build(
            prt.cfg)
        assert sorted(jrows) == sorted(prows)
        for k in jrows:
            np.testing.assert_array_equal(np.asarray(jrows[k]), prows[k])


def test_jax_bucket_replays_in_the_port(tmp_path):
    """The JAX package's store opens in the port (its signature is the
    port's) and its bucket replays to the same crash, fingerprint and
    chain, here and through the JAX package's own replay."""
    ref = golden(MODULE, "crashrich")
    d = write_tree(str(tmp_path / "jax_store"), ref["store"])
    rt = _crashrich()
    CorpusStore(d, signature=store_signature(rt, KnobPlan.from_runtime(rt)),
                create=False)
    jrep = part_json(ref["replay"])
    key = jrep["key"]
    crashed, code, exp = replay_bucket(rt, d, key, CRASHRICH["max_steps"],
                                       chunk=PORT_CHUNK["crashrich"])
    rec = CorpusStore(d, create=False).load_bucket(key)
    assert crashed and code == rec["crash_code"] == jrep["code"]
    assert fingerprints_match(causal_fingerprint(exp), rec["fingerprint"])
    assert part_json(json_part(dict(key=key, crashed=crashed, code=code,
                                    explain=exp))) == jrep


def test_entry_reader_equals_np_load(tmp_path):
    """The store's npz reader gives `np.load`'s arrays (dtype, shape,
    values, member order) on every entry and bucket file of the recorded
    stores, and falls back to `np.load` on a file it does not parse (a
    Fortran-ordered member, a compressed archive)."""
    from madsim_tpu_torch.service.store import _read_npz
    files = [rel for case in ("crashrich", "echo_ldfi")
             for rel in golden(MODULE, case)["store"]
             if rel.endswith(".npz")]
    d = str(tmp_path)
    for case in ("crashrich", "echo_ldfi"):
        write_tree(os.path.join(d, case), golden(MODULE, case)["store"])
    paths = [os.path.join(d, case, rel)
             for case in ("crashrich", "echo_ldfi") for rel in files
             if os.path.exists(os.path.join(d, case, rel))]
    odd = os.path.join(d, "odd.npz")
    np.savez(odd, f=np.asfortranarray(np.arange(6).reshape(2, 3)),
             s=np.str_("targeted"))
    packed = os.path.join(d, "packed.npz")
    np.savez_compressed(packed, a=np.arange(5, dtype=np.int64))
    assert len(paths) > 20
    for p in paths + [odd, packed]:
        got = _read_npz(p)
        with np.load(p) as z:
            assert list(got) == z.files, p
            for k in z.files:
                want = np.array(z[k])
                assert got[k].dtype == want.dtype and \
                    got[k].shape == want.shape, (p, k)
                np.testing.assert_array_equal(got[k], want, err_msg=k)


# the recordings against the JAX package (tests/_torch_golden.py)
REFERENCES = {case: (lambda c=case: _campaign_reference(c))
              for case in ("crashrich", "echo_ldfi")}


@pytest.mark.slow
@pytest.mark.parametrize("case", sorted(REFERENCES))
def test_golden_is_the_jax_packages_output(case):
    assert_golden_is_reference(MODULE, case, REFERENCES[case]())


@pytest.mark.slow
def test_sigkill_resume_equals_uninterrupted(tmp_path):
    """A worker process killed after its first sync and launched again
    with the same arguments ends with the store of an uninterrupted
    in-process campaign (wall-clock fields frozen, the worker's
    observer log aside)."""
    dk, dc = str(tmp_path / "kill"), str(tmp_path / "ctrl")
    cmd = worker_cmd(dk, 0, "madsim_tpu_torch.workloads:ldfi_echo_runtime",
                     factory_kwargs={"device": "cpu"}, max_steps=3000,
                     batch=12, max_rounds=4, chunk=32, dry_rounds=9)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    p = subprocess.Popen(cmd, cwd=REPO, env=env, stdout=subprocess.DEVNULL)
    state = os.path.join(dk, "state", "w0000.json")
    deadline = time.time() + 300
    while time.time() < deadline and not os.path.exists(state):
        assert p.poll() is None, "worker died before its first sync"
        time.sleep(0.05)
    assert os.path.exists(state), "no sync within 300 s"
    p.send_signal(signal.SIGKILL)
    p.wait()
    with open(state) as f:
        assert json.load(f)["rounds_done"] < 4
    subprocess.run(cmd, cwd=REPO, env=env, check=True,
                   stdout=subprocess.DEVNULL)
    fuzz(_echo(), max_steps=3000, batch=12, max_rounds=4, chunk=32,
         dry_rounds=9, corpus_dir=dc)
    for d in (dk, dc):
        freeze_clock(d)
    kill, ctrl = store_tree(dk, skip=("logs",)), store_tree(dc)
    # the killed round's timeline row and bucket lines may be written
    # twice (deduped by their readers); the rest is byte-identical
    for rel in ("metrics/w0000.jsonl", "buckets.jsonl"):
        if rel in kill:
            rows = bytes(kill.pop(rel)).decode().splitlines(True)
            uniq = list(dict.fromkeys(rows))
            assert "".join(uniq).encode() == bytes(ctrl.pop(rel)), rel
    assert_same_tree(ctrl, kill, "sigkill")
