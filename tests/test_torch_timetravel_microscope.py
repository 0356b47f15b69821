"""The port's divergence microscope (`obs/timetravel.divergence_report`,
`export_pair_trace`) against the JAX package (tolerance: zero), on the
CPU.

On the crash-rich wal_kv with a 4-slot ring (bench.py
`_make_crashrich_runtime("wal_kv", trace_cap=4)`), lane A seed 3 against
two shapes of lane B: seed 5 (the JAX test's pair) and seed 3 under a
PCT nudge (chip_smoke's `timetravel_explain` holds a knob pair and a
nudge pair on the card to the port's CPU result). Each report (probe, verdicts, window, first divergent dispatch,
both suffixes) and the two-track trace's bytes equal the reference's
(so the report is as stable as the reference's); an identical pair
reports no divergence. Chunks of 64 (the JAX test runs 512): the port's eager CPU
step costs 20-40 ms (ROADMAP F24). The JAX side runs on the
non-partitionable threefry stream (see _torch_parity).
"""

import json

import pytest

from _torch_parity import (equal_results, one_cpu_thread,  # noqa: F401
                           reference_stream)
from madsim_tpu_torch import workloads
from madsim_tpu_torch.obs.timetravel import divergence_report

pytestmark = pytest.mark.usefixtures("one_cpu_thread")

MAX_STEPS, CHUNK = 2048, 64
NUDGE_B = 12345


def _reports(report, rt, tmp, tag):
    """`report` (a package's divergence_report) on the two pair shapes,
    each with its pair trace's bytes."""
    out = {}
    for shape, args in (("seeds", dict(seed_b=5)),
                        ("nudge", dict(nudge_b=NUDGE_B))):
        path = str(tmp / f"{tag}_{shape}.json")
        r = report(rt, 3, max_steps=MAX_STEPS, chunk=CHUNK,
                   export_trace=path, **args)
        assert r.pop("trace_path") == path
        with open(path, "rb") as f:
            out[shape] = (r, f.read())
    return out


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    from bench import _make_crashrich_runtime
    from madsim_tpu.obs.timetravel import divergence_report as jdiv
    with reference_stream():
        rt = _make_crashrich_runtime("wal_kv", trace_cap=4)
        return _reports(jdiv, rt, tmp_path_factory.mktemp("micro_ref"), "j")


@pytest.fixture(scope="module")
def rt():
    return workloads.crashrich_wal_kv_runtime(device="cpu", trace_cap=4)


@pytest.fixture(scope="module")
def got(rt, tmp_path_factory):
    return _reports(divergence_report, rt,
                    tmp_path_factory.mktemp("micro_port"), "t")


@pytest.mark.parametrize("shape", ["seeds", "nudge"])
def test_divergence_report_matches_reference(ref, got, shape):
    want, want_bytes = ref[shape]
    r, trace = got[shape]
    equal_results(want, r, f"divergence_report {shape}")
    assert trace == want_bytes
    assert r["diverged"] and r["first"]["kind"] in ("dispatch", "halt")
    f = r["first"]
    if f["kind"] == "dispatch":
        # the tie that flipped: both sides' records at one step
        assert f["a"]["step"] == f["b"]["step"] == f["step"]
        tok = ("kind", "node", "src", "tag")
        assert tuple(f["a"][k] for k in tok) != tuple(f["b"][k] for k in tok)
    assert r["suffix_a"] and r["suffix_b"]
    doc = json.loads(trace)
    assert {e.get("pid") for e in doc["traceEvents"]} == {0, 1}
    ids = [{e["id"] for e in doc["traceEvents"]
            if e.get("pid") == p and "id" in e} for p in (0, 1)]
    assert ids[0] and ids[1] and not (ids[0] & ids[1])


def test_the_report_needs_a_difference(rt):
    same = divergence_report(rt, 3, 3, max_steps=MAX_STEPS, chunk=CHUNK)
    assert same["diverged"] is False
    assert same["probe"]["bound"] == "exhausted"
    with pytest.raises(ValueError, match="diverge"):
        divergence_report(rt, 3)
