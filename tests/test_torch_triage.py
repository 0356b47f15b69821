"""The port's triage plane (`service/triage.py`, `service/report.py`,
`obs/dashboard.py`) against the JAX package, on the CPU (tolerance:
zero), over a store the JAX package wrote.

The reference (tests/data/test_torch_triage_golden.npz, held to a fresh
JAX run by the `slow` test_golden_is_the_jax_packages_output): the
crash-rich wal_kv campaign (bench.py `_make_crashrich_runtime("wal_kv",
trace_cap=128)`, B=16, 4096 steps) run for one round, snapshotted, run
on to two rounds, snapshotted, audited (`audit_buckets`, budget 1) and
snapshotted again, with the store's wall-clock fields rewritten from its
round counters after each run (`_torch_parity.freeze_clock`). The port
reads the recorded stores and must write the same snapshot bytes, the
same audit ledger (its replays run on the CPU in chunks of 64 steps, the
reference's in 512), the same diff, the same `render_text` and
`render_html`; `python -m madsim_tpu_torch.service.report <dir>
--against prev --html out.html` exits 0 and prints the text report.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_triage.py -q
"""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from _torch_parity import (assert_golden_is_reference,  # noqa
                           freeze_clock, golden, one_cpu_thread,
                           reference_stream, store_tree, write_tree)
from madsim_tpu_torch import workloads
from madsim_tpu_torch.obs.dashboard import render_html
from madsim_tpu_torch.service import (audit_buckets, load_snapshot,
                                      triage_diff, triage_snapshot)
from madsim_tpu_torch.service.report import render_text

pytestmark = pytest.mark.usefixtures("one_cpu_thread")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODULE = "test_torch_triage"
FUZZ = dict(max_steps=4096, batch=16, dry_rounds=3, chunk=512)


def _bytes(s) -> np.ndarray:
    data = s.encode() if isinstance(s, str) else s
    return np.frombuffer(data, np.uint8).copy()


def _snapshot_file(d, n):
    with open(os.path.join(d, "triage", f"{n:04d}.json"), "rb") as f:
        return f.read()


def _triage_reference():
    import tempfile
    from bench import _make_crashrich_runtime
    from madsim_tpu.obs.dashboard import render_html as jhtml
    from madsim_tpu.search import fuzz as jfuzz
    from madsim_tpu.service import (audit_buckets as jaudit,
                                    load_snapshot as jload,
                                    triage_diff as jdiff,
                                    triage_snapshot as jsnap)
    from madsim_tpu.service.report import render_text as jtext
    d = tempfile.mkdtemp(prefix="jax_triage_")
    out = {}
    try:
        with reference_stream():
            def rt():
                return _make_crashrich_runtime("wal_kv", trace_cap=128)
            jfuzz(rt(), corpus_dir=d, max_rounds=1, **FUZZ)
            freeze_clock(d)
            out["store1"] = store_tree(d)
            _, s1 = jsnap(d)
            jfuzz(rt(), corpus_dir=d, max_rounds=2, **FUZZ)
            freeze_clock(d)
            out["store2"] = store_tree(d, skip=("triage",))
            _, s2 = jsnap(d)
            audit = jaudit(rt(), d, FUZZ["max_steps"], budget=1)
            _, s3 = jsnap(d)
            d12, d23 = jdiff(s1, s2), jdiff(s2, s3)
            with open(os.path.join(d, "triage", "AUDIT.json"), "rb") as f:
                ledger = f.read()
            outputs = dict(
                snapshot1=_snapshot_file(d, 1), snapshot2=_snapshot_file(d, 2),
                snapshot3=_snapshot_file(d, 3), audit_ledger=ledger,
                audit_counts=json.dumps(audit["counts"], sort_keys=True),
                diff12=json.dumps(d12, sort_keys=True),
                diff23=json.dumps(d23, sort_keys=True),
                text12=jtext(s2, d12), text23=jtext(s3, d23),
                html12=jhtml(s2, d12), html23=jhtml(s3, d23))
            # what the report CLI renders: the snapshots as read back
            last, prev = jload(d, "last"), jload(d, "prev")
            outputs.update(cli_text=jtext(last, jdiff(prev, last)),
                           cli_html=jhtml(last, jdiff(prev, last)))
            out["outputs"] = {k: _bytes(v) for k, v in outputs.items()}
        return out
    finally:
        shutil.rmtree(d, ignore_errors=True)


@pytest.fixture(scope="module")
def ref():
    return golden(MODULE, "crashrich")


def _out(ref, name) -> str:
    return bytes(ref["outputs"][name]).decode()


@pytest.fixture(scope="module")
def played(ref, tmp_path_factory):
    """The reference's sequence, read by the port: snapshot, the second
    round's store, snapshot, audit, snapshot."""
    d = write_tree(str(tmp_path_factory.mktemp("triage") / "camp"),
                   ref["store1"])
    _, s1 = triage_snapshot(d)
    write_tree(d, ref["store2"])
    _, s2 = triage_snapshot(d)
    audit = audit_buckets(workloads.crashrich_wal_kv_runtime(
        device="cpu", trace_cap=128), d, FUZZ["max_steps"], budget=1,
        chunk=64)
    _, s3 = triage_snapshot(d)
    return d, (s1, s2, s3), audit


def test_snapshots_are_the_reference_s_bytes(ref, played):
    d, snaps, _ = played
    for n in (1, 2, 3):
        assert _snapshot_file(d, n).decode() == _out(ref, f"snapshot{n}"), n
    s3 = snaps[2]
    # attribution sums to its totals
    st, attr = s3["store"], s3["attribution"]
    assert sum(attr["recipe_coverage"].values()) == st["coverage_total"]
    assert sum(attr["operator_coverage"].values()) == st["coverage_total"]
    assert sum(attr["recipe_buckets"].values()) == st["buckets_total"]
    assert st["buckets_total"] >= 1


def test_audit_ledger_is_the_reference_s(ref, played):
    d, _, audit = played
    with open(os.path.join(d, "triage", "AUDIT.json")) as f:
        assert f.read() == _out(ref, "audit_ledger")
    assert json.dumps(audit["counts"], sort_keys=True) \
        == _out(ref, "audit_counts")
    assert audit["counts"]["pass"] == 1


def test_diff_and_renderings_are_the_reference_s(ref, played):
    _, (s1, s2, s3), _ = played
    d12, d23 = triage_diff(s1, s2), triage_diff(s2, s3)
    assert json.dumps(d12, sort_keys=True) == _out(ref, "diff12")
    assert json.dumps(d23, sort_keys=True) == _out(ref, "diff23")
    assert not d12["empty"]
    assert render_text(s2, d12) == _out(ref, "text12")
    assert render_text(s3, d23) == _out(ref, "text23")
    assert render_html(s2, d12) == _out(ref, "html12")
    assert render_html(s3, d23) == _out(ref, "html23")


def test_snapshot_twice_is_byte_stable(ref, tmp_path):
    d = write_tree(str(tmp_path / "camp"), ref["store1"])
    n1, a = triage_snapshot(d)
    n2, b = triage_snapshot(d)
    assert n2 == n1 + 1
    assert _snapshot_file(d, n1) == _snapshot_file(d, n2)
    assert triage_diff(a, b)["empty"]
    assert load_snapshot(d, "prev") == a


def test_report_cli(ref, played, tmp_path):
    d, _, _ = played
    html = str(tmp_path / "out.html")
    res = subprocess.run(
        [sys.executable, "-m", "madsim_tpu_torch.service.report", d,
         "--against", "prev", "--html", html],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout == _out(ref, "cli_text") + "\n"
    with open(html) as f:
        assert f.read() == _out(ref, "cli_html")


# the recording against the JAX package (tests/_torch_golden.py)
REFERENCES = {"crashrich": _triage_reference}


@pytest.mark.slow
@pytest.mark.parametrize("case", sorted(REFERENCES))
def test_golden_is_the_jax_packages_output(case):
    assert_golden_is_reference(MODULE, case, REFERENCES[case]())
