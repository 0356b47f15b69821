"""The port's span plane (`ev_span`, the ring's `tr_qw`, `sa_*`) and its
readers against the JAX package (tolerance: zero), on the CPU.

Covers every leaf through `run` and `run_fused` on the JAX package's
pause/resume pingpong (tests/test_spans.py `_pp_rt`: parked deadlines
give nonzero queue-waits) with partial `span_lanes`; the same build
under a fixed latency, where every hop of a chain costs the same and the
dominant segment stays with its first hop (`dom_up` is strict); an
injected op starting a fresh chain; transparency; the readers
(`attribution_counters`, `attribution_brief`, `attribution_summary`,
`format_attribution`, `request_spans`, `request_span`,
`explain_latency`, `format_span`) and the Chrome trace with its request
spans, byte for byte; and `explain_latency(replay=True)` on a chain the
ring wrapped past, which waits for ROADMAP P11.8. The JAX side runs on
the non-partitionable threefry stream (see _torch_parity).
"""

import numpy as np
import pytest

import madsim_tpu as J
from _torch_parity import (assert_same, equal_results, jax_leaves,  # noqa
                           one_cpu_thread, reference_stream)
from madsim_tpu.models import pingpong as jpp
from madsim_tpu_torch import interop
from madsim_tpu_torch.core.state import TRACE_FIELDS
from madsim_tpu_torch.models import pingpong as tpp

pytestmark = pytest.mark.usefixtures("one_cpu_thread")

SEEDS = np.arange(4, dtype=np.uint32)
SPAN_LANES = [0, 1, 3]


def _scenario(mod, fixed=False):
    sc = mod.Scenario()
    if fixed:       # every send takes the same 2 ms: equal hop costs
        sc.at(0).set_latency(mod.ms(2), mod.ms(2))
    sc.at(mod.ms(30)).pause(1)
    sc.at(mod.ms(90)).resume(1)
    return sc


def _pp_rt(mod, pp, span=True, trace_cap=256):
    """tests/test_spans.py `_pp_rt`: pause/resume pingpong."""
    cfg = mod.SimConfig(n_nodes=3, time_limit=mod.sec(5), latency_hist=24,
                        trace_cap=trace_cap, complete_kinds=((mod.EV_MSG, 1),),
                        slo_target=mod.ms(6), span_attr=span,
                        net=mod.NetConfig(send_latency_min=mod.ms(1),
                                          send_latency_max=mod.ms(4)))
    kw = {} if mod is J else dict(device="cpu")
    return mod.Runtime(cfg, [pp.PingPong(3, target=40)], pp.state_spec(),
                       scenario=_scenario(mod), **kw)


def _readers(stats, obs, state, rt, path) -> dict:
    att = obs.attribution_summary(state)
    out = dict(counters=stats.attribution_counters(state),
               brief=stats.attribution_brief(state), summary=att,
               text=obs.format_attribution(att),
               text_named=obs.format_attribution(att, ["a", "b", "c"]),
               spans={lane: obs.request_spans(state, lane,
                                              slo_target=J.ms(6))
                      for lane in (0, 2)},
               explain={(lane, rank): obs.explain_latency(
                   state, lane, rank=rank, rt=rt)
                   for lane in (0, 3) for rank in (0, 2)},
               last=obs.request_span(obs.ring_records(state, 1)))
    out["text_span"] = obs.format_span(out["explain"][(0, 0)])
    out["count"] = obs.export_chrome_trace(path, state=state, lane=3)
    with open(path, "rb") as f:
        out["trace_bytes"] = f.read()
    return out


@pytest.fixture(scope="module")
def spans(tmp_path_factory):
    from madsim_tpu import obs as jobs
    from madsim_tpu.parallel import stats as jstats
    from madsim_tpu_torch import obs as tobs
    from madsim_tpu_torch.parallel import stats as tstats
    d = tmp_path_factory.mktemp("spans")
    out = {}
    with reference_stream():
        jrt = _pp_rt(J, jpp)
        s, _ = jrt.run(jrt.init_batch(SEEDS, span_lanes=SPAN_LANES), 384,
                       128)
        out["ref"] = jax_leaves(s)
        out["ref_readers"] = _readers(jstats, jobs, s, jrt,
                                      str(d / "j.json"))
        f = jrt.run_fused(jrt.init_batch(SEEDS, span_lanes=SPAN_LANES),
                          384, 128)
        out["ref_fused"] = jax_leaves(f)
        # the fixed-latency scenario (scenario rows are state: the same
        # compiled step), then host-injected ops on that state
        jrt.set_scenario(_scenario(J, fixed=True))
        e, _ = jrt.run(jrt.init_batch(SEEDS), 256, 128)
        out["ref_fixed"] = jax_leaves(e)
        for name, args in (("kill", (1,)), ("restart", (1,)),
                           ("pause", (2,)), ("resume", (2,))):
            e = getattr(jrt, name)(e, *args)
            e, _ = jrt.run(e, 32, 32)
        out["ref_injected"] = jax_leaves(e)
    import madsim_tpu_torch as P
    rt = _pp_rt(P, tpp)
    t, _ = rt.run(rt.init_batch(SEEDS, span_lanes=SPAN_LANES), 384, 128)
    out.update(rt=rt, state=t, port=interop.state_to_numpy(t),
               readers=_readers(tstats, tobs, t, rt, str(d / "t.json")))
    out["port_fused"] = interop.state_to_numpy(rt.run_fused(
        rt.init_batch(SEEDS, span_lanes=SPAN_LANES), 384, 128))
    rt.set_scenario(_scenario(P, fixed=True))
    e, _ = rt.run(rt.init_batch(SEEDS), 256, 128)
    out["fixed"] = interop.state_to_numpy(e)
    for name, args in (("kill", (1,)), ("restart", (1,)), ("pause", (2,)),
                       ("resume", (2,))):
        e = getattr(rt, name)(e, *args)
        e, _ = rt.run(e, 32, 32)
    out["injected"] = interop.state_to_numpy(e)
    rt.set_scenario(_scenario(P))
    return out


def test_span_plane_matches_reference_leaf_for_leaf(spans):
    assert_same(spans["ref"], spans["port"], what="spans run")
    assert_same(spans["ref_fused"], spans["port_fused"],
                what="spans run_fused")
    port = spans["port"]
    on = np.zeros(len(SEEDS), bool)
    on[SPAN_LANES] = True
    tails = port[".sa_tail"][:, :, 0].sum(1)
    assert (tails[on] > 0).all() and (tails[~on] == 0).all()
    # the parked hops' queue-waits reach the tail components
    assert port[".sa_tail"][:, :, 1].sum() > 0
    assert (port[".tr_qw"] > 0).any() and (port[".ev_span"][..., 2] > 0).any()
    # one fold, two readers: the tail count is the latency plane's misses
    np.testing.assert_array_equal(port[".sa_tail"][on][:, :, 0],
                                  port[".lh_slo_miss"][on])
    np.testing.assert_array_equal(port[".sa_bottleneck"].sum(1), tails)


def test_equal_hop_costs_and_injected_ops_match_reference(spans):
    """Under a fixed latency the hops tie and `dom_up` (strict >) keeps
    the first; an injected op's row starts a fresh chain."""
    assert_same(spans["ref_fixed"], spans["fixed"], what="fixed latency")
    assert spans["fixed"][".sa_bottleneck"].sum() > 0
    assert_same(spans["ref_injected"], spans["injected"],
                what="injected ops")


def test_span_plane_changes_no_other_leaf_and_no_fingerprint(spans):
    import madsim_tpu_torch as P
    off = _pp_rt(P, tpp, span=False)
    t, _ = off.run(off.init_batch(SEEDS), 384, 128)
    plain = interop.state_to_numpy(t)
    keys = [k for k in plain if k[1:].split("[")[0] not in TRACE_FIELDS]
    assert_same(plain, spans["port"], keys=keys, what="spans off/on")
    for k in (".tr_now", ".tr_lat", ".lh_e2e", ".ev_root_t"):
        np.testing.assert_array_equal(plain[k], spans["port"][k], err_msg=k)
    np.testing.assert_array_equal(off.fingerprints(t),
                                  spans["rt"].fingerprints(spans["state"]))


@pytest.mark.parametrize("what", [
    "counters", "brief", "summary", "text", "text_named", "spans",
    "explain", "last", "text_span", "count", "trace_bytes"])
def test_span_readers_match_reference(spans, what):
    equal_results(spans["ref_readers"][what], spans["readers"][what], what)


def test_the_trace_holds_request_spans(spans):
    import json
    doc = json.loads(spans["readers"]["trace_bytes"])
    events = doc["traceEvents"] if isinstance(doc, dict) else doc
    pairs = [e for e in events if e.get("cat") == "request"]
    assert pairs and len(pairs) % 2 == 0
    assert {e["ph"] for e in pairs} == {"b", "e"}


def test_explain_latency_replay_on_a_wrapped_chain_waits_for_time_travel(
        spans):
    from madsim_tpu_torch.obs import explain_latency
    rt = spans["rt"].derived(trace_cap=4)
    t, _ = rt.run(rt.init_batch(SEEDS[:1]), 96, 96)
    live = explain_latency(t, 0, rt=rt)
    assert live["truncated"] and not live["replayed"]
    with pytest.raises(NotImplementedError, match="P11.8"):
        explain_latency(t, 0, rt=rt, replay=True)
    # a whole chain has nothing to recover: the live answer
    whole = explain_latency(spans["state"], 0, rt=spans["rt"], replay=True)
    assert not whole["truncated"]
    with pytest.raises(ValueError, match="span_attr"):
        explain_latency(spans["state"].replace(
            tr_qw=spans["state"].tr_qw[:, :0]), 0)
