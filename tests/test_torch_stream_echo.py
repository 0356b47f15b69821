"""The port's streaming RPC (`net/streaming.py`, the `@rpc_stream`
dispatch of `net/service.py`) and its echo workload
(`models/stream_echo.py`) against the JAX package (tolerance: zero), on
the CPU.

tests/test_streaming.py's clean shapes restated on the port on the same
inputs: `make_stream_echo_runtime(mode)` at its defaults
(`workloads.stream_echo_runtime`: one server, 2 clients of 6 items) for
the bidi, client-streaming (sum) and server-streaming (download) shapes,
2 seeds each (JAX: 8) to the halt through `run` for 32 steps and
`run_fused` from there, leaf for leaf against the reference's run as
tests/data/test_torch_stream_echo_golden.npz records it (the `slow`
test_golden_is_the_jax_packages_output runs the reference again and holds
it to that file); every client done, no crash, well before 4 simulated
seconds. Its adversity cases (10% loss, the server
killed mid-stream and restarted with amnesia) are `slow` here, beside
these, as they are in the reference (~600-900 eager CPU steps each).
The JAX side runs on the non-partitionable threefry stream (see
_torch_parity).

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_stream_echo.py -q
"""

import numpy as np
import pytest

import madsim_tpu as J
import madsim_tpu_torch as P
from _torch_parity import (assert_golden_is_reference, assert_same,  # noqa
                           golden, jax_leaves, one_cpu_thread,
                           reference_stream)
from madsim_tpu.models import stream_echo as je
from madsim_tpu_torch import interop, workloads
from madsim_tpu_torch.models import stream_echo as te
from madsim_tpu_torch.net import streaming

pytestmark = pytest.mark.usefixtures("one_cpu_thread")

MODULE = "test_torch_stream_echo"
SEEDS = np.arange(2, dtype=np.uint32)
EAGER_STEPS = 32
CHUNK = 32


def _same_run(jmake, tmake, seeds, max_steps):
    return _reference(jmake, seeds, max_steps)["ref"], _port(tmake, seeds,
                                                             max_steps)


def _reference(jmake, seeds, max_steps):
    with reference_stream():
        jrt = jmake()
        s, _ = jrt.run(jrt.init_batch(seeds), max_steps, CHUNK)
        return {"ref": jax_leaves(s)}


def _port(tmake, seeds, max_steps):
    rt = tmake()
    t, _ = rt.run(rt.init_batch(seeds), EAGER_STEPS, CHUNK)
    t = rt.run_fused(t, max_steps, chunk=CHUNK)
    return interop.state_to_numpy(t)


@pytest.mark.parametrize("mode", workloads.STREAM_ECHO_MODES)
def test_stream_echo_shape_matches_reference(mode):
    ref = golden(MODULE, mode)["ref"]
    got = _port(lambda: workloads.stream_echo_runtime(mode, device="cpu"),
                SEEDS, 20_000)
    assert_same(ref, got, what=mode)
    assert got[".halted"].all() and not got[".crashed"].any()
    assert (got[".node_state['c_done']"][:, 1:] == 1).all()
    assert (got[".now"] < P.sec(4)).all()
    assert got[".node_state['sx_val']"].shape[2:] == (
        3, 4, streaming.HEADER_WORDS + 1)


# the recording against the JAX package (tests/_torch_golden.py)
REFERENCES = {mode: (lambda m=mode: _reference(
    lambda: je.make_stream_echo_runtime(m), SEEDS, 20_000))
    for mode in workloads.STREAM_ECHO_MODES}


@pytest.mark.slow
@pytest.mark.parametrize("case", sorted(REFERENCES))
def test_golden_is_the_jax_packages_output(case):
    assert_golden_is_reference(MODULE, case, REFERENCES[case]())


def test_stream_method_tags_match_reference():
    for m in ("echo", "sum", "download"):
        assert getattr(te.StreamEchoServer, m).tag == \
            getattr(je.StreamEchoServer, m).tag
    assert [m.tag for m in te.StreamEchoServer(3)._stream_handlers()] == \
        [m.tag for m in je.StreamEchoServer(3)._stream_handlers()]


def _adverse_cfg(pkg, loss=0.0, time_limit=None):
    return pkg.SimConfig(n_nodes=3, event_capacity=64, payload_words=8,
                         time_limit=time_limit or pkg.sec(8),
                         net=pkg.NetConfig(packet_loss_rate=loss,
                                           send_latency_min=pkg.ms(1),
                                           send_latency_max=pkg.ms(8)))


@pytest.mark.slow
@pytest.mark.parametrize("case", ["loss_bidi", "kill_mid_stream"])
def test_stream_echo_adversity_matches_reference(case):
    """tests/test_streaming.py TestAdversity: 10% loss (bidi), and the
    server killed at 40 ms, before any 10-item stream completes, and
    restarted at 400 ms (clients detect the stall, reset and re-run)."""
    def make(pkg, mod):
        kw = dict(device="cpu") if pkg is P else {}
        if case == "loss_bidi":
            return mod.make_stream_echo_runtime(
                "bidi", n_clients=2, n_items=6,
                cfg=_adverse_cfg(pkg, loss=0.10), **kw)
        sc = pkg.Scenario()
        sc.at(pkg.ms(40)).kill(0)
        sc.at(pkg.ms(400)).restart(0)
        return mod.make_stream_echo_runtime(
            "bidi", n_clients=2, n_items=10, scenario=sc,
            cfg=_adverse_cfg(pkg), **kw)

    ref, got = _same_run(lambda: make(J, je), lambda: make(P, te), SEEDS,
                         40_000)
    assert_same(ref, got, what=case)
    assert (got[".node_state['c_done']"][:, 1:] == 1).all()
    if case == "kill_mid_stream":
        assert (got[".now"] > P.ms(400)).all()
