"""The port's schema codegen (`net/codegen.py`, the madsim-tonic-build
analog) against the JAX package, on the CPU.

  * `parse` equal to the reference's on tests/test_codegen.py's schemas,
    and the same refusals;
  * `generate` equal to the reference's output with the package name
    swapped and the payload indexed with the lane axis in front
    (`payload[1:]` -> `payload[:, 1:]`, `payload[0]` -> `payload[:, 0]`);
    the generated module names nothing of `madsim_tpu`;
  * the generated unary service (Counter: add x3, get; a float mean by
    bitcast) and the generated server-streaming method (Ticker.Watch
    through the `@rpc_stream` dispatch) run in the port, leaf for leaf
    against tests/test_codegen.py's programs over the reference's
    generated module (2 seeds, JAX: 8, to the halt; tolerance: zero), as
    tests/data/test_torch_codegen_golden.npz records it (the `slow`
    test_golden_is_the_jax_packages_output runs the reference again and
    holds it to that file);
  * `python -m madsim_tpu_torch.net.codegen schema.proto -o out.py`.

The JAX side runs on the non-partitionable threefry stream (see
_torch_parity).

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_codegen.py -q
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import madsim_tpu as J
import madsim_tpu_torch as P
import test_codegen as jcg
from _torch_parity import (assert_golden_is_reference, assert_same,  # noqa
                           golden, jax_leaves, one_cpu_thread,
                           reference_stream)
from madsim_tpu.net import codegen as jcodegen
from madsim_tpu_torch import interop
from madsim_tpu_torch.net import codegen, rpc, stream, streaming

pytestmark = pytest.mark.usefixtures("one_cpu_thread")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODULE = "test_torch_codegen"
SEEDS = np.arange(2, dtype=np.uint32)
_I32 = torch.int32

SCHEMAS = {
    "counter": jcg.SCHEMA,
    "ticker_stream": jcg.STREAM_SCHEMA,
    "counter_with_stream": jcg.SCHEMA.replace(
        "rpc Get(GetReq) returns (GetRsp);",
        "rpc Get(GetReq) returns (GetRsp);\n"
        "  rpc Watch(stream GetReq) returns (stream GetRsp);"),
}


def _as_port(src: str) -> str:
    """The reference's generated source as the port generates it."""
    return (src.replace("madsim_tpu.", "madsim_tpu_torch.")
            .replace("payload[1:]", "payload[:, 1:]")
            .replace("payload[0] =", "payload[:, 0] ="))


@pytest.mark.parametrize("schema", sorted(SCHEMAS))
def test_generate_matches_reference_with_the_package_swapped(schema):
    text = SCHEMAS[schema]
    assert codegen.parse(text) == jcodegen.parse(text)
    src = codegen.generate(text)
    assert src == _as_port(jcodegen.generate(text))
    assert "madsim_tpu." not in src.replace("madsim_tpu_torch.", "")
    mod = {}
    exec(compile(src, "<generated>", "exec"), mod)
    assert mod["Service"].__module__ == "madsim_tpu_torch.net.service"
    assert mod["Layout"].__module__ == "madsim_tpu_torch.utils.structs"


def test_refusals_match_reference():
    for bad, match in (("message M { repeated int32 xs = 1; }", "repeated"),
                       ("message M { string s = 1; }", "unsupported"),
                       ("message O { message I { int32 x = 1; } "
                        "int32 y = 1; }", "nested messages"),
                       ("message A { }\nservice S { rpc F(A) returns (A) "
                        "{} }", "options blocks")):
        with pytest.raises(AssertionError, match=match):
            codegen.parse(bad)
        with pytest.raises(AssertionError, match=match):
            jcodegen.parse(bad)


def _load(schema):
    mod = {}
    exec(compile(codegen.generate(schema), "<generated>", "exec"), mod)
    return mod


MOD = _load(jcg.SCHEMA)
SMOD = _load(jcg.STREAM_SCHEMA)


def test_float_roundtrip_via_layout():
    words = MOD["pack_add_rsp"](total=7, mean=torch.tensor([2.5, -0.75]))
    d = MOD["unpack_add_rsp"](torch.stack([torch.as_tensor(w).expand(2)
                                           for w in words], dim=-1))
    assert d["total"].tolist() == [7, 7]
    assert d["mean"].tolist() == [2.5, -0.75]


class CounterImpl(MOD["CounterBase"]):
    def handle_add(self, ctx, st, req, when):
        st["total"] = st["total"] + torch.where(when, req["delta"], 0)
        st["n"] = st["n"] + when.to(_I32)
        mean = (st["total"].to(torch.float32)
                / torch.clamp(st["n"], min=1))
        return dict(total=st["total"], mean=mean)

    def handle_get(self, ctx, st, req, when):
        return dict(total=st["total"])


class GenDriver(P.Program):
    """tests/test_codegen.py `GenDriver` on the port: add(5) x3 then
    get(); expect total 15 and mean 5.0."""

    def init(self, ctx):
        st = dict(ctx.state)
        st["call_id"] = rpc.new_call_id(ctx)
        MOD["counter_add"](ctx, 0, st["call_id"],
                           retry_timer_tag=jcg.T_RETRY, timeout=P.ms(40),
                           delta=5)
        ctx.state = st

    def _issue(self, ctx, st, step, call_id, when):
        is_get = step >= 3
        MOD["counter_add"](ctx, 0, call_id, retry_timer_tag=jcg.T_RETRY,
                           timeout=P.ms(40), delta=5, when=when & ~is_get)
        MOD["counter_get"](ctx, 0, call_id, retry_timer_tag=jcg.T_RETRY,
                           timeout=P.ms(40), when=when & is_get)

    def on_timer(self, ctx, tag, payload):
        st = dict(ctx.state)
        retry = ((tag == jcg.T_RETRY) & (payload[:, 0] == st["call_id"])
                 & (st["step"] < 4))
        self._issue(ctx, st, st["step"], st["call_id"], retry)
        ctx.state = st

    def on_message(self, ctx, src, tag, payload):
        st = dict(ctx.state)
        hit = rpc.is_reply(tag) & rpc.matches(payload, st["call_id"])
        is_add = tag == rpc.reply_tag(MOD["CounterBase"].Add.tag)
        add_rsp = MOD["unpack_add_rsp"](payload[:, 1:])
        get_rsp = MOD["unpack_get_rsp"](payload[:, 1:])
        third = hit & is_add & (st["step"] == 2)
        ctx.crash_if(third & (add_rsp["total"] != 15), 401)
        ctx.crash_if(third & (add_rsp["mean"] != 5.0), 402)
        done = hit & ~is_add
        ctx.crash_if(done & (get_rsp["total"] != 15), 403)
        st["step"] = st["step"] + hit.to(_I32)
        new_id = rpc.new_call_id(ctx)
        self._issue(ctx, st, st["step"], new_id, hit & ~done)
        st["call_id"] = torch.where(hit & ~done, new_id, st["call_id"])
        ctx.halt_if(done & (ctx.node == 1))
        ctx.state = st


class TickerImpl(SMOD["TickerBase"]):
    """tests/test_codegen.py `TickerImpl` on the port: on the opening
    call, stream N_ITEMS values and the StreamEnd marker."""

    def handle_watch(self, ctx, st, src, kind, call_id, body, when):
        opened = when & (kind == streaming.K_CALL)
        tag = SMOD["TickerBase"].Watch.tag
        for j in range(jcg.N_ITEMS):
            streaming.push(ctx, st, src, call_id, [100 + j], method=tag,
                           when=opened)
        streaming.finish(ctx, st, src, call_id, method=tag, when=opened)

    def init(self, ctx):
        ctx.set_timer(P.ms(20), jcg.T_TICK)

    def on_timer(self, ctx, tag, payload):
        st = dict(ctx.state)
        is_tick = tag == jcg.T_TICK
        streaming.tick(ctx, st, [1], when=is_tick)
        ctx.set_timer(P.ms(20), jcg.T_TICK, when=is_tick)
        ctx.state = st


class WatchClient(P.Program):
    """tests/test_codegen.py `WatchClient` on the port."""

    def init(self, ctx):
        st = dict(ctx.state)
        st["cid"] = rpc.new_call_id(ctx)
        streaming.open_call(ctx, st, 0, SMOD["TickerBase"].Watch.tag,
                            st["cid"], [jcg.N_ITEMS])
        ctx.set_timer(P.ms(20), jcg.T_TICK)
        ctx.state = st

    def on_timer(self, ctx, tag, payload):
        st = dict(ctx.state)
        is_tick = tag == jcg.T_TICK
        streaming.tick(ctx, st, [0], when=is_tick)
        ctx.set_timer(P.ms(20), jcg.T_TICK, when=is_tick)
        ctx.state = st

    def on_message(self, ctx, src, tag, payload):
        st = dict(ctx.state)
        kinds, methods, cids, bodies, mask = streaming.on_stream(
            ctx, st, src, tag, payload)
        for i in stream.delivered_slots(mask):
            mine = mask[:, i] & (cids[:, i] == st["cid"])
            item = mine & (kinds[:, i] == streaming.K_ITEM)
            ctx.crash_if(item & (bodies[:, i, 0] != 100 + st["got"]),
                         jcg.CRASH_BAD_ITEM)
            st["got"] = st["got"] + item.to(_I32)
            done = mine & (kinds[:, i] == streaming.K_END)
            ctx.crash_if(done & (st["got"] != jcg.N_ITEMS),
                         jcg.CRASH_BAD_COUNT)
            ctx.halt_if(done)
        ctx.state = st


def _counter(pkg):
    cfg = pkg.SimConfig(n_nodes=2, time_limit=pkg.sec(20))
    if pkg is P:
        z = torch.tensor(0, dtype=_I32)
        return P.Runtime(cfg, [CounterImpl(), GenDriver()],
                         dict(total=z, n=z, call_id=z, step=z),
                         node_prog=[0, 1], device="cpu")
    import jax.numpy as jnp
    z = jnp.asarray(0, jnp.int32)
    return J.Runtime(cfg, [jcg.CounterImpl(), jcg.GenDriver()],
                     dict(total=z, n=z, call_id=z, step=z),
                     node_prog=[0, 1])


def _ticker(pkg):
    cfg = pkg.SimConfig(n_nodes=2, time_limit=pkg.sec(20))
    if pkg is P:
        z = torch.tensor(0, dtype=_I32)
        spec = dict(**streaming.streaming_state(2, window=6, body_words=1),
                    cid=z, got=z)
        return P.Runtime(cfg, [TickerImpl(), WatchClient()], spec,
                         node_prog=[0, 1], device="cpu")
    import jax.numpy as jnp
    from madsim_tpu.net import streaming as jstreaming
    z = jnp.asarray(0, jnp.int32)
    spec = dict(**jstreaming.streaming_state(2, window=6, body_words=1),
                cid=z, got=z)
    return J.Runtime(cfg, [jcg.TickerImpl(), jcg.WatchClient()], spec,
                     node_prog=[0, 1])


SERVICE_CASES = {"counter_unary": _counter, "ticker_streaming": _ticker}


def _service_reference(case):
    with reference_stream():
        jrt = SERVICE_CASES[case](J)
        return {"ref": jax_leaves(jrt.run(jrt.init_batch(SEEDS), 10_000,
                                          64)[0])}


@pytest.mark.parametrize("case", sorted(SERVICE_CASES))
def test_generated_service_runs_in_the_port(case):
    make = SERVICE_CASES[case]
    ref = golden(MODULE, case)["ref"]
    rt = make(P)
    got = interop.state_to_numpy(rt.run(rt.init_batch(SEEDS), 10_000,
                                        64)[0])
    assert_same(ref, got, what=case)
    assert got[".halted"].all() and not got[".crashed"].any()
    if case == "counter_unary":
        assert (got[".node_state['total']"][:, 0] == 15).all()
    else:
        assert (got[".node_state['got']"][:, 1] == jcg.N_ITEMS).all()


def test_cli(tmp_path):
    schema = tmp_path / "svc.proto"
    schema.write_text(jcg.SCHEMA)
    out = tmp_path / "svc_pb.py"
    res = subprocess.run([sys.executable, "-m", "madsim_tpu_torch.net.codegen",
                          str(schema), "-o", str(out)], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    text = out.read_text()
    assert "class CounterBase(Service)" in text
    assert "from madsim_tpu_torch.net.service import" in text
    assert "madsim_tpu." not in text.replace("madsim_tpu_torch.", "")


# the recording against the JAX package (tests/_torch_golden.py)
REFERENCES = {case: (lambda c=case: _service_reference(c))
              for case in SERVICE_CASES}


@pytest.mark.slow
@pytest.mark.parametrize("case", sorted(REFERENCES))
def test_golden_is_the_jax_packages_output(case):
    assert_golden_is_reference(MODULE, case, REFERENCES[case]())
