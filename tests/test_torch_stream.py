"""The port's stream and connection layers (`net/stream.py`,
`net/conn.py`, `utils/maskutil.py`, `utils/structs.py`) against the JAX
package (tolerance: zero), on the CPU.

  * the unit cases of tests/test_connfault.py's TestIncarnationGuards,
    restated on the port on the same inputs: each case is one script of
    helper calls run on both packages, one lane a call on the port, and
    every state leaf, returned mask and recorded send after every call is
    compared (and the reference test's own assertions hold on the port);
  * the programs of tests/test_stream.py (`Pipe`: exactly-once in-order
    delivery clean, at 30% loss with heavy reorder, and through a clogged
    link) and tests/test_conn.py (`Client`: handshake then ordered data,
    refusal by a non-listener, the handshake under 25% loss), restated on
    the port and run leaf for leaf against the reference's programs to
    the halt (2 seeds, JAX: 8), as tests/data/test_torch_stream_golden.npz
    records them (the `slow` test_golden_is_the_jax_packages_output runs
    the reference again and holds it to that file);
  * `maskutil.needed` on tensors and host constants, and the bitcast of
    `structs`.

The streaming shapes are in tests/test_torch_stream_echo.py, minipg and
the connection-fault workloads in tests/test_torch_minipg.py. The JAX
side runs on the non-partitionable threefry stream (see _torch_parity).

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_stream.py -q
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import madsim_tpu as J
import madsim_tpu_torch as P
from _torch_parity import (assert_golden_is_reference, assert_same,  # noqa
                           golden, jax_leaves, one_cpu_thread,
                           reference_stream)
from madsim_tpu.core import prng as jprng
from madsim_tpu.core.api import Ctx as JCtx
from madsim_tpu.net import conn as jconn
from madsim_tpu.net import stream as jstream
from madsim_tpu_torch import interop
from madsim_tpu_torch.core import prng as tprng
from madsim_tpu_torch.core.api import Ctx as TCtx
from madsim_tpu_torch.net import conn as tconn
from madsim_tpu_torch.net import stream as tstream
from madsim_tpu_torch.ops.select import put_at
from madsim_tpu_torch.utils import maskutil, structs

pytestmark = pytest.mark.usefixtures("one_cpu_thread")

MODULE = "test_torch_stream"
_I32 = torch.int32


# --------------------------------------------------------------------------
# unit level: the incarnation guards, one script on both packages
# --------------------------------------------------------------------------
class _World:
    """One package's side of a unit script: its modules, a Ctx of one
    lane, payloads, state edits and readings as numpy (the port's lane
    axis dropped)."""

    def __init__(self, torch_side: bool):
        self.t = torch_side
        self.conn = tconn if torch_side else jconn
        self.stream = tstream if torch_side else jstream
        self.log = []

    def ctx(self, n=2, payload_words=8):
        cfg = (P if self.t else J).SimConfig(n_nodes=n,
                                             payload_words=payload_words)
        if self.t:
            z = torch.zeros(1, dtype=_I32)
            return TCtx(cfg, z, z.clone(), tprng.seed_key(torch.tensor([7])),
                        {})
        return JCtx(cfg, jnp.asarray(0, jnp.int32),
                    jnp.asarray(0, jnp.int32), jprng.seed_key(7), {})

    def pay(self, words):
        if self.t:
            return torch.tensor([words], dtype=_I32)
        return jnp.asarray(words)

    def state(self, n=2, window=4):
        st = dict(**self.conn.conn_state(n),
                  **self.stream.stream_state(n, window=window))
        if self.t:
            st = {k: v.unsqueeze(0).clone() for k, v in st.items()}
        return st

    def set(self, st, k, idx, v):
        if self.t:
            st[k] = put_at(st[k], idx, v)
        else:
            st[k] = st[k].at[idx].set(v)

    def np(self, x):
        a = np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)
        return a[0] if self.t and a.ndim else a

    def live_sends(self, ctx):
        """The sends recorded so far whose mask holds. Called eagerly on
        concrete values, the JAX package drops a send whose mask is
        statically False; the port records every send with its mask (a
        tensor mask is never statically false), so the sends that go out
        are what both must agree on."""
        return [s for s in ctx._sends if bool(self.np(s["m"]))]

    def record(self, ctx, st, *outs):
        """One transcript entry: every state leaf, the returned values and
        the live sends so far."""
        entry = {f"st.{k}": self.np(v) for k, v in sorted(st.items())}
        for i, o in enumerate(outs):
            entry[f"out{i}"] = self.np(o)
        for i, s in enumerate(self.live_sends(ctx)):
            for f in ("dst", "tag", "payload"):
                entry[f"send{i}.{f}"] = self.np(s[f])
        self.log.append(entry)


def _established_pair(w):
    st = w.state()
    w.set(st, "cn_state", 1, w.conn.ESTABLISHED)
    w.set(st, "cn_epoch", 1, 3)
    w.set(st, "st_epoch", 1, 3)
    return st


def _stale_rst_rejected(w):
    ctx, st = w.ctx(), _established_pair(w)
    w.record(ctx, st, *w.conn.on_message(ctx, st, 1, w.conn.TAG_RST,
                                         w.pay([2] + [0] * 7)))
    assert int(w.np(st["cn_state"])[1]) == w.conn.ESTABLISHED
    assert int(w.np(st["cn_epoch"])[1]) == 3
    _, _, rst = w.conn.on_message(ctx, st, 1, w.conn.TAG_RST,
                                  w.pay([3] + [0] * 7))
    w.record(ctx, st, rst)
    assert bool(w.np(rst)) and int(w.np(st["cn_state"])[1]) == \
        w.conn.CLOSED
    assert int(w.np(st["cn_epoch"])[1]) == 4


def _stale_rst_closes_without_guard(w):
    ctx, st = w.ctx(), _established_pair(w)
    _, _, rst = w.conn.on_message(ctx, st, 1, w.conn.TAG_RST,
                                  w.pay([2] + [0] * 7), epoch_guard=False)
    w.record(ctx, st, rst)
    assert bool(w.np(rst)) and int(w.np(st["cn_state"])[1]) == \
        w.conn.CLOSED


def _stale_segment_dropped_fresh_adopted(w):
    ctx, st = w.ctx(), _established_pair(w)

    def data(seq, ep, val):
        return w.pay([seq, ep, val] + [0] * 5)

    vals, mask = w.stream.on_message(ctx, st, 1, w.stream.TAG_DATA,
                                     data(0, 2, 41))
    w.record(ctx, st, vals, mask)
    assert not w.np(mask).any()
    assert int(w.np(st["sr_next"])[1]) == 0 and not w.live_sends(ctx)
    vals, mask = w.stream.on_message(ctx, st, 1, w.stream.TAG_DATA,
                                     data(0, 3, 42))
    w.record(ctx, st, vals, mask)
    assert w.np(mask)[0] and int(w.np(vals)[0]) == 42
    assert int(w.np(st["sr_next"])[1]) == 1 and len(w.live_sends(ctx)) == 1
    vals, mask = w.stream.on_message(ctx, st, 1, w.stream.TAG_DATA,
                                     data(0, 5, 43))
    w.record(ctx, st, vals, mask)
    assert w.np(mask)[0] and int(w.np(vals)[0]) == 43
    assert int(w.np(st["st_epoch"])[1]) == 5
    assert int(w.np(st["sr_next"])[1]) == 1


def _stale_segment_accepted_without_guard(w):
    ctx, st = w.ctx(), _established_pair(w)
    vals, mask = w.stream.on_message(ctx, st, 1, w.stream.TAG_DATA,
                                     w.pay([0, 2, 666] + [0] * 5),
                                     epoch_guard=False)
    w.record(ctx, st, vals, mask)
    assert w.np(mask)[0] and int(w.np(vals)[0]) == 666


def _stale_ack_cannot_slide_window(w):
    ctx, st = w.ctx(), _established_pair(w)
    w.record(ctx, st, w.stream.send(ctx, st, 1, 10))
    w.record(ctx, st, w.stream.send(ctx, st, 1, 11))
    assert int(w.np(st["sx_seq"])[1]) == 2
    w.stream.on_message(ctx, st, 1, w.stream.TAG_ACK,
                        w.pay([2, 2] + [0] * 6))       # stale epoch
    w.record(ctx, st)
    assert int(w.np(st["sx_base"])[1]) == 0
    w.stream.on_message(ctx, st, 1, w.stream.TAG_ACK,
                        w.pay([2, 3] + [0] * 6))       # current
    w.record(ctx, st)
    assert int(w.np(st["sx_base"])[1]) == 2


def _retransmit_after_reset_is_noop(w):
    ctx, st = w.ctx(), _established_pair(w)
    w.stream.send(ctx, st, 1, 10)
    w.stream.send(ctx, st, 1, 11)
    n_before = len(w.live_sends(ctx))
    w.stream.reset_peer(st, 1)
    w.record(ctx, st)
    assert int(w.np(st["st_epoch"])[1]) == 4
    w.stream.retransmit(ctx, st, 1, when=True)
    w.record(ctx, st)
    assert len(w.live_sends(ctx)) == n_before, \
        "stale retransmit injected segments after reset_peer"
    w.stream.send(ctx, st, 1, 12)
    w.record(ctx, st)
    assert int(w.np(w.live_sends(ctx)[-1]["payload"])[1]) == 4


def _frames_stamp_current_epoch(w):
    ctx, st = w.ctx(), _established_pair(w)
    w.stream.send(ctx, st, 1, 99)
    w.record(ctx, st)
    sent = w.np(w.live_sends(ctx)[-1]["payload"])
    assert int(sent[0]) == 0 and int(sent[1]) == 3


def _duplicate_syn_does_not_reopen_window(w):
    ctx, st = w.ctx(), w.state()
    w.conn.listen(ctx, st)
    syn = w.pay([3] + [0] * 7)
    w.record(ctx, st, *w.conn.on_message(ctx, st, 1, w.conn.TAG_SYN, syn))
    assert int(w.np(st["st_epoch"])[1]) == 3
    data = w.pay([0, 3, 42] + [0] * 5)
    vals, mask = w.stream.on_message(ctx, st, 1, w.stream.TAG_DATA, data)
    w.record(ctx, st, vals, mask)
    assert w.np(mask)[0] and int(w.np(st["sr_next"])[1]) == 1
    w.record(ctx, st, *w.conn.on_message(ctx, st, 1, w.conn.TAG_SYN, syn))
    assert int(w.np(st["sr_next"])[1]) == 1
    vals, mask = w.stream.on_message(ctx, st, 1, w.stream.TAG_DATA, data)
    w.record(ctx, st, vals, mask)
    assert not w.np(mask).any()


def _handshake_negotiates_past_torn_generation(w):
    ctx, st = w.ctx(), _established_pair(w)
    w.conn.listen(ctx, st)
    accept, est, rst = w.conn.on_message(ctx, st, 1, w.conn.TAG_SYN,
                                         w.pay([5] + [0] * 7))
    w.record(ctx, st, accept, est, rst)
    assert bool(w.np(accept))
    assert int(w.np(st["cn_epoch"])[1]) == 5
    assert int(w.np(st["st_epoch"])[1]) == 5
    syn_ack = w.live_sends(ctx)[-1]
    assert int(w.np(syn_ack["tag"])) == w.conn.TAG_SYN_ACK
    assert int(w.np(syn_ack["payload"])[0]) == 5


def _connect_then_reset(w):
    """The dialing side (not covered by the guard cases): connect from
    CLOSED and again from SYN_SENT, the SYN-ACK that installs the
    negotiated generation, a send and a local reset."""
    ctx, st = w.ctx(), w.state()
    w.record(ctx, st, w.conn.connect(ctx, st, 1))
    w.record(ctx, st, w.conn.connect(ctx, st, 1))
    w.record(ctx, st, *w.conn.on_message(ctx, st, 1, w.conn.TAG_SYN_ACK,
                                         w.pay([2] + [0] * 7)))
    assert bool(w.np(w.conn.is_established(st, 1)))
    w.record(ctx, st, w.stream.send(ctx, st, 1, 5))
    w.conn.reset(ctx, st, 1)
    w.record(ctx, st)
    assert int(w.np(st["cn_state"])[1]) == w.conn.CLOSED
    assert int(w.np(st["cn_epoch"])[1]) == 3


GUARD_CASES = {f.__name__[1:]: f for f in (
    _stale_rst_rejected, _stale_rst_closes_without_guard,
    _stale_segment_dropped_fresh_adopted,
    _stale_segment_accepted_without_guard, _stale_ack_cannot_slide_window,
    _retransmit_after_reset_is_noop, _frames_stamp_current_epoch,
    _duplicate_syn_does_not_reopen_window,
    _handshake_negotiates_past_torn_generation, _connect_then_reset)}


@pytest.mark.parametrize("case", sorted(GUARD_CASES))
def test_incarnation_guard_unit_case_matches_reference(case):
    ref, port = _World(False), _World(True)
    with reference_stream():
        GUARD_CASES[case](ref)
    GUARD_CASES[case](port)
    assert len(ref.log) == len(port.log)
    for i, (r, t) in enumerate(zip(ref.log, port.log)):
        assert sorted(r) == sorted(t), (case, i)
        for k in r:
            np.testing.assert_array_equal(t[k], r[k],
                                          err_msg=f"{case} #{i} {k}")
            assert t[k].dtype == r[k].dtype, \
                (case, i, k, t[k].dtype, r[k].dtype)


# --------------------------------------------------------------------------
# maskutil and structs
# --------------------------------------------------------------------------
def test_a_tensor_mask_is_never_statically_false():
    assert maskutil.needed(torch.zeros(4, dtype=torch.bool))
    assert maskutil.needed(torch.tensor(False))
    assert not maskutil.statically_false(torch.zeros(3, dtype=torch.bool))
    assert not maskutil.needed(False)
    assert not maskutil.needed(np.zeros(3, dtype=bool))
    assert maskutil.needed(True) and maskutil.needed(np.array([0, 1]))


def test_structs_bitcast_and_layout_match_reference():
    from madsim_tpu.utils import structs as jstructs
    vals = np.array([0.0, -0.0, 1.5, -3.25e-7, 3.4e38, np.inf, np.nan],
                    dtype=np.float32)
    w = structs.f32_to_word(torch.as_tensor(vals))
    assert w.dtype == torch.int32
    with reference_stream():
        jw = np.asarray(jstructs.f32_to_word(jnp.asarray(vals)))
    np.testing.assert_array_equal(w.numpy(), jw)
    back = structs.word_to_f32(w).numpy()
    assert back.tobytes() == vals.tobytes()
    L = structs.Layout("term", "prev", "commit")
    assert (L.term, L.commit, L.width) == (0, 2, 3)
    words = L.pack(term=torch.tensor([7, 8], dtype=_I32), commit=5)
    assert words[1] == 0 and words[2] == 5
    got = L.unpack(torch.tensor([[1, 2, 3, 9], [4, 5, 6, 9]], dtype=_I32))
    assert got["prev"].tolist() == [2, 5]
    with pytest.raises(AssertionError):
        L.pack(bogus=1)


# --------------------------------------------------------------------------
# program level: tests/test_stream.py's Pipe, tests/test_conn.py's Client
# --------------------------------------------------------------------------
K = 12          # test_conn.py's K (test_stream.py streams 24)
K_PIPE = 24
W = 4
T_PUMP, T_RETX = 1, 2              # test_stream.py's timer tags
T_CONNECT, T_CPUMP, T_CRETX = 1, 2, 3   # test_conn.py's


def _pipe_spec(n):
    z = torch.tensor(0, dtype=_I32)
    return dict(pushed=z, got=z.clone(),
                rx_log=torch.full((K_PIPE,), -1, dtype=_I32),
                **tstream.stream_state(n, window=W))


def _log_into(st, take, val, k):
    idx = torch.clamp(st["got"], 0, k - 1)
    st["rx_log"] = put_at(st["rx_log"], idx, val, take)
    st["got"] = st["got"] + take.to(_I32)


class Pipe(P.Program):
    """tests/test_stream.py `Pipe` on the port: node 0 streams
    0..K_PIPE-1 to node 1, which logs the deliveries in order."""

    def init(self, ctx):
        ctx.set_timer(0, T_PUMP, when=ctx.node == 0)
        ctx.set_timer(P.ms(15), T_RETX, when=ctx.node == 0)

    def on_timer(self, ctx, tag, payload):
        st = dict(ctx.state)
        is_pump = (tag == T_PUMP) & (ctx.node == 0)
        for _ in range(2):
            ok = tstream.send(ctx, st, 1, st["pushed"],
                              when=is_pump & (st["pushed"] < K_PIPE))
            st["pushed"] = st["pushed"] + ok.to(_I32)
        ctx.set_timer(P.ms(5), T_PUMP,
                      when=is_pump & (st["pushed"] < K_PIPE))
        is_retx = (tag == T_RETX) & (ctx.node == 0)
        tstream.retransmit(ctx, st, 1, when=is_retx)
        ctx.set_timer(P.ms(15), T_RETX, when=is_retx)
        ctx.state = st

    def on_message(self, ctx, src, tag, payload):
        st = dict(ctx.state)
        vals, mask = tstream.on_message(ctx, st, src, tag, payload)
        for i in range(W):
            take = mask[:, i] & (ctx.node == 1) & (st["got"] < K_PIPE)
            _log_into(st, take, vals[:, i], K_PIPE)
        ctx.halt_if((ctx.node == 1) & (st["got"] >= K_PIPE))
        ctx.state = st


def _conn_spec(n):
    z = torch.tensor(0, dtype=_I32)
    return dict(pushed=z, got=z.clone(), refused=z.clone(),
                established=z.clone(),
                rx_log=torch.full((K,), -1, dtype=_I32),
                **tconn.conn_state(n), **tstream.stream_state(n, window=W))


class Client(P.Program):
    """tests/test_conn.py `Client` on the port: node 0 connects to node 1
    and streams 0..K-1 over the connection; node 2 dials the
    non-listening node 0 and must be refused."""

    def init(self, ctx):
        st = dict(ctx.state)
        tconn.listen(ctx, st, when=ctx.node == 1)
        ctx.set_timer(P.ms(1), T_CONNECT,
                      when=(ctx.node == 0) | (ctx.node == 2))
        ctx.set_timer(P.ms(15), T_CRETX, when=ctx.node == 0)
        ctx.state = st

    def on_timer(self, ctx, tag, payload):
        st = dict(ctx.state)
        want = torch.where(ctx.node == 0, 1, 0).to(_I32)
        dialing = (tag == T_CONNECT) & ((ctx.node == 0) | (ctx.node == 2))
        tconn.connect(ctx, st, want, when=dialing)
        ctx.set_timer(P.ms(20), T_CONNECT,
                      when=dialing & ~tconn.is_established(st, want)
                      & (st["refused"] == 0))
        est = tconn.is_established(st, 1) & (ctx.node == 0)
        is_pump = ((tag == T_CPUMP) | (tag == T_CONNECT)) & est
        for _ in range(2):
            ok = tstream.send(ctx, st, 1, st["pushed"],
                              when=is_pump & (st["pushed"] < K))
            st["pushed"] = st["pushed"] + ok.to(_I32)
        ctx.set_timer(P.ms(5), T_CPUMP, when=is_pump & (st["pushed"] < K))
        is_retx = (tag == T_CRETX) & (ctx.node == 0)
        tstream.retransmit(ctx, st, 1, when=is_retx & est)
        ctx.set_timer(P.ms(15), T_CRETX, when=is_retx)
        ctx.state = st

    def on_message(self, ctx, src, tag, payload):
        st = dict(ctx.state)
        accepted, established, was_rst = tconn.on_message(ctx, st, src, tag,
                                                          payload)
        st["established"] = st["established"] + established.to(_I32)
        st["refused"] = st["refused"] + (was_rst & (ctx.node == 2)).to(_I32)
        vals, mask = tstream.on_message(ctx, st, src, tag, payload)
        for i in range(W):
            take = (mask[:, i] & (ctx.node == 1) & (st["got"] < K)
                    & (tconn.is_established(st, src)))
            _log_into(st, take, vals[:, i], K)
        ctx.halt_if((ctx.node == 1) & (st["got"] >= K))
        ctx.state = st


def _stream_rt(pkg, loss, clog):
    cfg = pkg.SimConfig(n_nodes=2, event_capacity=128,
                        time_limit=pkg.sec(30),
                        net=pkg.NetConfig(
                            packet_loss_rate=loss,
                            send_latency_min=pkg.ms(1),
                            send_latency_max=pkg.ms(10 if clog else 30)))
    sc = None
    if clog:
        sc = pkg.Scenario()
        sc.at(pkg.ms(20)).clog_link(0, 1)
        sc.at(pkg.ms(800)).unclog_link(0, 1)
    if pkg is P:
        return P.Runtime(cfg, [Pipe()], _pipe_spec(2), scenario=sc,
                         device="cpu")
    import test_stream
    return J.Runtime(cfg, [test_stream.Pipe()], test_stream.spec(2),
                     scenario=sc)


def _conn_rt(pkg, loss, _clog):
    cfg = pkg.SimConfig(n_nodes=3, event_capacity=128,
                        time_limit=pkg.sec(20),
                        net=pkg.NetConfig(packet_loss_rate=loss,
                                          send_latency_min=pkg.ms(1),
                                          send_latency_max=pkg.ms(10)))
    if pkg is P:
        return P.Runtime(cfg, [Client()], _conn_spec(3), device="cpu")
    import test_conn
    return J.Runtime(cfg, [test_conn.Client()], test_conn.spec(3))


# case: (builder, loss, clog, the reference's checks)
PROGRAM_CASES = {
    "stream_clean": (_stream_rt, 0.0, False),
    "stream_lossy_reorder": (_stream_rt, 0.3, False),
    "stream_through_clog": (_stream_rt, 0.0, True),
    "conn_handshake_data_refusal": (_conn_rt, 0.0, False),
    "conn_handshake_under_loss": (_conn_rt, 0.25, False),
}
SEEDS = np.arange(2, dtype=np.uint32)


def _program_reference(case):
    make, loss, clog = PROGRAM_CASES[case]
    with reference_stream():
        jrt = make(J, loss, clog)
        s, _ = jrt.run(jrt.init_batch(SEEDS), 60_000, 256)
        return {"ref": jax_leaves(s)}


@pytest.mark.parametrize("case", sorted(PROGRAM_CASES))
def test_program_over_the_layer_matches_reference(case):
    make, loss, clog = PROGRAM_CASES[case]
    ref = golden(MODULE, case)["ref"]
    rt = make(P, loss, clog)
    t, _ = rt.run(rt.init_batch(SEEDS), 60_000, 256)
    got = interop.state_to_numpy(t)
    assert_same(ref, got, what=case)
    assert got[".halted"].all() and not got[".crashed"].any()
    log = got[".node_state['rx_log']"][:, 1]
    k = K if case.startswith("conn") else K_PIPE
    assert (log == np.arange(k)).all()
    if case == "stream_lossy_reorder":
        assert got[".msg_dropped"].sum() > 0
    if case == "stream_through_clog":
        assert (got[".now"] > P.ms(800)).all()
    if case == "conn_handshake_data_refusal":
        ns = got
        assert (ns[".node_state['established']"][:, 0] == 1).all()
        assert (ns[".node_state['refused']"][:, 2] >= 1).all()
        assert (ns[".node_state['cn_state']"][:, 2, 0]
                == tconn.CLOSED).all()


# the recording against the JAX package (tests/_torch_golden.py)
REFERENCES = {case: (lambda c=case: _program_reference(c))
              for case in PROGRAM_CASES}


@pytest.mark.slow
@pytest.mark.parametrize("case", sorted(REFERENCES))
def test_golden_is_the_jax_packages_output(case):
    assert_golden_is_reference(MODULE, case, REFERENCES[case]())
