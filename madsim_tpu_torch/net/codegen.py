"""Schema -> service codegen: the madsim-tonic-build analog (the
counterpart of `madsim_tpu.net.codegen`; host-only, it emits a module
for this package).

The reference generates its client/server API from .proto files at build
time (madsim-tonic-build/src/server.rs:104-128 emits the server trait +
dispatch; client.rs the typed stubs). The state-machine analog consumes the
same proto3 *shape* — `message` word layouts and `service { rpc ... }`
blocks — and emits a Python module:

  - one `Layout` + pack/unpack converters per message (float fields ride
    int32 words by bitcast, utils/structs.py),
  - one `<Service>Base(Service)` class whose generated `@rpc` methods
    unpack the request, delegate to an abstract `handle_<method>`, and
    pack the reply (`@rpc_stream` stubs for streaming rpcs),
  - one typed client helper per method wrapping `net.rpc.call`.

Supported field scalars: one int32 word each — int32, uint32, sint32,
bool, float (bitcast). `repeated`/nested messages are rejected: payloads
are fixed-width word vectors (DESIGN §5 "bulk data" explains the stance);
ship fixed-size bursts as explicit fields or use the streaming fabric.

Inside a handler a payload is [B, payload_words], so the generated @rpc
wrappers unpack `payload[:, 1:]` and the client stubs' docstrings name
`payload[:, 0]` (the reference's `payload[1:]` and `payload[0]`, with
the lane axis in front); otherwise the output is the reference's with
the package name swapped.

Usage:
    python -m madsim_tpu_torch.net.codegen schema.proto -o schema_pb.py
or  source = generate(open("schema.proto").read())
"""

from __future__ import annotations

import re

_WORD_TYPES = ("int32", "uint32", "sint32", "bool", "float")


def _strip_comments(text: str) -> str:
    text = re.sub(r"//[^\n]*", "", text)
    return re.sub(r"/\*.*?\*/", "", text, flags=re.S)


def _snake(name: str) -> str:
    s = re.sub(r"(?<=[a-z0-9])(?=[A-Z])", "_", name)
    return s.lower()


def _blocks(text: str, kw: str):
    """Brace-balanced `kw Name { body }` blocks. Balanced extraction (not
    a [^{}]* regex) so a nested brace is SEEN and rejected by the caller
    instead of silently un-matching the whole block."""
    for m in re.finditer(rf"\b{kw}\s+(\w+)\s*\{{", text):
        depth, i = 1, m.end()
        while depth:
            assert i < len(text), f"unbalanced braces in {kw} {m.group(1)}"
            depth += (text[i] == "{") - (text[i] == "}")
            i += 1
        yield m.group(1), text[m.end():i - 1]


def parse(text: str):
    """-> (messages, services); messages: {name: [(type, field)...]},
    services: {name: [(method, req, req_stream, rsp, rsp_stream)...]}."""
    text = _strip_comments(text)
    messages, services = {}, {}
    for name, body in _blocks(text, "message"):
        assert "{" not in body, (
            f"message {name}: nested messages are unsupported — payloads "
            "are flat fixed-width word vectors")
        fields = []
        assert name not in messages, f"duplicate message {name}"
        seen_nums = set()
        for line in filter(None, (s.strip() for s in body.split(";"))):
            fm = re.match(r"(repeated\s+)?(\w+)\s+(\w+)\s*=\s*(\d+)$", line)
            assert fm, f"unparseable field in message {name}: {line!r}"
            fnum = int(fm.group(4))
            assert fnum not in seen_nums, (
                f"message {name}: duplicate field number {fnum}")
            seen_nums.add(fnum)
            assert not fm.group(1), (
                f"{name}.{fm.group(3)}: repeated fields are unsupported — "
                "payloads are fixed-width word vectors; use explicit "
                "fields or the streaming fabric")
            ftype = fm.group(2)
            assert ftype in _WORD_TYPES, (
                f"{name}.{fm.group(3)}: type {ftype!r} unsupported "
                f"(one-word scalars only: {_WORD_TYPES})")
            fields.append((ftype, fm.group(3)))
        messages[name] = fields
    for name, body in _blocks(text, "service"):
        assert name not in services, f"duplicate service {name}"
        assert "{" not in body, (
            f"service {name}: rpc options blocks ('rpc ... {{}}') are "
            "unsupported — end each rpc with ';'")
        rpcs = []
        for rm in re.finditer(
                r"rpc\s+(\w+)\s*\(\s*(stream\s+)?(\w+)\s*\)\s*"
                r"returns\s*\(\s*(stream\s+)?(\w+)\s*\)", body):
            meth, req_s, req, rsp_s, rsp = rm.groups()
            assert req in messages, f"{name}.{meth}: unknown message {req}"
            assert rsp in messages, f"{name}.{meth}: unknown message {rsp}"
            assert meth not in (r[0] for r in rpcs), (
                f"service {name}: duplicate rpc {meth} — the generated "
                "class would silently shadow the first definition")
            rpcs.append((meth, req, bool(req_s), rsp, bool(rsp_s)))
        services[name] = rpcs
    return messages, services


def _const(name: str) -> str:
    return _snake(name).upper()


def _emit_message(name, fields, out):
    names = ", ".join(repr(f) for _, f in fields)
    floats = [f for t, f in fields if t == "float"]
    out.append(f"{_const(name)} = Layout({names})")
    out.append(f"def pack_{_snake(name)}(**fields):")
    for f in floats:
        out.append(f"    if {f!r} in fields:"
                   f" fields[{f!r}] = f32_to_word(fields[{f!r}])")
    out.append(f"    return {_const(name)}.pack(**fields)")
    out.append(f"def unpack_{_snake(name)}(words):")
    out.append(f"    d = {_const(name)}.unpack(words)")
    for f in floats:
        out.append(f"    d[{f!r}] = word_to_f32(d[{f!r}])")
    out.append("    return d")
    out.append("")


def _emit_service(name, rpcs, out):
    base = f"{name}Base"
    out.append(f"class {base}(Service):")
    out.append(f'    """Override each handle_* (server half); the @rpc')
    out.append("    wrappers do the unpack/dispatch/pack plumbing.\"\"\"")
    for meth, req, req_s, rsp, rsp_s in rpcs:
        h = f"handle_{_snake(meth)}"
        if req_s or rsp_s:
            out.append("    @rpc_stream")
            out.append(f"    def {meth}(self, ctx, st, src, kind, call_id,"
                       " body, when):")
            out.append(f"        self.{h}(ctx, st, src, kind, call_id,"
                       " body, when)")
            out.append(f"    def {h}(self, ctx, st, src, kind, call_id,"
                       " body, when):")
            out.append(f"        raise NotImplementedError({h!r})")
        else:
            out.append("    @rpc")
            out.append(f"    def {meth}(self, ctx, st, payload, when):")
            out.append(f"        req = unpack_{_snake(req)}(payload[:, 1:])")
            out.append(f"        rsp = self.{h}(ctx, st, req, when)")
            out.append(f"        return pack_{_snake(rsp)}(**rsp)")
            out.append(f"    def {h}(self, ctx, st, req, when):")
            out.append(f"        raise NotImplementedError({h!r})")
    out.append("")
    for meth, req, req_s, rsp, rsp_s in rpcs:
        if req_s or rsp_s:
            continue  # stream calls go through net.streaming directly
        out.append(f"def {_snake(name)}_{_snake(meth)}(ctx, dst, call_id,"
                   " *, retry_timer_tag, timeout, when=True, **fields):")
        out.append(f'    """Typed client stub: {name}.{meth}({req}) ->'
                   f" {rsp}. Reply arrives tagged"
                   f" reply_tag({base}.{meth}.tag) with payload[:, 0] ="
                   ' call_id, body unpacked by'
                   f' unpack_{_snake(rsp)}(payload[:, 1:])."""')
        out.append(f"    _rpc.call(ctx, dst, {base}.{meth}.tag,"
                   f" pack_{_snake(req)}(**fields), call_id,")
        out.append("              retry_timer_tag=retry_timer_tag,"
                   " timeout=timeout, when=when)")
    out.append("")


def generate(text: str) -> str:
    """Proto3-subset schema text -> Python module source."""
    messages, services = parse(text)
    out = [
        '"""Generated by madsim_tpu_torch.net.codegen — DO NOT EDIT."""',
        "from madsim_tpu_torch.net import rpc as _rpc",
        "from madsim_tpu_torch.net.service import Service, rpc, rpc_stream",
        "from madsim_tpu_torch.utils.structs import (Layout, f32_to_word,",
        "                                      word_to_f32)",
        "",
    ]
    for name, fields in messages.items():
        _emit_message(name, fields, out)
    for name, rpcs in services.items():
        _emit_service(name, rpcs, out)
    return "\n".join(out) + "\n"


def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser(
        description="Generate a madsim_tpu_torch service module from a "
                    "proto3-subset schema (the tonic-build analog).")
    ap.add_argument("schema")
    ap.add_argument("-o", "--out", required=True)
    args = ap.parse_args(argv)
    with open(args.schema) as f:
        src = generate(f.read())
    with open(args.out, "w") as f:
        f.write(src)
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
