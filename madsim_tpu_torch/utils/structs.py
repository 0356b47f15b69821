"""Payload word-layout helpers (the counterpart of
`madsim_tpu.utils.structs`).

Messages are fixed int32 word vectors; protocols read and write fixed
positions, and these helpers keep the positions named and let float32
values ride int32 words by BITCAST, never by rounding:

    L = Layout("term", "prev", "commit")
    ctx.send(dst, AE, L.pack(term=st["term"], prev=nxt, commit=c))
    ...
    term = payload[:, L.term]       # named index, a plain int

Inside a handler every word carries the lane axis: `pack` returns a list
of per-lane words (or host ints, which `Ctx.send` broadcasts), and
`unpack` takes a [B, k] payload (or any tensor whose last axis is the
word axis).
"""

from __future__ import annotations

import torch


class Layout:
    """Named word positions for a payload. Attribute access returns the
    word index; `pack` builds the word list in declaration order."""

    def __init__(self, *names: str):
        assert len(set(names)) == len(names), f"duplicate fields: {names}"
        self._names = names
        for i, n in enumerate(names):
            assert not hasattr(self, n), f"reserved field name: {n}"
            setattr(self, n, i)

    @property
    def width(self) -> int:
        return len(self._names)

    def pack(self, **fields):
        """Word list in declaration order; missing fields are 0. A tensor
        field becomes int32; a host value stays as it is."""
        unknown = set(fields) - set(self._names)
        assert not unknown, f"unknown payload fields: {sorted(unknown)}"
        out = []
        for n in self._names:
            v = fields.get(n, 0)
            out.append(v.to(torch.int32) if isinstance(v, torch.Tensor)
                       else int(v))
        return out

    def unpack(self, payload):
        """dict of field -> word: the payload's last axis is the word
        axis (positions beyond it are absent by construction: as_payload
        zero-pads to cfg.payload_words)."""
        return {n: payload[..., i] for i, n in enumerate(self._names)}


def f32_to_word(x):
    """Bitcast a float32 value into an int32 payload word (lossless)."""
    return torch.as_tensor(x, dtype=torch.float32).view(torch.int32)


def word_to_f32(w):
    """Recover the float32 from its payload word."""
    return torch.as_tensor(w, dtype=torch.int32).view(torch.float32)
