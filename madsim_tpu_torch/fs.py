"""Simulated per-node filesystem with sync-gated durability (the
counterpart of `madsim_tpu.fs`, the FsSim analog with power-fail
semantics).

Every file exists twice in a node's protocol state,

  fs_mem  — the page-cache view: all writes land here; reads see them
  fs_disk — the durable view: updated ONLY by sync_all

and only `fs_disk`/`fs_dlen` go in the persist mask. A kill drops the
memory view (the engine resets volatile leaves), and `mount()` in the
program's init restores it from disk, so a write that was not synced
before the kill is gone. The engine's torn-write kill flush
(`ops/apply_super.py` `_torn_flush`) acts on these four leaves.

Inside a handler every leaf carries the lane axis: files are
[B, n_files, file_words] int32, lengths [B, n_files]. A file id is a
static int or a [B] tensor; offsets and lengths are ints or [B] tensors;
`when` is a bool or a [B] mask. Every helper is masked, as in the JAX
package, and updates the state dict by reassigning its leaves.
"""

from __future__ import annotations

import torch

from .core.api import _lanes
from .ops.select import put_row, take_row

__all__ = ["fs_state", "fs_persist", "mount", "read_at", "write_all_at",
           "set_len", "sync_all", "file_len"]

_I32 = torch.int32


def fs_state(n_files: int, file_words: int):
    """State-schema fragment: merge into your Program's state_spec."""
    F, S = n_files, file_words
    return dict(
        fs_mem=torch.zeros((F, S), dtype=_I32),
        fs_mlen=torch.zeros((F,), dtype=_I32),
        fs_disk=torch.zeros((F, S), dtype=_I32),
        fs_dlen=torch.zeros((F,), dtype=_I32),
    )


def fs_persist():
    """Persist-mask fragment: ONLY the disk view survives kill/restart."""
    return dict(fs_mem=False, fs_mlen=False, fs_disk=True, fs_dlen=True)


def _lane(x, like: torch.Tensor, dtype=_I32) -> torch.Tensor:
    """A per-lane [B] operand from an int, a bool or a [B] tensor."""
    return _lanes(x, like.shape[0], dtype, like.device)


def _mask(when, like: torch.Tensor) -> torch.Tensor:
    return _lane(when, like, torch.bool)


def mount(st, *, when=True):
    """Rebuild the memory view from disk — call in Program.init. After a
    power-fail this is where unsynced writes are observably absent."""
    w = _mask(when, st["fs_mem"])
    st["fs_mem"] = torch.where(w[:, None, None], st["fs_disk"],
                               st["fs_mem"])
    st["fs_mlen"] = torch.where(w[:, None], st["fs_dlen"], st["fs_mlen"])


def file_len(st, f):
    """Current (memory-view) length in words, [B]."""
    return take_row(st["fs_mlen"], _lane(f, st["fs_mlen"]))


def read_at(st, f, offset, width: int):
    """Read `width` words at `offset` (static width, dynamic offset) from
    the memory view — reads observe unsynced writes, as with a page
    cache. Words beyond the file length read as 0. Returns [B, width]."""
    mem = st["fs_mem"]
    S = mem.shape[2]
    f = _lane(f, mem)
    row = take_row(mem, f)                                  # [B, S]
    idx = (_lane(offset, mem)[:, None]
           + torch.arange(width, dtype=_I32, device=mem.device))
    vals = torch.gather(row, 1, torch.clamp(idx, 0, S - 1).to(torch.int64))
    mlen = take_row(st["fs_mlen"], f)
    return torch.where((idx < mlen[:, None]) & (idx < S), vals,
                       torch.zeros_like(vals))


def write_all_at(st, f, offset, words, *, when=True):
    """Write a word vector ([B, width] tensor, or a list of per-lane
    words) at `offset` into the MEMORY view: durable only after sync_all.
    Returns the ok mask [B] (False if the write would overrun the fixed
    file capacity — the disk-full analog)."""
    mem = st["fs_mem"]
    S = mem.shape[2]
    if isinstance(words, (list, tuple)):
        words = torch.stack([_lane(x, mem) for x in words], -1)
    words = words.to(_I32)
    width = words.shape[-1]
    f = _lane(f, mem)
    offset = _lane(offset, mem)
    ok = _mask(when, mem) & (offset >= 0) & (offset + width <= S)
    row = take_row(mem, f)                                  # [B, S]
    idx = torch.clamp(offset[:, None]
                      + torch.arange(width, dtype=_I32, device=mem.device),
                      0, S - 1).to(torch.int64)
    new_row = row.scatter(1, idx, torch.where(ok[:, None], words,
                                              torch.gather(row, 1, idx)))
    st["fs_mem"] = put_row(mem, f, new_row, ok)
    mlen = take_row(st["fs_mlen"], f)
    st["fs_mlen"] = put_row(st["fs_mlen"], f,
                            torch.maximum(mlen, offset + width), ok)
    return ok


def set_len(st, f, new_len, *, when=True):
    """Truncate/extend the memory view: shrinking zeroes the dropped
    words, growing zero-fills — both only durable after sync_all."""
    mem = st["fs_mem"]
    S = mem.shape[2]
    f = _lane(f, mem)
    new_len = torch.clamp(_lane(new_len, mem), 0, S)
    w = _mask(when, mem)
    ks = torch.arange(S, dtype=_I32, device=mem.device)
    row = take_row(mem, f)
    st["fs_mem"] = put_row(mem, f, torch.where(ks >= new_len[:, None],
                                               torch.zeros_like(row), row),
                           w)
    st["fs_mlen"] = put_row(st["fs_mlen"], f, new_len, w)


def sync_all(st, f, *, when=True):
    """Flush file `f`: disk view := memory view. The ONLY operation that
    makes writes survive a power-fail."""
    f = _lane(f, st["fs_mem"])
    w = _mask(when, st["fs_mem"])
    st["fs_disk"] = put_row(st["fs_disk"], f, take_row(st["fs_mem"], f), w)
    st["fs_dlen"] = put_row(st["fs_dlen"], f, take_row(st["fs_mlen"], f), w)
