"""Batched selection primitives for the event engine.

The counterparts of `madsim_tpu.ops.select`, written for an explicit
leading lane axis: a per-lane vector is `[B, n]`, a per-lane scalar `[B]`.
madsim's scheduler structures (the random-pop ready queue of
mpsc.rs:75-85 and the earliest-deadline timer heap of time/mod.rs:41-56)
become masked reductions over each lane's event table.

The JAX package writes gathers and scatters as one-hot masked sums
because a TPU serialises an indexed gather per element; on a GPU an
indexed load is cheap, so these are plain `gather`/`where` with the same
values. Reads (`take1`, `take_row`) clamp their index into range: the JAX
forms require pre-clipped indices too (there an out-of-range read gives
0), and every caller clips. Writes (`put_row`) to an out-of-range index
write nothing, as in the JAX form.
"""

from __future__ import annotations

import torch

from ..core import prng


def masked_choice(key: torch.Tensor, mask: torch.Tensor):
    """Uniformly random True index of `mask` [..., C], one per key [..., 2].

    Returns (idx int32 [...], valid bool [...]); idx is 0 where no entry is
    set. The draw is `randint(key, 0, max(count, 1))` and the pick the first
    row whose inclusive prefix count equals draw + 1, as in the JAX form.
    """
    m = mask.to(torch.int32)
    cnt = m.sum(-1, dtype=torch.int32)
    r = prng.randint_raw(key, 0, torch.clamp(cnt, min=1))
    cum = torch.cumsum(m, -1, dtype=torch.int32)
    idx = torch.argmax((cum == (r + 1).unsqueeze(-1)).to(torch.int8), -1)
    return idx.to(torch.int32), cnt > 0


def min_deadline(deadlines: torch.Tensor, eligible: torch.Tensor, inf):
    """Earliest eligible deadline per lane and its tie mask.

    Returns (dmin int32 [...], at_min bool [..., C], any_eligible bool [...]).
    """
    masked = torch.where(eligible, deadlines, torch.full_like(deadlines, inf))
    dmin = masked.min(-1).values
    at_min = eligible & (deadlines == dmin.unsqueeze(-1))
    return dmin, at_min, dmin < inf


def take1(vec: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """`vec[idx]` per lane: `vec` is a per-lane table [B, n] (or a table
    shared by every lane, [n]) and `idx` an integer tensor [B, ...] of
    in-range indices (clamped)."""
    safe = idx.to(torch.int64).clamp(0, vec.shape[-1] - 1)
    if vec.ndim == 1:
        return vec[safe]
    flat = safe.reshape(safe.shape[0], -1)
    return torch.gather(vec, 1, flat).reshape(idx.shape)


def row_onehot(n: int, idx: torch.Tensor) -> torch.Tensor:
    """bool [B, n], True at `idx` [B] (all False where out of range)."""
    return torch.arange(n, dtype=idx.dtype, device=idx.device) \
        == idx.unsqueeze(-1)


def take_row(mat: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """`mat[idx]` per lane for mat [B, R, ...] and in-range idx [B] (clamped)
    -> [B, ...]."""
    i = idx.to(torch.int64).clamp(0, mat.shape[1] - 1)
    return mat[torch.arange(mat.shape[0], device=mat.device), i]


def put_row(mat: torch.Tensor, idx: torch.Tensor, val, mask=True
            ) -> torch.Tensor:
    """`mat.at[idx].set(val)` per lane where `mask` holds.

    mat [B, R, ...]; idx [B]; val is one row per lane ([B, ...]), a 0-d
    tensor or a Python scalar; mask is a [B] tensor or a Python bool. An
    out-of-range idx writes nothing.
    """
    if mask is False:
        return mat
    oh = row_onehot(mat.shape[1], idx)
    if mask is not True:
        oh = oh & mask.unsqueeze(-1)
    oh = oh.reshape(oh.shape + (1,) * (mat.ndim - 2))
    if isinstance(val, torch.Tensor):
        val = val.to(mat.dtype)
        if val.ndim:
            val = val.unsqueeze(1)
    return torch.where(oh, val, mat)


def first_k_free(free_mask: torch.Tensor, k: int):
    """Indices of the first k free slots per lane (stable by index).

    free_mask bool [B, C] -> (slots int32 [B, k], ok bool [B, k]); ok[j] is
    False when fewer than j+1 slots are free, and such rows return slot 0.
    Each free slot's index is scattered into its rank row (the JAX
    package's `scatter=True` lowering; both lowerings give these values).
    """
    B, C = free_mask.shape
    pos = torch.cumsum(free_mask.to(torch.int32), -1, dtype=torch.int32)
    rank = (pos - 1).to(torch.int64)
    dst = torch.where(free_mask & (rank < k), rank, torch.full_like(rank, k))
    src = torch.arange(C, dtype=torch.int32, device=free_mask.device)
    slots = torch.zeros((B, k + 1), dtype=torch.int32,
                        device=free_mask.device)
    slots.scatter_(1, dst, src.expand(B, C))
    ok = torch.arange(1, k + 1, dtype=torch.int32,
                      device=free_mask.device) <= pos[:, -1:]
    return slots[:, :k].contiguous(), ok


def row_at(mat: torch.Tensor, idx) -> torch.Tensor:
    """`mat[idx]` per lane for mat [B, R, ...]: `idx` a Python int (the
    same row in every lane) or a [B] tensor (clamped, as `take_row`)."""
    if isinstance(idx, torch.Tensor):
        return take_row(mat, idx)
    return mat[:, idx]


def put_at(mat: torch.Tensor, idx, val, mask=True) -> torch.Tensor:
    """`mat.at[idx].set(val)` per lane where `mask` holds, for `idx` a
    Python int or a [B] tensor (`put_row`). A new tensor; `mat` is left
    as it was."""
    if isinstance(idx, torch.Tensor):
        return put_row(mat, idx, val, mask)
    if mask is False or not 0 <= idx < mat.shape[1]:
        return mat
    old = mat[:, idx]
    # a host value stays a scalar operand: a tensor made from it would be
    # a host-to-device copy, which a CUDA-graph capture refuses
    new = val.to(mat.dtype) if isinstance(val, torch.Tensor) else val
    if mask is not True:
        new = torch.where(mask.reshape(mask.shape + (1,) * (old.ndim - 1)),
                          new, old)
    elif not isinstance(new, torch.Tensor):
        new = torch.full_like(old, new)
    out = mat.clone()
    out[:, idx] = new
    return out
