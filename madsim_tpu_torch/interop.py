"""Carry simulation state between this package and the JAX package.

A state crosses as a flat dict of numpy arrays keyed by the JAX package's
leaf paths (`jax.tree_util.keystr` of the `SimState` pytree): `.now`,
`.key`, `.node_state['seq']`, `.ext['power']['level']`, ... Arrays carry
the JAX dtypes (uint32 for keys and hashes) and a leading [B] lane axis.
Nothing here imports JAX: a caller on the JAX side hands over
`np.asarray` leaves, and gets numpy leaves back.

Knob batches of the fuzzer (`search/mutate.py`) cross the same way: a
dict of numpy arrays keyed by knob name (the JAX package's knob batches
and corpus entries as they are) becomes a dict of tensors with
`knobs_to_torch`, and back with `knobs_to_numpy`. Knobs carry no uint32
field, so dtypes map one to one.

`leaf_digests` reproduces the per-leaf sha256 encoding of the frozen
golden files (`tests/_grayfail_golden.py`: f"{shape}|{dtype}|" followed
by the array bytes), so a state of this package can be held against the
recorded digests directly.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch

from .core.state import U32_FIELDS, SimState


def _flatten(prefix: str, tree, out: dict) -> None:
    if isinstance(tree, dict):
        for k in sorted(tree):
            _flatten(f"{prefix}[{k!r}]", tree[k], out)
    else:
        out[prefix] = tree


def state_leaves(state: SimState) -> dict:
    """{path: tensor} in jax's flatten order (fields in declaration order,
    dict keys sorted)."""
    out: dict = {}
    for f in SimState.field_names():
        _flatten(f".{f}", getattr(state, f), out)
    return out


def _u32(path: str) -> bool:
    return path[1:].split("[", 1)[0] in U32_FIELDS


def _to_numpy(path: str, t: torch.Tensor) -> np.ndarray:
    a = t.detach().cpu().numpy()
    if _u32(path):
        a = a.view(np.uint32)
    return a


def leaf_dtype(path: str, t: torch.Tensor) -> np.dtype:
    """The numpy dtype leaf `path` (held in `t`) exports with, read from
    the tensor's dtype alone (no copy)."""
    if _u32(path):
        return np.dtype(np.uint32)
    return torch.empty(0, dtype=t.dtype).numpy().dtype


def state_to_numpy(state: SimState) -> dict:
    """{leaf path: numpy array} with the JAX package's dtypes."""
    return {p: _to_numpy(p, t) for p, t in state_leaves(state).items()}


def _parse(path: str):
    """'.node_state['seq']' -> ('node_state', ['seq'])."""
    if not path.startswith("."):
        raise ValueError(f"not a SimState leaf path: {path!r}")
    field, _, rest = path[1:].partition("[")
    keys = []
    if rest:
        for part in ("[" + rest).split("]")[:-1]:
            k = part[1:]
            if len(k) < 2 or k[0] != k[-1] or k[0] not in "'\"":
                raise ValueError(f"unsupported leaf path: {path!r}")
            keys.append(k[1:-1])
    return field, keys


def state_from_numpy(leaves: dict, device) -> SimState:
    """The port's SimState from JAX-exported leaves (see module doc).
    Every SimState field must be present; uint32 leaves become int32
    tensors with the same bits."""
    fields: dict = {}
    for path, arr in leaves.items():
        field, keys = _parse(path)
        a = np.asarray(arr)
        if a.dtype == np.uint32:
            a = a.view(np.int32)
        t = torch.as_tensor(np.ascontiguousarray(a), device=device)
        if not keys:
            fields[field] = t
            continue
        node = fields.setdefault(field, {})
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = t
    fields.setdefault("ext", {})
    missing = [f for f in SimState.field_names() if f not in fields]
    if missing:
        raise ValueError(f"state_from_numpy: missing leaves {missing}")
    unknown = set(fields) - set(SimState.field_names())
    if unknown:
        raise ValueError(f"state_from_numpy: unknown fields "
                         f"{sorted(unknown)}")
    return SimState(**fields)


def digest(a: np.ndarray) -> str:
    """sha256 of f"{shape}|{dtype}|" + bytes (the golden-file encoding)."""
    h = hashlib.sha256()
    h.update(f"{a.shape}|{a.dtype}|".encode())
    h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


def leaf_digests(state: SimState) -> dict:
    """{leaf path: sha256} over a batched state."""
    return {p: digest(a) for p, a in state_to_numpy(state).items()}


def knobs_to_torch(knobs: dict, device) -> dict:
    """{knob: tensor on `device`} from numpy arrays, scalars or tensors."""
    out = {}
    for k, v in knobs.items():
        if isinstance(v, torch.Tensor):
            out[k] = v.to(device).contiguous()
        else:
            out[k] = torch.as_tensor(np.ascontiguousarray(np.asarray(v)),
                                     device=device)
    return out


def knobs_to_numpy(knobs: dict) -> dict:
    """{knob: numpy array} from tensors (on any device) or arrays."""
    return {k: v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
            else np.asarray(v) for k, v in knobs.items()}
