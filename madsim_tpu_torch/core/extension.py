"""Extensions: the pluggable-simulator framework (madsim plugin.rs analog).

An Extension contributes its own per-lane state subtree (`SimState.ext`),
handlers for custom supervisor opcodes (op >= OP_USER, schedulable from a
Scenario like any built-in fault op) and an optional hook observing every
dispatched event. All hooks receive batched [B, ...] tensors, like the
handlers of `core.api.Program`.
"""

from __future__ import annotations

from typing import Any

# user opcode space: built-ins stay below, extensions at or above
OP_USER = 100


class Extension:
    """Subclass and register via Runtime(extensions=[...])."""

    #: unique key; also the SimState.ext dict key
    name: str = "extension"

    def state(self, cfg) -> Any:
        """Default per-lane state subtree: a dict of tensors WITHOUT the
        lane axis (the runtime broadcasts it over the batch)."""
        return {}

    def on_op(self, cfg, sub, op, target, src, payload, key):
        """Handle a custom supervisor op (called for every step; check `op`
        [B] against your opcodes with masked updates). Returns the updated
        subtree. `key` is a per-lane PRNG key [B, 2]."""
        return sub

    def on_event(self, cfg, sub, state, record) -> Any:
        """Observe every dispatched event (record: now/kind/node/src/tag/
        payload/fired, each [B, ...]). Masked no-op where fired is False."""
        return sub

    def reset_node(self, cfg, sub, node, when):
        """A node was killed or (re)booted, where `when` [B] holds."""
        return sub


def build_ext_state(cfg, extensions) -> dict:
    names = [e.name for e in extensions]
    assert len(set(names)) == len(names), f"duplicate extension names {names}"
    return {e.name: e.state(cfg) for e in extensions}
