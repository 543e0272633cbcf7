"""Slot-addressed helpers for constant-size decode states (port of
``repro.core.slotted``).

The recurrent serving backends (`repro_torch.serve.backends.recurrent`)
keep one state per model whose leaves are stacked ``[L, S, ...]``: layer
axis first, request-slot axis second.  A state is a NamedTuple of tensors,
possibly nested (the hybrid's super-block state holds two RG-LRU states
and an attention cache).  A slot is an index: the scheduler's pages are
admission-control currency only.

  * a slot's state is touched only through its slot index;
  * `zero_slot` at admission gives chunked prefill a clean accumulator;
  * `where_slots` keeps a row's state bit-identical where its mask is
    False (a chunk row shorter than the chunk, an idle slot) — the
    property that recompute-from-prompt preemption rests on.

Where the reference returns new arrays, `zero_slot`, `set_slot` and
`scatter_slots` write in place (and return the state); `where_slots` and
`gather_slots` return new tensors; `write_slots` is the in-place form of
``dst = where_slots(commit, new, dst)``.
"""

from __future__ import annotations

from typing import Any, Callable

import torch


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """Apply ``fn`` leaf by leaf over NamedTuples (nested) of tensors."""
    if isinstance(tree, torch.Tensor):
        return fn(tree, *rest)
    return type(tree)(*(tree_map(fn, *xs) for xs in zip(tree, *rest)))


def tree_leaves(tree: Any) -> list:
    if isinstance(tree, torch.Tensor):
        return [tree]
    return [leaf for x in tree for leaf in tree_leaves(x)]


def where_slots(mask: torch.Tensor, new: Any, old: Any, axis: int = 0) -> Any:
    """Per-slot select between two states.  ``mask``: [S] bool over the slot
    axis of every leaf (axis 0 inside a per-layer body, axis 1 on a whole
    stacked state); scalar-per-slot leaves (a slot cache's ``t`` [S])
    work unchanged."""

    def sel(a, b):
        m = mask.reshape((1,) * axis + (-1,) + (1,) * (a.dim() - axis - 1))
        return torch.where(m, a, b)

    return tree_map(sel, new, old)


def write_slots(dst: Any, new: Any, commit=None) -> None:
    """Write ``new`` into the state ``dst`` in place, slot by slot where
    ``commit`` [S] (axis 0) is True; None writes every slot.  The other
    slots keep their bits."""
    for a, b in zip(tree_leaves(dst), tree_leaves(new)):
        a.copy_(b if commit is None else where_slots(commit, b, a))


def zero_slot(states: Any, slot: int) -> Any:
    """Zero one slot across every leaf of a stacked [L, S, ...] state."""
    for a in tree_leaves(states):
        a[:, slot].zero_()
    return states


def set_slot(states: Any, sub: Any, slot: int) -> Any:
    """Write a single-request state (leaves [L, 1, ...]) into ``slot``."""
    for a, b in zip(tree_leaves(states), tree_leaves(sub)):
        a[:, slot] = b[:, 0]
    return states


def gather_slots(states: Any, ids: torch.Tensor) -> Any:
    """A row-packed copy ([L, P, ...]) of the slots ``ids`` [P]."""
    return tree_map(lambda a: a[:, ids.long()], states)


def scatter_slots(states: Any, ids: torch.Tensor, sub: Any) -> Any:
    """Scatter a row-packed sub-state back, in place; ``ids`` must be
    unique (the engine pads prefill rows with distinct idle slots)."""
    idx = ids.long()
    for a, b in zip(tree_leaves(states), tree_leaves(sub)):
        a[:, idx] = b
    return states
