"""Gradients of a loss over a batch, whole or in consecutive shares: what
the train steps (`launch.steps`) and the compressed data-parallel step
(`optim.compression`) take before their update.
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.device import cpu_log_ready
from repro_torch.optim.adamw import tree_leaves, tree_map


def value_and_grads(loss_fn: Callable, params, batch):
    """(loss, grads) of ``loss_fn(params, batch)``: grads a tree like
    ``params`` in the parameters' dtype (zeros for a leaf the loss does
    not reach)."""
    p = tree_map(lambda t: t.detach().requires_grad_(), params)
    leaves = tree_leaves(p)
    loss = loss_fn(p, batch)
    got = torch.autograd.grad(loss, leaves, allow_unused=True)
    by_id = {id(x): torch.zeros_like(x) if g is None else g
             for x, g in zip(leaves, got)}
    return loss.detach(), tree_map(lambda t: by_id[id(t)], p)


def batch_share(batch: dict, n: int, i: int) -> dict:
    """Share ``i`` of ``n`` consecutive shares of every batch entry's rows
    (numpy arrays or tensors, leading axis the batch)."""
    out = {}
    for k, v in batch.items():
        if len(v) % n:
            raise ValueError(f"batch {k!r} of {len(v)} rows does not split "
                             f"into {n} shares")
        size = len(v) // n
        out[k] = v[i * size:(i + 1) * size]
    return out


def accumulate_grads(params, batch: dict, loss_fn: Callable,
                     microbatch: int = 1):
    """(loss, grads) of ``batch`` (numpy arrays or tensors, leading axis
    the batch).  With ``microbatch`` A > 1 the batch is split into A
    consecutive slices, as the reference's reshape to [A, B / A, ...]
    does; each slice's backward runs before the next forward (its
    activations are freed), the float32 gradients are summed in slice
    order and divided by A, and the loss is the mean of the slices'
    losses."""
    if tree_leaves(params)[0].device.type == "cpu":
        cpu_log_ready()
    if microbatch == 1:
        return value_and_grads(loss_fn, params, batch)
    if len(next(iter(batch.values()))) % microbatch:
        raise ValueError("microbatch must divide global batch")
    grads = tree_map(lambda t: torch.zeros(t.shape, dtype=torch.float32,
                                           device=t.device), params)
    loss = 0.0
    for i in range(microbatch):
        li, gi = value_and_grads(loss_fn, params,
                                 batch_share(batch, microbatch, i))
        grads = tree_map(torch.add, grads, gi)
        loss = loss + li
    div = torch.tensor(float(microbatch), dtype=torch.float32,
                       device=loss.device)
    return loss / div, tree_map(lambda g: g / div, grads)


__all__ = ["value_and_grads", "batch_share", "accumulate_grads"]
