"""AdamW and its schedule (port of ``repro.optim.adamw``).

Optimizer state mirrors the parameter tree: float32 moments (master
precision even where parameters are bf16) and an int32 step.  The
arithmetic is the reference's, in its order and dtypes: the schedule and
the bias corrections are float32 tensors on the parameters' device (a
Python float divisor would let the card multiply by its reciprocal), the
global norm sums per-leaf float32 sums of squares over the leaves in
sorted key order (``jax.tree.leaves``' order), and weight decay applies to
every leaf.  The update is functional: it returns new tensors and leaves
its inputs as they were.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, NamedTuple

import torch


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


class AdamWState(NamedTuple):
    mu: Any
    nu: Any
    step: torch.Tensor      # int32 scalar


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` leaf by leaf over nested dicts of tensors (the parameter
    trees of every family), keeping ``tree``'s key order."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def tree_leaves(tree: Any) -> list:
    """Leaves of nested dicts in sorted key order, as ``jax.tree.leaves``
    orders a dict."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=like.device)


def adamw_init(params) -> AdamWState:
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,  # noqa: E731
                                  device=p.device)
    dev = tree_leaves(params)[0].device
    return AdamWState(mu=tree_map(zeros, params), nu=tree_map(zeros, params),
                      step=torch.zeros((), dtype=torch.int32, device=dev))


def cosine_schedule(step: torch.Tensor, cfg: OptConfig) -> torch.Tensor:
    """Linear warmup, then cosine decay to ``min_lr_ratio * lr``; a float32
    scalar on ``step``'s device."""
    s = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp(s / _f32(max(cfg.warmup_steps, 1), s), max=1.0)
    frac = torch.clamp((s - cfg.warmup_steps)
                       / _f32(max(cfg.total_steps - cfg.warmup_steps, 1), s),
                       0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * frac))
    return cfg.lr * warm * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos)


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32)))
                          for x in tree_leaves(tree)))


def clip_by_global_norm(grads, max_norm: float):
    gn = global_norm(grads)
    scale = torch.clamp(_f32(max_norm, gn) / torch.clamp(gn, min=1e-9),
                        max=1.0)
    return tree_map(lambda g: g * scale, grads), gn


@torch.no_grad()
def adamw_update(grads, state: AdamWState, params, cfg: OptConfig):
    """Returns (new_params, new_state, metrics {"lr", "grad_norm"})."""
    grads = tree_map(lambda g: g.to(torch.float32), grads)
    grads, gnorm = clip_by_global_norm(grads, cfg.clip_norm)
    step = state.step + 1
    lr = cosine_schedule(step, cfg)
    b1, b2 = cfg.b1, cfg.b2

    mu = tree_map(lambda m, g: b1 * m + (1 - b1) * g, state.mu, grads)
    nu = tree_map(lambda n, g: b2 * n + (1 - b2) * g * g, state.nu, grads)
    sf = step.to(torch.float32)
    bc1 = 1 - torch.pow(_f32(b1, sf), sf)
    bc2 = 1 - torch.pow(_f32(b2, sf), sf)

    def upd(p, m, n):
        pf = p.to(torch.float32)
        mhat = m / bc1
        nhat = n / bc2
        delta = mhat / (torch.sqrt(nhat) + cfg.eps) + cfg.weight_decay * pf
        return (pf - lr * delta).to(p.dtype)

    new_params = tree_map(upd, params, mu, nu)
    metrics = {"lr": lr, "grad_norm": gnorm}
    return new_params, AdamWState(mu=mu, nu=nu, step=step), metrics
