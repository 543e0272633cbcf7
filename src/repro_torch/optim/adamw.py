"""AdamW and its schedule (port of ``repro.optim.adamw``).

Optimizer state mirrors the parameter tree: float32 moments (master
precision even where parameters are bf16) and an int32 step.  The
arithmetic is the reference's, in its order and dtypes: the schedule and
the bias corrections are float32 tensors on the parameters' device (a
Python float divisor would let the card multiply by its reciprocal), the
global norm sums per-leaf float32 sums of squares over the leaves in
sorted key order (``jax.tree.leaves``' order), and weight decay applies to
every leaf.

Two forms share one per-leaf body (`_leaf_update`), so their bits are
equal.  `adamw_update` is functional: it returns new tensors and leaves
its inputs as they were.  `adamw_update_` is the train steps' form: it
donates its inputs, as the reference's train cell donates the parameters
and moments (``donate_argnums=(0, 1)``) and XLA updates them in place.
It writes the parameters, moments, step counter and gradients (clipped
in place) leaf by leaf, a leaf in slices of its leading dimension of at
most ``UPDATE_CHUNK`` elements (a stacked leaf: a layer or a few), so that its
temporaries stay a slice's size.  A step then holds the parameters, the
two moments and one gradient copy, where the functional form holds
about twice that.  DTensor leaves are updated through their local
shards (the body is elementwise, so the bits are DTensor's own).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, NamedTuple

import torch
from torch.distributed.tensor import DTensor


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


def _clip_scale(gn: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(_f32(max_norm, gn) / torch.clamp(gn, min=1e-9),
                       max=1.0)


def clip_by_global_norm(grads, max_norm: float):
    gn = global_norm(grads)
    scale = _clip_scale(gn, max_norm)
    return tree_map(lambda g: g * scale, grads), gn


def _local(x):
    """A DTensor's local shard (its own storage; a plain tensor as it is):
    the elementwise update writes into it."""
    return x.to_local() if isinstance(x, DTensor) else x


def _consts(grads, state: AdamWState, cfg: OptConfig):
    """The step's scalars: the clip scale (from the global norm of the
    float32 gradients), the step, the learning rate and the bias
    corrections, float32 tensors on the parameters' device."""
    gnorm = global_norm(grads)
    scale = _clip_scale(gnorm, cfg.clip_norm)
    step = state.step + 1
    lr = cosine_schedule(step, cfg)
    sf = step.to(torch.float32)
    bc1 = 1 - torch.pow(_f32(cfg.b1, sf), sf)
    bc2 = 1 - torch.pow(_f32(cfg.b2, sf), sf)
    return gnorm, scale, step, lr, bc1, bc2


def _leaf_update(p, m, n, g, lr, bc1, bc2, cfg: OptConfig):
    """One leaf (or a slice of one) of the update from the clipped float32
    gradient ``g``: (new parameter, new mu, new nu), new tensors.  The
    whole of ``delta`` is computed before anything is written (``pf`` is
    ``p`` itself for a float32 parameter)."""
    b1, b2 = cfg.b1, cfg.b2
    m = b1 * m + (1 - b1) * g
    n = b2 * n + (1 - b2) * g * g
    pf = p.to(torch.float32)
    mhat = m / bc1
    nhat = n / bc2
    delta = mhat / (torch.sqrt(nhat) + cfg.eps) + cfg.weight_decay * pf
    return (pf - lr * delta).to(p.dtype), m, n


@torch.no_grad()
def adamw_update(grads, state: AdamWState, params, cfg: OptConfig):
    """Returns (new_params, new_state, metrics {"lr", "grad_norm"}); its
    inputs are left as they were."""
    grads = tree_map(lambda g: g.to(torch.float32), grads)
    gnorm, scale, step, lr, bc1, bc2 = _consts(grads, state, cfg)
    new = tree_map(lambda p, m, n, g: _leaf_update(p, m, n, g * scale, lr,
                                                   bc1, bc2, cfg),
                   params, state.mu, state.nu, grads)
    pick = lambda i: tree_map(lambda t: t[i], new)  # noqa: E731
    metrics = {"lr": lr, "grad_norm": gnorm}
    return pick(0), AdamWState(mu=pick(1), nu=pick(2), step=step), metrics


# elements of a leaf's slice that the in-place update handles at once (a
# layer of a stacked leaf, or rows of a large one; float32: 16 MiB): its
# temporaries, about six slices, stay small beside the weights
UPDATE_CHUNK = 1 << 22


@torch.no_grad()
def adamw_update_(grads, state: AdamWState, params, cfg: OptConfig):
    """`adamw_update` in place: ``params``, ``state.mu``, ``state.nu``,
    ``state.step`` and ``grads`` (clipped) are donated and written; the
    same bits as `adamw_update`.  Returns (params, state, metrics), the
    trees it was given.  A slice is at most ``UPDATE_CHUNK`` elements,
    and at least one index of the leading dimension."""
    gnorm, scale, step, lr, bc1, bc2 = _consts(grads, state, cfg)
    scale, lr_l, bc1, bc2 = map(_local, (scale, lr, bc1, bc2))
    for p, m, n, g in zip(*map(tree_leaves, (params, state.mu, state.nu,
                                             grads))):
        p, m, n, g = map(_local, (p, m, n, g))
        rows = p.shape[0] if p.dim() else 1
        per = max(1, UPDATE_CHUNK // max(1, p[0].numel() if p.dim() else 1))
        for lo in range(0, rows, per):
            sl = (slice(lo, lo + per),) if p.dim() else ()
            gc = g[sl]
            gc = gc.mul_(scale) if gc.dtype == torch.float32 \
                else gc.to(torch.float32) * scale
            new_p, new_m, new_n = _leaf_update(p[sl], m[sl], n[sl], gc,
                                               lr_l, bc1, bc2, cfg)
            m[sl].copy_(new_m)
            n[sl].copy_(new_n)
            p[sl].copy_(new_p)
            del gc, new_p, new_m, new_n
    _local(state.step).copy_(_local(step))
    return params, state, {"lr": lr, "grad_norm": gnorm}
