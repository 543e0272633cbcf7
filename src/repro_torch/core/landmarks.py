"""Landmark-query extraction (port of ``repro.core.landmarks``, paper Sec.
3.2 and the Tab. 6 ablation).

A landmark extractor maps per-head queries ``q: [..., N, d]`` to ``m``
landmark queries ``[..., m, d]``.  The paper's default, average pooling
over uniformly spaced, equal-sized windows, is ``pool1d`` (sequences) and
``pool2d`` (vision, over the patch grid); ``random`` and ``learnable`` are
the Tab. 6 alternatives.
"""

from __future__ import annotations

import functools

import torch

from repro_torch import prng


def pool1d(q: torch.Tensor, m: int) -> torch.Tensor:
    """Average-pool queries [..., N, d] over m contiguous windows. N must
    divide by m."""
    n = q.shape[-2]
    if n % m:
        raise ValueError(f"sequence length {n} not divisible by m={m}")
    w = n // m
    return q.reshape(q.shape[:-2] + (m, w, q.shape[-1])).mean(dim=-2)


def pool2d(q: torch.Tensor, grid_hw: tuple[int, int],
           m_hw: tuple[int, int]) -> torch.Tensor:
    """2-D average pooling over the (H, W) patch grid (the paper's default
    for vision).  ``q`` is [..., H*W, d]; returns [..., mh*mw, d]."""
    h, w = grid_hw
    mh, mw = m_hw
    if h % mh or w % mw:
        raise ValueError(f"grid {grid_hw} not divisible by landmark grid "
                         f"{m_hw}")
    d = q.shape[-1]
    lead = q.shape[:-2]
    x = q.reshape(lead + (mh, h // mh, mw, w // mw, d))
    return x.mean(dim=(-4, -2)).reshape(lead + (mh * mw, d))


def random_select(q: torch.Tensor, m: int, seed: int = 0) -> torch.Tensor:
    """Select m queries at fixed random positions (Tab. 6 'Random
    Selection'): the first m of ``jax.random.permutation(PRNGKey(seed),
    N)``, in ascending order."""
    return q.index_select(-2, _random_positions(seed, q.shape[-2], m,
                                                q.device))


@functools.lru_cache(maxsize=64)
def _random_positions(seed: int, n: int, m: int,
                      device: torch.device) -> torch.Tensor:
    """`random_select`'s positions on ``device``: drawn on the CPU and
    copied over once per (seed, n, m, device), not in every layer of every
    forward.  Made outside inference mode, so a training step may save
    them for its backward pass."""
    with torch.inference_mode(False):
        idx = prng.permutation(prng.PRNGKey(seed), n)[:m]
        return torch.sort(idx).values.to(device)


def learnable(params: torch.Tensor, batch_shape: tuple[int, ...]
              ) -> torch.Tensor:
    """Broadcast slow-weight landmark parameters [m, d] (Tab. 6
    'Learnable')."""
    return params.expand(tuple(batch_shape) + tuple(params.shape))


def window_ends(n: int, m: int, device=None) -> torch.Tensor:
    """End position (exclusive) of each landmark window: [(i+1)*w]_i."""
    w = n // m
    return (torch.arange(m, device=device) + 1) * w


EXTRACTORS = {
    "pool1d": pool1d,
    "pool2d": pool2d,
    "random": random_select,
}
