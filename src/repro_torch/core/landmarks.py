"""Landmark-query extraction (port of ``repro.core.landmarks``: the
paper's default average pooling over equal contiguous windows)."""

from __future__ import annotations

import torch


def pool1d(q: torch.Tensor, m: int) -> torch.Tensor:
    """Average-pool queries [..., N, d] over m contiguous windows. N must
    divide by m."""
    n = q.shape[-2]
    if n % m:
        raise ValueError(f"sequence length {n} not divisible by m={m}")
    w = n // m
    return q.reshape(q.shape[:-2] + (m, w, q.shape[-1])).mean(dim=-2)


def window_ends(n: int, m: int, device=None) -> torch.Tensor:
    """End position (exclusive) of each landmark window: [(i+1)*w]_i."""
    w = n // m
    return (torch.arange(m, device=device) + 1) * w
