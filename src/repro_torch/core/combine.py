"""Online-softmax combination of attention partials (port of
``repro.core.combine``; paper Alg. 1, line 16).

Each attention branch is summarised by ``(o, m, l)`` with
``o = sum_j exp(s_j - m) v_j``, ``m = max_j s_j``, ``l = sum_j exp(s_j - m)``
and branches merge exactly as FlashAttention's online softmax.  Statistics
are float32 whatever the value dtype.  The ``NEG_INF`` guards are copied
from the reference as written: a fully masked row has ``m == NEG_INF`` and
must produce ``l == 0`` and a zero output, never ``exp(0) = 1``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch

from repro_torch.device import NEG_INF


@dataclasses.dataclass
class Partial:
    """Un-normalised attention partial: o [..., d], m [...], l [...]."""

    o: torch.Tensor
    m: torch.Tensor
    l: torch.Tensor


def _einsum_dtype(p: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    return p.to(values.dtype)


def partial_from_logits(logits: torch.Tensor, values: torch.Tensor,
                        mask: Optional[torch.Tensor] = None) -> Partial:
    """logits [..., n]; values [..., n, d]; mask [..., n] bool (False =
    excluded)."""
    logits = logits.float()
    if mask is not None:
        logits = torch.where(mask, logits, NEG_INF)
    m = logits.amax(dim=-1)
    safe_m = torch.where(m == NEG_INF, 0.0, m)
    p = torch.exp(logits - safe_m[..., None])
    if mask is not None:
        p = torch.where(mask, p, 0.0)
    else:
        p = torch.where(logits == NEG_INF, 0.0, p)
    l = p.sum(dim=-1)
    o = torch.einsum("...n,...nd->...d", _einsum_dtype(p, values), values)
    return Partial(o=o, m=m, l=l)


def partial_from_scores(scores: torch.Tensor, values: torch.Tensor,
                        mask: Optional[torch.Tensor] = None) -> Partial:
    """Like `partial_from_logits` for a [..., Q, K] score matrix with values
    [..., K, d] shared across the query axis."""
    scores = scores.float()
    if mask is not None:
        scores = torch.where(mask, scores, NEG_INF)
    m = scores.amax(dim=-1)
    safe_m = torch.where(m == NEG_INF, 0.0, m)
    p = torch.exp(scores - safe_m[..., None])
    p = torch.where(scores == NEG_INF, 0.0, p)
    l = p.sum(dim=-1)
    o = torch.einsum("...qk,...kd->...qd", _einsum_dtype(p, values), values)
    return Partial(o=o, m=m, l=l)


def combine(partials: Sequence[Partial]) -> torch.Tensor:
    """Merge branch partials into the normalised attention output; queries
    with no valid key in any branch return zeros."""
    if not partials:
        raise ValueError("need at least one partial")
    m_star = partials[0].m
    for p in partials[1:]:
        m_star = torch.maximum(m_star, p.m)
    safe_m = torch.where(m_star == NEG_INF, 0.0, m_star)

    l_tot = torch.zeros_like(partials[0].l)
    o_tot = torch.zeros(partials[0].o.shape, dtype=torch.float32,
                        device=partials[0].o.device)
    for p in partials:
        scale = torch.exp(torch.where(p.m == NEG_INF, NEG_INF, p.m - safe_m))
        l_tot = l_tot + p.l * scale
        o_tot = o_tot + p.o.float() * scale[..., None]

    denom = torch.where(l_tot == 0.0, 1.0, l_tot)
    out = o_tot / denom[..., None]
    return torch.where((l_tot == 0.0)[..., None], 0.0, out).to(
        partials[0].o.dtype)
