"""Baseline attention mechanisms of the paper's taxonomy (Tab. 1) (port of
``repro.core.baselines``).

The reference computes these in plain XLA, with no Pallas kernel, so plain
PyTorch is their port.  Same [..., N, d] convention as `mita.py`:

  * ``full_attention``   — the N-width fast-weight MLP itself (Eq. 1/3);
  * ``local_attention``  — banded sliding-window attention (the locality
    prior; recurrentgemma's attention);
  * ``linear_attention`` — compression into one linear layer (elu + 1
    features);
  * ``moba_attention``   — routing with rigid block experts (MoBA).

Agent attention is ``mita_attention`` with ``compress_only=True``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.core.combine import combine, partial_from_logits
from repro_torch.core.mita import MiTAConfig, _local_partial, topk_first
from repro_torch.device import NEG_INF


def full_attention(q, k, v, causal: bool = False) -> torch.Tensor:
    """Vanilla scaled-dot-product attention (paper Eq. 1): float32 logits,
    softmax weights cast to the value dtype for the value product."""
    d = q.shape[-1]
    logits = torch.einsum("...qd,...kd->...qk", q, k).float() / math.sqrt(d)
    if causal:
        n = q.shape[-2]
        mask = torch.tril(torch.ones((n, n), dtype=torch.bool,
                                     device=q.device))
        logits = torch.where(mask, logits, NEG_INF)
    p = torch.softmax(logits, dim=-1)
    return torch.einsum("...qk,...kd->...qd", p.to(v.dtype), v)


def local_attention(q, k, v, window: int, causal: bool = True):
    """Sliding-window attention, blockwise (block = window): each query
    block attends its own and the previous key block under a banded mask,
    so the cost is O(N * window).  Causal: query t sees keys in
    (t - window, t]."""
    n, d = q.shape[-2:]
    if n % window:
        raise ValueError(f"N={n} not divisible by window={window}")
    nb = n // window
    lead = q.shape[:-2]
    qb = q.reshape(lead + (nb, window, d))
    kb = k.reshape(k.shape[:-2] + (nb, window, d))
    vb = v.reshape(v.shape[:-2] + (nb, window, d))

    def prev(x):        # block b-1 beside block b; zeros before block 0
        r = torch.roll(x, 1, dims=-3).clone()
        r[..., 0, :, :] = 0.0
        return torch.cat([r, x], dim=-2)

    k2, v2 = prev(kb), prev(vb)
    logits = torch.einsum("...qd,...kd->...qk", qb, k2) / math.sqrt(d)
    i = torch.arange(window, device=q.device)[:, None]
    j = torch.arange(2 * window, device=q.device)[None, :]
    rel = j - window - i                      # key position - query position
    band = ((rel <= 0) & (rel > -window)) if causal else rel.abs() < window
    first = torch.zeros((nb, 1, 1), dtype=torch.bool, device=q.device)
    first[0] = True
    valid = band[None] & ~(first & (j[None] < window))
    logits = torch.where(valid, logits, NEG_INF)
    p = torch.softmax(logits.float(), dim=-1)
    out = torch.einsum("...qk,...kd->...qd", p.to(v.dtype), v2)
    return out.reshape(lead + (n, d))


def linear_attention(q, k, v, causal: bool = False) -> torch.Tensor:
    """Linear attention with elu(x) + 1 features.  Bidirectional:
    phi(Q) (phi(K)^T V) / (phi(Q) phi(K)^T 1); causal: cumulative sums of
    the fast-weight state."""
    phi_q = F.elu(q) + 1.0
    phi_k = F.elu(k) + 1.0
    if not causal:
        kv = torch.einsum("...nd,...ne->...de", phi_k, v)
        z = torch.einsum("...nd,...d->...n", phi_q, phi_k.sum(dim=-2))
        out = torch.einsum("...nd,...de->...ne", phi_q, kv)
        return out / torch.clamp(z[..., None], min=1e-6)
    kv_cum = torch.cumsum(torch.einsum("...nd,...ne->...nde", phi_k, v),
                          dim=-3)
    k_cum = torch.cumsum(phi_k, dim=-2)
    out = torch.einsum("...nd,...nde->...ne", phi_q, kv_cum)
    z = torch.einsum("...nd,...nd->...n", phi_q, k_cum)
    return out / torch.clamp(z[..., None], min=1e-6)


def moba_attention(q, k, v, block_size: int, top_blocks: int,
                   causal: bool = True) -> torch.Tensor:
    """Mixture of Block Attention: experts are contiguous key blocks routed
    by their mean-pooled key.  Causal: a query attends its own block
    causally (the local branch) and routes to ``top_blocks`` fully past
    blocks; top-k ties go to the lower block, as ``lax.top_k``'s."""
    n, d = q.shape[-2:]
    if n % block_size:
        raise ValueError("N must divide by block_size")
    nb = n // block_size
    lead = q.shape[:-2]
    kb = k.reshape(k.shape[:-2] + (nb, block_size, d))
    vb = v.reshape(v.shape[:-2] + (nb, block_size, d))
    k_mean = kb.mean(dim=-2)                                 # [..., nb, d]

    r = torch.einsum("...nd,...bd->...nb", q, k_mean) / math.sqrt(d)
    if causal:
        pos = torch.arange(n, device=q.device)
        ends = (torch.arange(nb, device=q.device) + 1) * block_size
        avail = ends[None, :] <= pos[:, None] + 1
        own = (pos[:, None] // block_size) \
            == torch.arange(nb, device=q.device)[None, :]
        r = torch.where(avail & ~own, r, NEG_INF)
    r = r.expand(lead + r.shape[-2:])
    top_r, sel = topk_first(r, min(top_blocks, nb))          # [..., N, g]
    sel_valid = top_r > NEG_INF / 2

    g = sel.shape[-1]
    flat = sel.reshape(lead + (n * g,))

    def take(blocks):
        b2 = blocks.expand(lead + blocks.shape[-3:]).reshape(
            lead + (nb, block_size * d))
        out = torch.gather(b2, -2, flat[..., None].expand(
            flat.shape + (b2.shape[-1],)))
        return out.reshape(lead + (n, g * block_size, d))

    k_sel, v_sel = take(kb), take(vb)
    logits = torch.einsum("...nd,...nkd->...nk", q, k_sel) / math.sqrt(d)
    mask = torch.repeat_interleave(sel_valid, block_size, dim=-1)
    parts = [partial_from_logits(logits, v_sel, mask=mask)]
    if causal:
        parts.append(_local_partial(q, k, v,
                                    MiTAConfig(m=nb, k=1, causal=True)))
    return combine(parts)
