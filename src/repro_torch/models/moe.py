"""Mixture-of-Experts FFN, fine-grained (DeepSeekMoE) and coarse (DBRX)
(port of ``repro.models.moe``).

Token dispatch uses sort-based capacity routing with static shapes: the
flattened tokens are cut into ``gcd(B*N, 16)`` groups, each token's top-k
assignments are ranked within their expert's queue by a stable sort, and
an assignment whose rank reaches the per-group capacity is dropped.
Expert compute is a dense [E, G*C, d] x [E, d, f] batched product.  Which
tokens drop depends on how a call groups them, so every caller passes the
reference's [B, N, D] shape at that call (inactive rows and padding
included).

The reference's ``_ep_constraint`` / ``_group_constraint`` are GSPMD
sharding hints (experts over "model" and capacity slots over the data
axes inside the layer, identities on one device).  The port's split
cells do expert parallelism explicitly instead (``tp``, a
`distributed.tensor_parallel.ModelSplit`): the rank that holds experts
[e0, e0 + E/M) (its shard of the stacked expert leaves) routes every
token of its data share over all E experts with the whole router, builds
only its own experts' slots, runs the experts' products on those E/M
experts, and sums each token's kept assignments to them; the shared
expert adds its column/row-parallel part, and one all-reduce of the
[B, N, d] output over "model" ends the layer.  No all-to-all is needed:
every "model" rank already holds every token of its data share (the
residual stream is replicated over the axis), so dispatch is a local
slice.  GSPMD's data-major to expert-major transpose would be that
slice in and an all-gather of the experts' outputs (~K·cf·T·d elements)
out; the all-reduce moves ~2·T·d, about 3.75x less at deepseek-moe-16b's
K 6 and capacity factor 1.25.  The ``moe_groups`` knob is left out: it
always resolves to 16.
"""

from __future__ import annotations

import math
from typing import Any, NamedTuple, Optional

import torch

from repro_torch.core.mita import take_rows
from repro_torch.models import modules as nn

Params = dict[str, Any]

MOE_GROUPS = 16


def _stacked_normal(gen, shape, scale, dtype, device,
                    n_layers: Optional[int]) -> torch.Tensor:
    """N(0, 1) * scale of ``shape``, or ``n_layers`` such draws stacked on
    a new axis 0: allocated once, each layer drawn into its slice (the
    stacked tensor is never built from per-layer copies)."""
    if n_layers is None:
        return nn._normal(gen, shape, scale, dtype, device)
    out = torch.empty((n_layers, *shape), dtype=dtype, device=device)
    for i in range(n_layers):
        out[i].copy_(nn._normal(gen, shape, scale, dtype, device))
    return out


def moe_init(gen, cfg: nn.ModelConfig, device,
             n_layers: Optional[int] = None) -> Params:
    """One MoE layer's parameters with the reference's shapes, dtypes and
    scales (router f32 N(0, 1/d); ``wi`` / ``wg`` N(0, 1)/sqrt(d), ``wo``
    N(0, 1)/sqrt(f) in ``param_dtype``; shared experts one SwiGLU of width
    ``n_shared_experts * d_ff``), or, with ``n_layers``, that many layers'
    leaves stacked on axis 0 (deepseek-moe-16b's expert leaves are 19 GiB
    each in float32: stacking per-layer tensors would hold one twice)."""
    e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
    pd = cfg.param_dtype

    def draw(shape, scale, dtype):
        return _stacked_normal(gen, shape, scale, dtype, device, n_layers)

    p = {"router": draw((d, e), 1.0 / math.sqrt(d), torch.float32),
         "wi": draw((e, d, f), 1.0 / math.sqrt(d), pd),
         "wg": draw((e, d, f), 1.0 / math.sqrt(d), pd),
         "wo": draw((e, f, d), 1.0 / math.sqrt(f), pd)}
    if cfg.n_shared_experts:
        fs = cfg.n_shared_experts * cfg.d_ff
        p["shared"] = {"wi": draw((d, fs), 1.0 / math.sqrt(d), pd),
                       "wg": draw((d, fs), 1.0 / math.sqrt(d), pd),
                       "wo": draw((fs, d), 1.0 / math.sqrt(fs), pd)}
    return p


def _queues(assign: torch.Tensor, n_experts: int):
    """Stable expert queues of assignments [..., T] (ids in [0, E], E the
    drop sentinel): (order, counts, starts, slot).  ``order`` sorts the
    assignments by expert, stably; ``counts`` / ``starts`` [..., E + 1] are
    each queue's length and offset in that order; ``slot`` [..., T] is each
    assignment's rank within its queue."""
    t = assign.shape[-1]
    a = assign.long()
    order = torch.argsort(a, dim=-1, stable=True)
    a_sorted = torch.gather(a, -1, order)
    counts = torch.zeros((*a.shape[:-1], n_experts + 1), dtype=torch.long,
                         device=a.device)
    counts.scatter_add_(-1, a, torch.ones_like(a))
    starts = torch.cumsum(counts, -1) - counts
    slot_sorted = torch.arange(t, device=a.device) \
        - torch.gather(starts, -1, a_sorted)
    slot = torch.empty_like(slot_sorted).scatter_(-1, order, slot_sorted)
    return order, counts, starts, slot


def _dispatch_slots(assign: torch.Tensor, n_experts: int) -> torch.Tensor:
    """Rank of each sub-token within its expert queue (stable), via sort.
    assign: [..., T] int expert ids (``n_experts`` = drop sentinel
    allowed).  Returns slot [..., T] int32."""
    return _queues(assign, n_experts)[3].to(torch.int32)


class Routing(NamedTuple):
    """`route`'s decisions for G groups of Tg tokens, K picks each."""
    gates: torch.Tensor       # [G, Tg, E] float32 softmax
    gate_w: torch.Tensor      # [G, Tg, K] the picks' gates, renormalised
    gate_idx: torch.Tensor    # [G, Tg, K] the picked experts
    cap: int                  # slots per expert and group
    order: torch.Tensor       # [G, Tg*K] assignments sorted by expert
    counts: torch.Tensor      # [G, E + 1] queue lengths
    starts: torch.Tensor      # [G, E + 1] queue offsets in ``order``
    slot: torch.Tensor        # [G, Tg*K] rank in the queue (kept: < cap)


def route(params: Params, tokens: torch.Tensor,
          cfg: nn.ModelConfig) -> Routing:
    """Routing of grouped tokens [G, Tg, D].  Top-k by a stable descending
    sort: the first index wins a tie, as ``jax.lax.top_k``."""
    g, tg, _ = tokens.shape
    e, kk = cfg.n_experts, cfg.moe_top_k
    gates = torch.softmax(tokens.float() @ params["router"], dim=-1)
    gate_w, gate_idx = torch.sort(gates, dim=-1, descending=True,
                                  stable=True)
    gate_w, gate_idx = gate_w[..., :kk], gate_idx[..., :kk]
    gate_w = gate_w / torch.clamp_min(gate_w.sum(-1, keepdim=True), 1e-9)
    cap = max(8, int(math.ceil(tg * kk / e * cfg.moe_capacity_factor)))
    cap = ((cap + 7) // 8) * 8
    return Routing(gates, gate_w, gate_idx, cap,
                   *_queues(gate_idx.reshape(g, tg * kk), e))


def moe_apply(params: Params, x: torch.Tensor, cfg: nn.ModelConfig,
              tp=None):
    """x: [B, N, D] in the compute dtype.  Returns (out [B, N, D], aux),
    aux the switch-style load-balance loss (float32 scalar).

    Per group: route, rank, keep ``slot < cap``, gather the kept tokens
    into their expert's slots (an empty slot reads token 0 and is never
    read back), the experts' SwiGLU, then each token sums its kept
    assignments' outputs times their gates.  Under a model split
    (``tp``; ``params`` this rank's shards, ``cfg`` with the global
    ``n_experts``) only the rank's experts ``tp.experts`` are computed,
    the output is summed over "model" once, and ``aux`` (whole on every
    rank) passes its gradient there once (`ModelSplit.once`)."""
    b, n, d = x.shape
    e, kk = cfg.n_experts, cfg.moe_top_k
    ct = cfg.compute_dtype
    t = b * n
    g = math.gcd(t, MOE_GROUPS)
    tg = t // g
    if tp is not None:
        x = tp.enter(x)
    e0, el = (0, e) if tp is None else tp.experts
    tokens = x.reshape(g, tg, d)
    gates, gate_w, gate_idx, cap, order, counts, starts, slot = route(
        params, tokens, cfg)
    assign = gate_idx.reshape(g, tg * kk)
    keep = slot < cap
    if tp is not None:
        keep = keep & (assign >= e0) & (assign < e0 + el)
    dst = torch.where(keep, (assign - e0) * cap + slot, el * cap)  # [G, Tg*K]

    # expert-slot sources by gather, not scatter: slot c of expert e holds
    # the assignment at sorted position starts[e] + c while c < counts[e]
    c_ar = torch.arange(cap, device=x.device)
    pos = starts[:, e0:e0 + el, None] + c_ar                    # [G, E, C]
    filled = c_ar < counts[:, e0:e0 + el, None]
    src = torch.gather(order, 1, torch.clamp(pos, max=tg * kk - 1)
                       .reshape(g, el * cap)) // kk
    src = torch.where(filled.reshape(g, el * cap), src, 0)       # [G, E*C]
    xe = take_rows(tokens.to(ct), src)
    xe = xe.reshape(g, el, cap, d).transpose(0, 1).reshape(el, g * cap, d)

    h = torch.nn.functional.silu(torch.bmm(xe, params["wg"].to(ct)))
    h = h * torch.bmm(xe, params["wi"].to(ct))
    ye = torch.bmm(h, params["wo"].to(ct))                     # [E, G*C, d]

    ye = ye.reshape(el, g, cap, d).transpose(0, 1).reshape(g, el * cap, d)
    ypad = torch.cat([ye, torch.zeros((g, 1, d), dtype=ct, device=x.device)],
                     dim=1)
    y_tok = take_rows(ypad, dst)
    y_tok = y_tok.reshape(g, tg, kk, d)
    w = torch.where(keep.reshape(g, tg, kk), gate_w, 0.0).to(ct)
    out = torch.einsum("gtkd,gtk->gtd", y_tok, w).reshape(b, n, d)

    if cfg.n_shared_experts:
        # under a split: this rank's columns / rows, summed with the rest
        out = out + nn.swiglu_apply(params["shared"], x, cfg)

    # the reference's mean of one-hot rows: static shape [E] (a bincount's
    # length depends on the data, which a fake-tensor trace cannot size)
    first = gate_idx[..., 0].reshape(-1, 1)
    frac = (first == torch.arange(e, device=x.device)).sum(0).float() / t
    imp = gates.mean(dim=(0, 1))
    aux = e * torch.sum(frac * imp)
    if tp is not None:
        out, aux = tp.leave(out), tp.once(aux)
    return out, aux
