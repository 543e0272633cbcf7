"""Mixture-of-Top-k Attention (MiTA) — reference implementation (port of
``repro.core.mita``).

The semantic definition of MiTA, vectorised in plain PyTorch: the oracle
for `mita_sparse` and the decode paths.  Causal mode is the LM adaptation
of the reference (MoBA-style window causality plus a local causal branch
over the query's own window).  Shapes follow [..., N, d].

Tie order: JAX's ``lax.top_k`` returns equal values by ascending index and
``expert_idx`` is compared exactly, so every top-k here is a stable
descending sort (`topk_first`), never ``torch.topk``, which promises no
order among ties.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from repro_torch.core import landmarks as lm
from repro_torch.core.combine import (Partial, combine, partial_from_logits,
                                      partial_from_scores)
from repro_torch.device import NEG_INF


@dataclasses.dataclass(frozen=True)
class MiTAConfig:
    """MiTA hyper-parameters: m landmarks (= routed experts), expert width
    k, s routed experts per query, causal LM adaptation or bidirectional.
    ``landmark`` names the extractor (pool1d | pool2d | random); pool2d
    pools the patch grid ``grid_hw`` to the landmark grid ``m_hw``.
    ``route_only`` drops the shared expert, ``compress_only`` the routed
    experts (the Tab. 6 ablations)."""

    m: int
    k: int
    s: int = 1
    causal: bool = False
    landmark: str = "pool1d"
    grid_hw: Optional[tuple[int, int]] = None
    m_hw: Optional[tuple[int, int]] = None
    include_local: bool = True
    route_only: bool = False
    compress_only: bool = False
    route_per_group: bool = False

    def __post_init__(self):
        if self.route_only and self.compress_only:
            raise ValueError("route_only and compress_only are exclusive")
        if self.s < 1:
            raise ValueError("s >= 1 required")


def topk_first(x: torch.Tensor, k: int):
    """Top-k over the last axis with ``lax.top_k``'s order: descending,
    ties by ascending index.  Returns (values, indices int64)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def argmax_first(x: torch.Tensor) -> torch.Tensor:
    """First index of the maximum over the last axis (``jnp.argmax``)."""
    n = x.shape[-1]
    mx = x.amax(dim=-1, keepdim=True)
    ids = torch.arange(n, device=x.device).expand_as(x)
    return torch.where(x == mx, ids, n).amin(dim=-1)


def extract_landmarks(q: torch.Tensor, cfg: MiTAConfig) -> torch.Tensor:
    if cfg.landmark == "pool1d":
        return lm.pool1d(q, cfg.m)
    if cfg.landmark == "pool2d":
        if not (cfg.grid_hw and cfg.m_hw):
            raise ValueError("pool2d needs MiTAConfig.grid_hw and m_hw")
        return lm.pool2d(q, cfg.grid_hw, cfg.m_hw)
    if cfg.landmark == "random":
        return lm.random_select(q, cfg.m)
    raise ValueError(f"unknown landmark extractor {cfg.landmark!r}")


def landmark_scores(k: torch.Tensor, q_lm: torch.Tensor,
                    cfg: MiTAConfig) -> torch.Tensor:
    """S^kv = K Q~^T / sqrt(d): [..., N, m]; in causal mode key n is visible
    to landmark i only when n < end(i).

    Masked scores are float32.  The reference masks in the compute dtype,
    where NEG_INF overflows bfloat16 to -inf, which the ``NEG_INF`` guards
    of `combine` do not catch: its bfloat16 prefill yields NaN (ROADMAP
    C.4).  For float32 inputs the two agree exactly."""
    d = k.shape[-1]
    s_kv = torch.einsum("...nd,...md->...nm", k, q_lm) / math.sqrt(d)
    if cfg.causal:
        n = k.shape[-2]
        ends = lm.window_ends(n, cfg.m, device=k.device)
        visible = torch.arange(n, device=k.device)[:, None] < ends[None, :]
        s_kv = torch.where(visible, s_kv.float(), NEG_INF)
    return s_kv


def topk_indices(s_kv: torch.Tensor, cfg: MiTAConfig):
    """(top_idx [..., m, k] int32, valid [..., m, k]) per landmark.
    ``valid`` is written contiguous: the sort of the transposed scores
    leaves its outputs in the transposed layout, and the expert kernel
    reads the mask row-major (a strided mask would cost its wrapper a
    copy on every call)."""
    top_vals, top_idx = topk_first(s_kv.transpose(-1, -2), cfg.k)
    valid = torch.empty(top_vals.shape, dtype=torch.bool,
                        device=top_vals.device)
    return top_idx.to(torch.int32), torch.gt(top_vals, NEG_INF / 2,
                                             out=valid)


class _TakeRows(torch.autograd.Function):
    """``torch.gather`` of whole rows, with a row-wise backward.

    The forward is the element gather (the same bits).  Its own backward
    would scatter-add element by element: with deterministic algorithms on
    (the training driver) the card then sorts one key per element (J x w
    keys), which took most of a train step's device time at qwen3-0.6b's
    full width.  This backward adds each gathered row back with one
    ``index_add_`` over flattened rows: one key per row, deterministic on
    the card under that mode and on the CPU always."""

    @staticmethod
    def forward(ctx, x, idx):
        ctx.x_shape = x.shape
        ctx.save_for_backward(idx)
        return torch.gather(x, -2, idx[..., None].expand(
            idx.shape + (x.shape[-1],)))

    @staticmethod
    def backward(ctx, g):
        idx, = ctx.saved_tensors
        shape = ctx.x_shape
        n, w = shape[-2:]
        lead = math.prod(shape[:-2])
        rows = (torch.arange(lead, device=idx.device) * n).reshape(
            idx.shape[:-1] + (1,)) + idx
        gx = torch.zeros((lead * n, w), dtype=g.dtype, device=g.device)
        gx.index_add_(0, rows.reshape(-1), g.reshape(-1, w))
        return gx.reshape(shape), None


def take_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x [..., n, w] rows at idx [..., j] (int64, the same lead dims; x
    may be a broadcast view) -> [..., j, w]."""
    if idx.shape[:-1] != x.shape[:-2]:
        raise ValueError(f"take_rows: index lead {tuple(idx.shape[:-1])} "
                         f"!= rows lead {tuple(x.shape[:-2])}")
    return _TakeRows.apply(x, idx)


def gather_topk(keys: torch.Tensor, values: torch.Tensor,
                s_kv: torch.Tensor, cfg: MiTAConfig):
    """(k_e, v_e [..., m, k, d], valid [..., m, k])."""
    top_idx, valid = topk_indices(s_kv, cfg)
    lead = top_idx.shape[:-2]
    flat = top_idx.reshape(lead + (cfg.m * cfg.k,)).long()
    keys = keys.expand(lead + keys.shape[-2:])
    values = values.expand(lead + values.shape[-2:])
    k_e = take_rows(keys, flat)
    v_e = take_rows(values, flat)
    return (k_e.reshape(lead + (cfg.m, cfg.k, keys.shape[-1])),
            v_e.reshape(lead + (cfg.m, cfg.k, values.shape[-1])), valid)


def landmark_values(values: torch.Tensor, s_kv: torch.Tensor) -> torch.Tensor:
    """V~ = softmax over keys of S^kv, applied to V: [..., m, d]."""
    p = torch.softmax(s_kv.float(), dim=-2)
    return torch.einsum("...nm,...nd->...md", p.to(values.dtype), values)


def routing_logits(q: torch.Tensor, q_lm: torch.Tensor,
                   cfg: MiTAConfig) -> torch.Tensor:
    """Q Q~^T / sqrt(d): [..., N, m]; expert i is available to query t iff
    (i+1)*w <= t+1.  Masked logits are float32 (see `landmark_scores`)."""
    d = q.shape[-1]
    r = torch.einsum("...nd,...md->...nm", q, q_lm) / math.sqrt(d)
    if cfg.causal:
        n = q.shape[-2]
        ends = lm.window_ends(n, cfg.m, device=q.device)
        avail = ends[None, :] <= torch.arange(n, device=q.device)[:, None] + 1
        r = torch.where(avail, r.float(), NEG_INF)
    return r


def _local_partial(q, k, v, cfg: MiTAConfig) -> Partial:
    """Causal attention of each query over its own window."""
    n, d = q.shape[-2:]
    m, w = cfg.m, n // cfg.m
    lead = q.shape[:-2]
    qw = q.reshape(lead + (m, w, d))
    kw = k.reshape(k.shape[:-2] + (m, w, d))
    vw = v.reshape(v.shape[:-2] + (m, w, d))
    logits = torch.einsum("...qd,...kd->...qk", qw, kw) / math.sqrt(d)
    causal = torch.tril(torch.ones((w, w), dtype=torch.bool,
                                   device=q.device))
    p = partial_from_scores(logits, vw, mask=causal)
    return Partial(o=p.o.reshape(lead + (n, d)), m=p.m.reshape(lead + (n,)),
                   l=p.l.reshape(lead + (n,)))


def _shared_partial(r, v_lm) -> Partial:
    """Queries attend to the (landmark query, landmark value) pairs; the
    routing logits double as the shared-expert scores."""
    return partial_from_scores(r, v_lm)


def _routed_partial(q, k_e, v_e, valid, r, cfg: MiTAConfig) -> Partial:
    """Each query attends the union of its s routed experts' top-k pairs
    (gathers [..., N, s, k, d]: the oracle, not the production path)."""
    d = q.shape[-1]
    lead = q.shape[:-2]
    n = q.shape[-2]
    r = r.expand(lead + r.shape[-2:])
    top_r, e_idx = topk_first(r, cfg.s)                  # [..., N, s]
    e_avail = top_r > NEG_INF / 2
    flat_e = e_idx.reshape(lead + (n * cfg.s,))

    def take_expert(arr):   # [kv_lead..., m, k, d] -> [lead..., N, s, k, d]
        arr = arr.expand(lead + arr.shape[-3:])
        a2 = arr.reshape(lead + (cfg.m, cfg.k * arr.shape[-1]))
        out = torch.gather(a2, -2, flat_e[..., None].expand(
            flat_e.shape + (a2.shape[-1],)))
        return out.reshape(lead + (n, cfg.s, cfg.k, arr.shape[-1]))

    k_sel = take_expert(k_e)
    v_sel = take_expert(v_e)
    val = valid.expand(lead + valid.shape[-2:])
    valid_sel = torch.gather(val, -2, flat_e[..., None].expand(
        flat_e.shape + (cfg.k,))).reshape(lead + (n, cfg.s, cfg.k))
    valid_sel = valid_sel & e_avail[..., None]

    logits = torch.einsum("...nd,...nskd->...nsk", q, k_sel) / math.sqrt(d)
    logits = logits.reshape(lead + (n, cfg.s * cfg.k))
    vals = v_sel.reshape(lead + (n, cfg.s * cfg.k, d))
    return partial_from_logits(
        logits, vals, mask=valid_sel.reshape(lead + (n, cfg.s * cfg.k)))


def mita_attention(q, k, v, cfg: MiTAConfig,
                   q_landmarks: Optional[torch.Tensor] = None
                   ) -> torch.Tensor:
    """MiTA attention (paper Eq. 10), branch-wise with the online-softmax
    merge.  ``q_landmarks``: optional query tensor to pool landmarks from
    (GQA group-pooled queries with a broadcast-1 group axis)."""
    q_lm = extract_landmarks(q if q_landmarks is None else q_landmarks, cfg)
    s_kv = landmark_scores(k, q_lm, cfg)
    r = routing_logits(q, q_lm, cfg)
    if cfg.route_per_group and q_landmarks is not None:
        r_route = routing_logits(q_landmarks, q_lm, cfg)
    else:
        r_route = r

    parts: list[Partial] = []
    if not cfg.route_only:
        parts.append(_shared_partial(r, landmark_values(v, s_kv)))
    if not cfg.compress_only:
        k_e, v_e, valid = gather_topk(k, v, s_kv, cfg)
        parts.append(_routed_partial(q, k_e, v_e, valid, r_route, cfg))
    if cfg.causal and cfg.include_local:
        parts.append(_local_partial(q, k, v, cfg))
    return combine(parts)
