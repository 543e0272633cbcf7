"""Efficient MiTA — the sorted span path of the production forward (port
of ``repro.core.mita_sparse``, ``impl="sorted"`` with ``expert_span > 0``).

Sub-queries are sorted by expert assignment; attention runs in fixed-size
query blocks, each of which loads a static span of ``expert_span`` expert
tiles starting at its first expert and masks the rest.  Queries whose
expert falls outside the span keep only the shared and local branches —
the same documented drop rule as the reference.  The ``capacity`` strategy
and the Pallas expert kernel (``impl="pallas"``) are not ported yet.
"""

from __future__ import annotations

import math

import torch

from repro_torch.core import mita as mref
from repro_torch.core.combine import Partial, combine, partial_from_scores
from repro_torch.core.mita import MiTAConfig
from repro_torch.device import NEG_INF


def _take_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x [..., n, w] rows at idx [..., j] -> [..., j, w]."""
    return torch.gather(x, -2, idx[..., None].expand(idx.shape
                                                     + (x.shape[-1],)))


def _routed_sorted(q, k_e, v_e, valid, r, cfg: MiTAConfig, block_q: int,
                   expert_span: int) -> Partial:
    """Sorted block-span routed branch.  q: [..., N, d].  Routing logits
    with broadcast-1 lead dims are expanded to q's lead (same result as
    the reference's shared-routing form, without its traffic saving)."""
    if expert_span <= 0:
        raise NotImplementedError(
            "expert_span=0 routes to the Pallas expert kernel, which is "
            "not ported yet (ROADMAP B.4)")
    lead = q.shape[:-2]
    n, d = q.shape[-2:]
    s, m, kk = cfg.s, cfg.m, cfg.k
    r = r.expand(lead + r.shape[-2:])

    if s == 1:
        e_idx = mref.argmax_first(r)[..., None]
        e_ok = (r.amax(dim=-1) > NEG_INF / 2)[..., None]
    else:
        top_r, e_idx = mref.topk_first(r, s)
        e_ok = top_r > NEG_INF / 2

    ns = n * s
    a = e_idx.reshape(lead + (ns,))
    ok = e_ok.reshape(lead + (ns,))
    a_sortkey = torch.where(ok, a, m)
    order = torch.argsort(a_sortkey, dim=-1, stable=True)
    inv = torch.argsort(order, dim=-1, stable=True)

    sub_q = q.repeat_interleave(s, dim=-2)
    q_sorted = _take_rows(sub_q, order)
    a_sorted = torch.gather(a_sortkey, -1, order)

    if ns % block_q:
        raise ValueError(f"N*s={ns} not divisible by block_q={block_q} "
                         "(the static-span path needs whole blocks)")
    nb = ns // block_q
    qb = q_sorted.reshape(lead + (nb, block_q, d))
    ab = a_sorted.reshape(lead + (nb, block_q))
    lo = torch.clamp(ab[..., 0], max=m - 1)

    raw_ids = lo[..., None] + torch.arange(expert_span, device=q.device)
    slot_ok = raw_ids <= m - 1
    span_ids = torch.where(slot_ok, raw_ids, m + 1)
    gather_ids = torch.clamp(raw_ids, max=m - 1)
    flat_span = gather_ids.reshape(lead + (nb * expert_span,))

    def take(arr, trailing):
        """[kv_lead..., m, *trailing] -> [lead..., nb, span, width]."""
        arr = arr.expand(lead + arr.shape[-(trailing + 1):])
        width = math.prod(arr.shape[-trailing:])
        out = _take_rows(arr.reshape(lead + (m, width)), flat_span)
        return out.reshape(lead + (nb, expert_span, width))

    k_span = take(k_e, 2).reshape(lead + (nb, expert_span, kk, d))
    v_span = take(v_e, 2).reshape(lead + (nb, expert_span, kk, d))
    valid_span = take(valid, 1)

    scores = torch.einsum("...bqd,...bekd->...bqek", qb, k_span) \
        / math.sqrt(d)
    match = ab[..., :, None] == span_ids[..., None, :]
    mask = match[..., None] & valid_span[..., None, :, :]
    p = partial_from_scores(
        scores.reshape(lead + (nb, block_q, expert_span * kk)),
        v_span.reshape(lead + (nb, expert_span * kk, d)),
        mask=mask.reshape(lead + (nb, block_q, expert_span * kk)))

    o = _take_rows(p.o.reshape(lead + (ns, d)), inv)
    mm = torch.gather(p.m.reshape(lead + (ns,)), -1, inv)
    ll = torch.gather(p.l.reshape(lead + (ns,)), -1, inv)
    return _merge_subqueries(o, mm, ll, lead, n, s, q.dtype)


def _merge_subqueries(o, mm, ll, lead, n, s, dtype) -> Partial:
    """Merge the s per-sub-query partials of each query (online softmax)."""
    d = o.shape[-1]
    if s == 1:
        return Partial(o=o.reshape(lead + (n, d)), m=mm, l=ll)
    os_ = o.reshape(lead + (n, s, d))
    ms = mm.reshape(lead + (n, s))
    ls = ll.reshape(lead + (n, s))
    m_star = ms[..., 0]
    for j in range(1, s):
        m_star = torch.maximum(m_star, ms[..., j])
    safe = torch.where(m_star == NEG_INF, 0.0, m_star)
    l_tot = 0.0
    o_tot = 0.0
    for j in range(s):
        sc = torch.exp(torch.where(ms[..., j] == NEG_INF, NEG_INF,
                                   ms[..., j] - safe))
        l_tot = l_tot + ls[..., j] * sc
        o_tot = o_tot + os_[..., j, :].float() * sc[..., None]
    return Partial(o=o_tot.to(dtype), m=m_star, l=l_tot)


def mita_attention_sparse(q, k, v, cfg: MiTAConfig, impl: str = "sorted",
                          block_q: int = 128, expert_span: int = 4,
                          q_landmarks=None) -> torch.Tensor:
    """Production MiTA.  Semantics == `mita.mita_attention`, with the
    routed branch computed by the sorted static-span strategy."""
    if impl != "sorted":
        raise NotImplementedError(
            f"mita_attention_sparse impl={impl!r} is not ported yet "
            "(ROADMAP A.9: capacity routing; B.4: the expert kernel)")
    q_lm = mref.extract_landmarks(q if q_landmarks is None else q_landmarks,
                                  cfg)
    s_kv = mref.landmark_scores(k, q_lm, cfg)
    r = mref.routing_logits(q, q_lm, cfg)
    if cfg.route_per_group and q_landmarks is not None:
        r_route = mref.routing_logits(q_landmarks, q_lm, cfg)
    else:
        r_route = r

    parts: list[Partial] = []
    if not cfg.route_only:
        parts.append(mref._shared_partial(r, mref.landmark_values(v, s_kv)))
    if not cfg.compress_only:
        k_e, v_e, valid = mref.gather_topk(k, v, s_kv, cfg)
        bq = min(block_q, q.shape[-2] * cfg.s)
        parts.append(_routed_sorted(q, k_e, v_e, valid, r_route, cfg, bq,
                                    min(expert_span, cfg.m)))
    if cfg.causal and cfg.include_local:
        parts.append(mref._local_partial(q, k, v, cfg))
    return combine(parts)
