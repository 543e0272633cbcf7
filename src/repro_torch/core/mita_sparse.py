"""Efficient MiTA — the production O(N·(m+ks)) forward (port of
``repro.core.mita_sparse``).  Three interchangeable routed-branch
strategies, all exact w.r.t. `mita.mita_attention` up to documented drop
conditions:

``sorted``   — sub-queries are sorted by expert assignment; attention runs
    in fixed-size query blocks, each of which loads a static span of
    ``expert_span`` expert tiles starting at its first expert and masks
    the rest.  Queries whose expert falls outside the span keep only the
    shared and local branches (the reference's drop rule).
``pallas``   — the same sort, then the routed-expert kernel
    (`kernels.ops.routed_expert_partial`, ``expert_span=0``): every
    sub-query attends its own expert, with no drop rule.  The name is the
    reference's; on the card it runs the hand-written CUDA kernel, on the
    CPU its plain version.  Forward only, as in the reference.
``capacity`` — MoE capacity routing: each expert takes at most
    ``C = ceil(s·N/m · capacity_factor)`` sub-queries (padded to a multiple
    of 8) in a dense [m, C, k] product; overflowing sub-queries drop their
    routed branch.  Pair with `aux_load_balance`.
"""

from __future__ import annotations

import math

import torch

from repro_torch.core import mita as mref
from repro_torch.core.combine import Partial, combine, partial_from_scores
from repro_torch.core.mita import MiTAConfig
from repro_torch.device import NEG_INF
from repro_torch.kernels import ops

IMPLS = ("sorted", "capacity", "pallas")


def sort_subqueries(q, r, cfg: MiTAConfig):
    """The expert sort of the routed branch: each query's s sub-queries,
    sorted (stably) by their expert, an unavailable expert as id m.  q:
    [..., N, d]; r: routing logits [..., N, m] (broadcast-1 lead dims are
    expanded to q's lead).  Returns (q_sorted [..., N*s, d], a_sorted
    [..., N*s] int64, inv [..., N*s]: the sorted position of each
    sub-query) -- the expert kernel's inputs."""
    lead = q.shape[:-2]
    n = q.shape[-2]
    s, m = cfg.s, cfg.m
    r = r.expand(lead + r.shape[-2:])
    if s == 1:
        e_idx = mref.argmax_first(r)[..., None]
        e_ok = (r.amax(dim=-1) > NEG_INF / 2)[..., None]
    else:
        top_r, e_idx = mref.topk_first(r, s)
        e_ok = top_r > NEG_INF / 2
    ns = n * s
    a_sortkey = torch.where(e_ok.reshape(lead + (ns,)),
                            e_idx.reshape(lead + (ns,)), m)
    order = torch.argsort(a_sortkey, dim=-1, stable=True)
    inv = torch.argsort(order, dim=-1, stable=True)
    q_sorted = mref.take_rows(q.repeat_interleave(s, dim=-2), order)
    return q_sorted, torch.gather(a_sortkey, -1, order), inv


def _routed_sorted(q, k_e, v_e, valid, r, cfg: MiTAConfig, block_q: int,
                   expert_span: int) -> Partial:
    """Sorted routed branch.  q: [..., N, d].  ``expert_span > 0``: the
    static-span blocks; ``expert_span == 0``: the expert kernel (any N·s).
    Routing logits with broadcast-1 lead dims are expanded to q's lead
    (same result as the reference's shared-routing form, without its
    traffic saving); k_e / v_e keep their broadcast KV lead."""
    if expert_span < 0:
        raise ValueError(f"expert_span {expert_span} < 0")
    lead = q.shape[:-2]
    n, d = q.shape[-2:]
    s, m, kk = cfg.s, cfg.m, cfg.k
    ns = n * s
    q_sorted, a_sorted, inv = sort_subqueries(q, r, cfg)

    if expert_span == 0:
        o_s, m_s, l_s = ops.routed_expert_partial(
            q_sorted, a_sorted, k_e, v_e, valid, block_q=block_q)
        return _merge_subqueries(mref.take_rows(o_s, inv),
                                 torch.gather(m_s, -1, inv),
                                 torch.gather(l_s, -1, inv), lead, n, s,
                                 q.dtype)

    if ns % block_q:
        raise ValueError(f"N*s={ns} not divisible by block_q={block_q} "
                         "(the static-span path needs whole blocks; "
                         "impl='pallas' pads internally)")
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
        out = mref.take_rows(arr.reshape(lead + (m, width)), flat_span)
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

    o = mref.take_rows(p.o.reshape(lead + (ns, d)), inv)
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


def _routed_capacity(q, k_e, v_e, valid, r, cfg: MiTAConfig,
                     capacity_factor: float) -> Partial:
    """Capacity-routed branch (beyond-paper, fully dense).  q: [..., N, d]."""
    lead = q.shape[:-2]
    n, d = q.shape[-2:]
    r = r.expand(lead + r.shape[-2:])
    s, m = cfg.s, cfg.m
    cap = int(math.ceil(s * n / m * capacity_factor))
    cap = max(8, ((cap + 7) // 8) * 8)            # pad to a lane multiple

    top_r, e_idx = mref.topk_first(r, s)           # [..., N, s]
    ns = n * s
    a = e_idx.reshape(lead + (ns,))
    ok = (top_r > NEG_INF / 2).reshape(lead + (ns,))
    a_key = torch.where(ok, a, m)

    # position of each sub-query in its expert's queue (stable order)
    onehot = torch.nn.functional.one_hot(a_key, m + 1)
    pos = torch.cumsum(onehot, dim=-2) - 1          # [..., ns, m+1]
    slot = torch.gather(pos, -1, a_key[..., None])[..., 0]
    keep = ok & (slot < cap)
    dst = torch.where(keep, a * cap + slot, m * cap)   # m*cap: dropped

    # scatter sub-queries into [..., m, cap, d] (row m*cap is a sink)
    sub_q = q.repeat_interleave(s, dim=-2)
    q_exp = torch.zeros(lead + (m * cap + 1, d), dtype=q.dtype,
                        device=q.device)
    q_exp = q_exp.scatter(-2, dst[..., None].expand(lead + (ns, d)), sub_q)
    q_exp = q_exp[..., : m * cap, :].reshape(lead + (m, cap, d))

    scores = q_exp @ k_e.transpose(-1, -2) / math.sqrt(d)   # [..., m, cap, k]
    p = partial_from_scores(scores, v_e.expand(lead + v_e.shape[-3:]),
                            mask=valid[..., None, :])

    def back(x, fill):
        """Per-slot values [..., m, cap, *w] -> per-sub-query [..., ns, *w]."""
        flat = x.reshape(lead + (m * cap,) + x.shape[len(lead) + 2:])
        pad = torch.full(lead + (1,) + flat.shape[len(lead) + 1:], fill,
                         dtype=flat.dtype, device=flat.device)
        flat = torch.cat([flat, pad], dim=len(lead))
        if flat.ndim == len(lead) + 2:
            return mref.take_rows(flat, dst)
        return torch.gather(flat, -1, dst)

    o = torch.where(keep[..., None], back(p.o, 0.0), 0.0)
    mm = torch.where(keep, back(p.m, NEG_INF), NEG_INF)
    ll = torch.where(keep, back(p.l, 0.0), 0.0)
    return _merge_subqueries(o, mm, ll, lead, n, s, q.dtype)


def aux_load_balance(r: torch.Tensor, cfg: MiTAConfig) -> torch.Tensor:
    """Switch-style load-balance loss over expert assignments (keeps the
    capacity path's drop rate low)."""
    probs = torch.softmax(torch.where(r <= NEG_INF / 2, NEG_INF, r), dim=-1)
    top = mref.argmax_first(r)
    frac = torch.nn.functional.one_hot(top, cfg.m).float().mean(dim=-2)
    imp = probs.mean(dim=-2)
    return cfg.m * (frac * imp).sum(dim=-1).mean()


def mita_attention_sparse(q, k, v, cfg: MiTAConfig, impl: str = "sorted",
                          block_q: int = 128, expert_span: int = 4,
                          capacity_factor: float = 1.25,
                          q_landmarks=None) -> torch.Tensor:
    """Production MiTA.  Semantics == `mita.mita_attention` (the oracle),
    with the routed branch computed by the selected strategy."""
    if impl not in IMPLS:
        raise ValueError(f"impl {impl!r} not in {IMPLS}")
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
        if impl == "capacity":
            parts.append(_routed_capacity(q, k_e, v_e, valid, r_route, cfg,
                                          capacity_factor))
        else:
            span = 0 if impl == "pallas" else min(expert_span, cfg.m)
            parts.append(_routed_sorted(q, k_e, v_e, valid, r_route, cfg,
                                        bq, span))
    if cfg.causal and cfg.include_local:
        parts.append(mref._local_partial(q, k, v, cfg))
    return combine(parts)
