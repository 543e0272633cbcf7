"""Incremental (decode-time) MiTA (port of ``repro.core.mita_decode``).

The landmark/expert structures of causal MiTA depend only on completed
windows, so they are kept beside the KV cache: every step appends (k, v)
and adds the query to a running window sum; every ``window`` steps the
completed window is finalised into a landmark query, a landmark value and
a top-k expert row set.  Each token then attends the shared landmarks, its
top-s routed experts and its own window.

Cache forms, as in the reference:
  * `MiTADecodeState` — one monolithic cache per request batch (the static
    path, `launch.serve.static_generate`, and the engine's oracle); its
    slot form (leaves [S, 1, ...], a ``t`` per slot) is the hybrid
    model's per-slot attention cache, advanced by `mita_decode_step_slots`
    (the reference vmaps the B = 1 step over slots);
  * `FullDecodeState` — the full-attention baseline's cache, with its slot
    form (`full_decode_step_slots`);
  * `PagedMiTAState` — one pool per layer shared by all request slots,
    addressed through per-slot page tables (the serving engine), prefilled
    a chunk of one slot at a time (`mita_chunk_prefill`, per-job mode) or
    a chunk of every prefilling slot at once (`mita_batched_chunk_prefill`).

Where the reference returns new arrays (with donation), these functions
update the state tensors IN PLACE and return the state (with ``t``
replaced where it advances).  States of several layers are stacked on
axis 0; a layer's state is a tuple of views into the stack, so in-place
updates land in the stack.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from repro_torch.core import mita as mref
from repro_torch.core.combine import (Partial, combine, partial_from_logits,
                                      partial_from_scores)
from repro_torch.device import NEG_INF
from repro_torch.kernels import ops


class MiTADecodeState(NamedTuple):
    """Decode-time cache for one attention layer (B batch, Hkv KV heads,
    C capacity, M = C // window landmarks, K expert width):
      k_cache, v_cache [B, Hkv, C, d]; lm_q, lm_v [B, Hkv, M, d];
      expert_idx [B, Hkv, M, K] int32 cache rows; expert_valid
      [B, Hkv, M, K] bool; q_sum [B, Hkv, d] float32; t [] int32."""

    k_cache: torch.Tensor
    v_cache: torch.Tensor
    lm_q: torch.Tensor
    lm_v: torch.Tensor
    expert_idx: torch.Tensor
    expert_valid: torch.Tensor
    q_sum: torch.Tensor
    t: torch.Tensor


@dataclasses.dataclass(frozen=True)
class DecodeConfig:
    window: int          # w — landmark window size
    k: int               # expert width
    s: int = 1           # routed experts per query
    # The serving loop finalises landmarks at window boundaries in its own
    # step; the last token of each window then routes among j, not j+1,
    # experts (the reference's external mode).
    external_finalize: bool = False


def window_aligned(n: int, window: int) -> int:
    """Round a token count up to a whole number of landmark windows."""
    return ((n + window - 1) // window) * window


def init_decode_state(batch: int, n_kv: int, head_dim: int, capacity: int,
                      cfg: DecodeConfig, dtype=torch.bfloat16,
                      device=None) -> MiTADecodeState:
    m_max = capacity // cfg.window

    def z(*shape, dt=dtype):
        return torch.zeros((batch, n_kv) + shape, dtype=dt, device=device)

    return MiTADecodeState(
        k_cache=z(capacity, head_dim), v_cache=z(capacity, head_dim),
        lm_q=z(m_max, head_dim), lm_v=z(m_max, head_dim),
        expert_idx=z(m_max, cfg.k, dt=torch.int32),
        expert_valid=z(m_max, cfg.k, dt=torch.bool),
        q_sum=z(head_dim, dt=torch.float32),
        t=torch.zeros((), dtype=torch.int32, device=device))


def mita_prefill_state(q, k, v, cfg: DecodeConfig,
                       capacity: int) -> MiTADecodeState:
    """Decode state from a full-sequence prefill.  q: [B, Hkv, G, N, d];
    k, v: [B, Hkv, 1, N, d].  Landmarks use the training-path functions so
    decode continues exactly where causal MiTA leaves off."""
    b, hkv, _, n, d = q.shape
    w = cfg.window
    m_cnt = n // w
    dtype = k.dtype
    ql = q.mean(dim=2)                                  # [B, Hkv, N, d]
    st = init_decode_state(b, hkv, d, capacity, cfg, dtype=dtype,
                           device=q.device)
    if m_cnt > 0:
        mcfg = mref.MiTAConfig(m=m_cnt, k=cfg.k, s=cfg.s, causal=True)
        q_lm = ql[:, :, : m_cnt * w].reshape(b, hkv, m_cnt, w, d).mean(dim=3)
        s_kv = mref.landmark_scores(k[:, :, 0, :n], q_lm, mcfg)
        idx, valid = mref.topk_indices(s_kv, mcfg)
        v_lm = mref.landmark_values(v[:, :, 0, :n], s_kv)
        st.lm_q[:, :, :m_cnt] = q_lm.to(dtype)
        st.lm_v[:, :, :m_cnt] = v_lm.to(dtype)
        st.expert_idx[:, :, :m_cnt] = idx
        st.expert_valid[:, :, :m_cnt] = valid
    st.k_cache[:, :, :n] = k[:, :, 0]
    st.v_cache[:, :, :n] = v[:, :, 0]
    st.q_sum.copy_(ql[:, :, m_cnt * w:].sum(dim=2).float())
    return st._replace(t=torch.tensor(n, dtype=torch.int32, device=q.device))


# ------------------------------------------------- full-attention baseline --

class FullDecodeState(NamedTuple):
    """Decode cache of the full-attention baseline: k_cache, v_cache
    [B, Hkv, C, d]; t [] int32 (the slot form: leaves [S, 1, ...], t [S])."""

    k_cache: torch.Tensor
    v_cache: torch.Tensor
    t: torch.Tensor


def init_full_state(batch, n_kv, head_dim, capacity, dtype=torch.bfloat16,
                    device=None) -> FullDecodeState:
    def z():
        return torch.zeros((batch, n_kv, capacity, head_dim), dtype=dtype,
                           device=device)

    return FullDecodeState(k_cache=z(), v_cache=z(),
                           t=torch.zeros((), dtype=torch.int32,
                                         device=device))


def full_prefill_state(k, v, capacity: int) -> FullDecodeState:
    """k, v: [B, Hkv, 1, N, d]."""
    b, hkv, _, n, d = k.shape
    st = init_full_state(b, hkv, d, capacity, dtype=k.dtype,
                         device=k.device)
    st.k_cache[:, :, :n] = k[:, :, 0]
    st.v_cache[:, :, :n] = v[:, :, 0]
    return st._replace(t=torch.tensor(n, dtype=torch.int32, device=k.device))


def full_decode_step(state: FullDecodeState, q, k_new, v_new):
    """O(t) per token, the quadratic baseline MiTA replaces.  q:
    [B, Hkv, G, d]; k_new, v_new: [B, Hkv, d].  Returns (out, state with
    t + 1); the caches update in place.  Past the capacity the write lands
    on the last row, as the reference's clamped update does."""
    d = q.shape[-1]
    cap = state.k_cache.shape[-2]
    t = int(state.t)
    state.k_cache[:, :, min(t, cap - 1)] = k_new.to(state.k_cache.dtype)
    state.v_cache[:, :, min(t, cap - 1)] = v_new.to(state.v_cache.dtype)
    logits = torch.einsum("bhgd,bhnd->bhgn", q, state.k_cache) / math.sqrt(d)
    mask = torch.arange(cap, device=q.device)[None, None, None, :] <= t
    out = combine([partial_from_scores(logits, state.v_cache, mask=mask)])
    return out, state._replace(t=state.t + 1)


# -------------------------------------------------------------- slot forms --
#
# The hybrid model's attention layers keep one B == 1 monolithic cache per
# request slot, each at its own position: leaves [S, 1, Hkv, ...] and ``t``
# [S].  The reference vmaps the B == 1 step over the slot axis and masks
# the new state with `core.slotted.where_slots`; here one batched step
# writes in place, and ``commit`` [S] bool names the slots whose state it
# may change (the others stay bit-identical, as the masked vmap leaves
# them).  The outputs of slots outside ``commit`` are computed but mean
# nothing.  Every slot gets the bits of the B == 1 call on its own cache
# (`tests/test_torch_recurrent.py`).


def _slot_append(cache: torch.Tensor, t: torch.Tensor, new: torch.Tensor,
                 commit: torch.Tensor) -> None:
    """cache [S, Hkv, C, d]: row ``t[s]`` of slot s becomes new[s] where
    ``commit[s]``; other slots keep their row (a write of the same bits).
    Past the capacity the write lands on the last row (the reference's
    clamped update)."""
    ar = torch.arange(cache.shape[0], device=cache.device)
    tw = t.long().clamp(max=cache.shape[-2] - 1)
    old = cache[ar, :, tw]
    cache[ar, :, tw] = torch.where(commit[:, None, None],
                                   new.to(cache.dtype), old)


def full_decode_step_slots(state: FullDecodeState, q, k_new, v_new,
                           commit=None):
    """`full_decode_step` for every slot at its own ``t``.  state leaves
    [S, 1, ...], t [S]; q [S, Hkv, G, d]; k_new, v_new [S, Hkv, d];
    commit [S] bool (None: every slot).  Returns (out [S, Hkv, G, d],
    state); in place."""
    s_n, _, _, d = q.shape
    kc, vc = state.k_cache[:, 0], state.v_cache[:, 0]
    cap = kc.shape[-2]
    if commit is None:
        commit = torch.ones(s_n, dtype=torch.bool, device=q.device)
    t = state.t
    _slot_append(kc, t, k_new, commit)
    _slot_append(vc, t, v_new, commit)
    logits = torch.einsum("bhgd,bhnd->bhgn", q, kc) / math.sqrt(d)
    mask = torch.arange(cap, device=q.device)[None, None, None, :] \
        <= t.long()[:, None, None, None]
    out = combine([partial_from_scores(logits, vc, mask=mask)])
    state.t.copy_(torch.where(commit, t + 1, t))
    return out, state


def mita_decode_step_slots(state: MiTADecodeState, q, k_new, v_new,
                           cfg: DecodeConfig, commit=None,
                           due_hint: bool | None = None):
    """`mita_decode_step` for every slot at its own position.

    state: a slot-form `MiTADecodeState` (leaves [S, 1, Hkv, ...], t [S]);
    q [S, Hkv, G, d]; k_new, v_new [S, Hkv, d]; commit [S] bool (None:
    every slot).  Appends go by scatter at each slot's ``t``; the inline
    finalize runs under the per-slot mask ``commit & ((t + 1) % w == 0)``
    (every slot's finalize computed, committed where due, as the vmapped
    ``lax.cond`` of the reference).  ``due_hint`` False, from a caller
    that knows the positions on the host, skips the finalize when no slot
    closes a window.  Returns (out [S, Hkv, G, d], state); in place."""
    s_n, d = q.shape[0], q.shape[-1]
    w = cfg.window
    kc, vc = state.k_cache[:, 0], state.v_cache[:, 0]
    lm_q, lm_v = state.lm_q[:, 0], state.lm_v[:, 0]
    e_idx_c, e_val_c = state.expert_idx[:, 0], state.expert_valid[:, 0]
    qs = state.q_sum[:, 0]
    cap = kc.shape[-2]
    m_max = lm_q.shape[-2]
    dev = q.device
    if commit is None:
        commit = torch.ones(s_n, dtype=torch.bool, device=dev)
    t = state.t.long()

    _slot_append(kc, t, k_new, commit)
    _slot_append(vc, t, v_new, commit)
    qs.copy_(torch.where(commit[:, None, None],
                         qs + q.mean(dim=2).float(), qs))
    t_new = t + 1
    if not cfg.external_finalize and due_hint is not False:
        due = commit & (t_new % w == 0)
        i = (t_new // w - 1).clamp(0, m_max - 1)
        q_lm = (qs / w).to(kc.dtype)                        # [S, Hkv, d]
        scores = torch.einsum("bhnd,bhd->bhn", kc, q_lm) / math.sqrt(d)
        visible = torch.arange(cap, device=dev)[None, None, :] \
            < t_new[:, None, None]
        scores = torch.where(visible, scores.float(), NEG_INF)
        top_vals, top_idx = mref.topk_first(scores, cfg.k)
        p = torch.softmax(scores, dim=-1)
        v_new_lm = torch.einsum("bhn,bhnd->bhd", p.to(vc.dtype), vc)
        sel = (due[:, None] & (torch.arange(m_max, device=dev)[None, :]
                               == i[:, None]))[:, None, :, None]
        lm_q.copy_(torch.where(sel, q_lm[:, :, None, :], lm_q))
        lm_v.copy_(torch.where(sel, v_new_lm.to(lm_v.dtype)[:, :, None, :],
                               lm_v))
        e_idx_c.copy_(torch.where(sel, top_idx.to(torch.int32)[:, :, None],
                                  e_idx_c))
        e_val_c.copy_(torch.where(sel, (top_vals > NEG_INF / 2)[:, :, None],
                                  e_val_c))
        qs.copy_(torch.where(due[:, None, None], 0.0, qs))
    out = _attend(q, kc, vc, lm_q, lm_v, e_idx_c, e_val_c, t, cfg)
    state.t.copy_(torch.where(commit, t_new, t).to(state.t.dtype))
    return out, state


def mita_finalize_if_due(state: MiTADecodeState,
                         cfg: DecodeConfig) -> MiTADecodeState:
    """External-finalize step: no-op off a window boundary."""
    t = int(state.t)
    if t % cfg.window == 0 and t > 0:
        _finalize_window(state, cfg, t)
    return state


def _finalize_window(state: MiTADecodeState, cfg: DecodeConfig,
                     t_new: int) -> None:
    """Finalise landmark i = t_new//w - 1 from the query sum, in place."""
    d = state.k_cache.shape[-1]
    cap = state.k_cache.shape[-2]
    i = t_new // cfg.window - 1
    q_lm = (state.q_sum / cfg.window).to(state.k_cache.dtype)
    scores = torch.einsum("bhnd,bhd->bhn", state.k_cache, q_lm) / math.sqrt(d)
    visible = torch.arange(cap, device=q_lm.device)[None, None, :] < t_new
    scores = torch.where(visible, scores.float(), NEG_INF)
    top_vals, top_idx = mref.topk_first(scores, cfg.k)
    p = torch.softmax(scores, dim=-1)
    v_lm = torch.einsum("bhn,bhnd->bhd", p.to(state.v_cache.dtype),
                        state.v_cache)
    state.lm_q[:, :, i] = q_lm
    state.lm_v[:, :, i] = v_lm.to(state.lm_v.dtype)
    state.expert_idx[:, :, i] = top_idx.to(torch.int32)
    state.expert_valid[:, :, i] = top_vals > NEG_INF / 2
    state.q_sum.zero_()


def _attend(q, kc, vc, lm_q, lm_v, expert_idx, expert_valid, t,
            cfg: DecodeConfig):
    """The three branches of a decode step over B monolithic caches, after
    the append (and the inline finalize): the first ``m_cnt`` landmarks
    (shared), the top-s routed experts' rows, and each query's own window
    [(t//w)*w, t].  q [B, Hkv, G, d]; kc, vc [B, Hkv, C, d]; t [B] the
    position of each row's new token.  Returns [B, Hkv, G, d]."""
    b, hkv, g, d = q.shape
    w = cfg.window
    cap, m_max = kc.shape[-2], lm_q.shape[-2]
    dev = q.device
    t = t.long()
    t_new = t + 1
    m_cnt = t // w if cfg.external_finalize else t_new // w
    lm_mask = torch.arange(m_max, device=dev)[None, None, None, :] \
        < m_cnt[:, None, None, None]

    r = torch.einsum("bhgd,bhmd->bhgm", q, lm_q) / math.sqrt(d)
    r = torch.where(lm_mask, r.float(), NEG_INF)
    parts: list[Partial] = [partial_from_scores(r, lm_v)]

    s_ = min(cfg.s, m_max)
    top_r, e_sel = mref.topk_first(r, s_)                # [B, Hkv, G, s]
    e_ok = top_r > NEG_INF / 2
    flat_e = e_sel.reshape(b, hkv, g * s_)
    sel = flat_e[..., None].expand(flat_e.shape + (cfg.k,))
    rows = torch.gather(expert_idx, 2, sel).long()
    rows_valid = torch.gather(expert_valid, 2, sel)
    rows = rows.reshape(b, hkv, g * s_ * cfg.k)
    idx = rows[..., None].expand(rows.shape + (d,))
    k_sel = torch.gather(kc, 2, idx).reshape(b, hkv, g, s_ * cfg.k, d)
    v_sel = torch.gather(vc, 2, idx).reshape(b, hkv, g, s_ * cfg.k, d)
    logits = torch.einsum("bhgd,bhgkd->bhgk", q, k_sel) / math.sqrt(d)
    mask = (rows_valid.reshape(b, hkv, g, s_, cfg.k)
            & e_ok[..., None]).reshape(b, hkv, g, s_ * cfg.k)
    parts.append(partial_from_logits(logits, v_sel, mask=mask))

    # local: the query's own window; rows past the capacity (a slot whose
    # step is not committed) read the last row, and their output is unused
    start = (t // w) * w
    loc = (start[:, None] + torch.arange(w, device=dev)[None, :]) \
        .clamp(max=cap - 1)                              # [B, w]
    lidx = loc[:, None, :, None].expand(b, hkv, w, d)
    k_loc = torch.gather(kc, 2, lidx)
    v_loc = torch.gather(vc, 2, lidx)
    loc_logits = torch.einsum("bhgd,bhwd->bhgw", q, k_loc) / math.sqrt(d)
    loc_mask = (torch.arange(w, device=dev)[None, :] + start[:, None]) \
        < t_new[:, None]
    parts.append(partial_from_scores(loc_logits, v_loc,
                                     mask=loc_mask[:, None, None, :]))
    return combine(parts)


def mita_decode_step(state: MiTADecodeState, q, k_new, v_new,
                     cfg: DecodeConfig):
    """One decode step.  q: [B, Hkv, G, d]; k_new, v_new: [B, Hkv, d].
    Returns (out [B, Hkv, G, d], state with t + 1); caches in place."""
    b = q.shape[0]
    w = cfg.window
    t = int(state.t)

    state.k_cache[:, :, t] = k_new.to(state.k_cache.dtype)
    state.v_cache[:, :, t] = v_new.to(state.v_cache.dtype)
    state.q_sum.add_(q.mean(dim=2).float())
    t_new = t + 1
    if not cfg.external_finalize and t_new % w == 0:
        _finalize_window(state, cfg, t_new)
    out = _attend(q, state.k_cache, state.v_cache, state.lm_q, state.lm_v,
                  state.expert_idx, state.expert_valid,
                  torch.full((b,), t, device=q.device), cfg)
    return out, state._replace(t=state.t + 1)


# ----------------------------------------------------------- paged decode --
#
# One KV pool per layer shared by every request slot.  A request owns
# window-aligned pages named by its page-table row; row R of the pool is a
# write scratch for inactive slots; expert_idx stores GLOBAL pool rows
# (page_id * window + offset), so the decode gather needs no table lookup.


class PagedMiTAState(NamedTuple):
    """Paged decode cache for one layer, shared across S request slots
    (R = n_pages * window pool rows, M = pages_per_slot, K expert width):
      k_pool, v_pool [R + 1, Hkv, d]  (row R: write scratch)
      lm_q, lm_v [S, Hkv, M, d]; expert_idx [S, Hkv, M, K] int32 global
      rows; expert_valid [S, Hkv, M, K] bool; q_sum [S, Hkv, d] float32;
      pre_lm_q [S, Hkv, M, d] and pre_q_sum [S, Hkv, d] float32 — the
      prompt-window landmark system of chunked prefill (kept for layout
      parity with the reference; the monolithic path leaves them zero).
    Per-slot progress, page tables and activity live on the host and are
    passed into each step."""

    k_pool: torch.Tensor
    v_pool: torch.Tensor
    lm_q: torch.Tensor
    lm_v: torch.Tensor
    expert_idx: torch.Tensor
    expert_valid: torch.Tensor
    q_sum: torch.Tensor
    pre_lm_q: torch.Tensor
    pre_q_sum: torch.Tensor


def init_paged_state(n_kv: int, head_dim: int, n_pages: int, n_slots: int,
                     pages_per_slot: int, cfg: DecodeConfig,
                     dtype=torch.bfloat16, device=None) -> PagedMiTAState:
    rows = n_pages * cfg.window + 1

    def z(*shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=device)

    return PagedMiTAState(
        k_pool=z(rows, n_kv, head_dim), v_pool=z(rows, n_kv, head_dim),
        lm_q=z(n_slots, n_kv, pages_per_slot, head_dim),
        lm_v=z(n_slots, n_kv, pages_per_slot, head_dim),
        expert_idx=z(n_slots, n_kv, pages_per_slot, cfg.k, dt=torch.int32),
        expert_valid=z(n_slots, n_kv, pages_per_slot, cfg.k, dt=torch.bool),
        q_sum=z(n_slots, n_kv, head_dim, dt=torch.float32),
        pre_lm_q=z(n_slots, n_kv, pages_per_slot, head_dim),
        pre_q_sum=z(n_slots, n_kv, head_dim, dt=torch.float32))


def _paged_finalize(state: PagedMiTAState, page_table: torch.Tensor,
                    t_new: torch.Tensor, due: torch.Tensor,
                    cfg: DecodeConfig) -> PagedMiTAState:
    """Finalise landmark i = t_new//w - 1 for every slot with due[s], in
    place (`kernels.ops.paged_finalize`: the CUDA kernel on the card, the
    plain version on the CPU)."""
    ops.paged_finalize(state.q_sum, state.lm_q, state.lm_v, state.expert_idx,
                       state.expert_valid, state.k_pool, state.v_pool,
                       page_table, t_new, due, window=cfg.window,
                       k_width=cfg.k)
    return state


def mita_paged_finalize(state: PagedMiTAState, page_table, t, due,
                        cfg: DecodeConfig) -> PagedMiTAState:
    """External-finalize entry point: ``due`` comes from the scheduler
    (active slots whose last completed window is not finalised yet)."""
    return _paged_finalize(state, page_table, t, due, cfg)


def mita_paged_decode_step(state: PagedMiTAState, q, k_new, v_new,
                           page_table, t, active, cfg: DecodeConfig):
    """One fused decode step for the whole slot batch.

    q: [S, Hkv, G, d]; k_new, v_new: [S, Hkv, d]; page_table: [S, M] int32;
    t: [S] int32 tokens already cached; active: [S] bool.  Returns
    (out [S, Hkv, G, d], state); pools and q_sum are updated in place and
    the caller advances ``t``.  External finalize: the kernel fuses the
    append.  Inline finalize: the append and the finalize run first, since
    the finalize must see the appended row."""
    w = cfg.window
    m_max = state.lm_q.shape[-2]
    s_ = min(cfg.s, m_max)
    state.q_sum.add_(torch.where(active[:, None, None],
                                 q.mean(dim=2).float(), 0.0))
    t_new = t + 1
    if cfg.external_finalize:
        m_cnt = t // w
    else:
        tl = t.long()
        cur_page = page_table.long().gather(1, (tl // w)[:, None])[:, 0]
        scratch = state.k_pool.shape[0] - 1
        rows_new = torch.where(active, cur_page * w + tl % w, scratch)
        ops.scatter_pool_rows(state.k_pool, rows_new, k_new)
        ops.scatter_pool_rows(state.v_pool, rows_new, v_new)
        due = active & (t_new % w == 0)
        _paged_finalize(state, page_table, t_new, due, cfg)
        m_cnt = t_new // w
    out = ops.paged_decode_attend(
        q, k_new, v_new, state.lm_q, state.lm_v, state.expert_idx,
        state.expert_valid, state.k_pool, state.v_pool, page_table, t,
        active, m_cnt, window=w, n_route=s_,
        fuse_append=cfg.external_finalize)
    return out, state


def mita_paged_landmark_attend(state: PagedMiTAState, q, m_cnt,
                               cfg: DecodeConfig) -> torch.Tensor:
    """Landmark-branch-only attention for the speculative drafter: no
    expert gather, no page walk, no append, no ``q_sum`` change.

    q: [S, Hkv, G, d] draft-position queries (RoPE'd by the caller);
    m_cnt: [S] finalised landmark count per slot — only the first
    ``m_cnt`` landmark rows are read.  Returns [S, Hkv, G, d].  A slot
    with ``m_cnt == 0`` attends a zero-value sink (a zero output, no
    NaN).  Scores are masked in float32."""
    d = q.shape[-1]
    m_max = state.lm_q.shape[-2]
    lm_mask = (torch.arange(m_max, device=q.device)[None, None, None, :]
               < m_cnt[:, None, None, None])
    r = torch.einsum("shgd,shmd->shgm", q, state.lm_q) / math.sqrt(d)
    r = torch.where(lm_mask, r.float(), NEG_INF)
    sink = partial_from_scores(
        torch.zeros(r.shape[:-1] + (1,), dtype=torch.float32,
                    device=q.device),
        torch.zeros_like(state.lm_v[:, :, :1]),
        mask=(m_cnt == 0)[:, None, None, None])
    return combine([partial_from_scores(r, state.lm_v), sink])


def pack_prefill_into_pages(state: PagedMiTAState, pre: MiTADecodeState,
                            slot: int, pages: torch.Tensor,
                            cfg: DecodeConfig) -> PagedMiTAState:
    """Copy a single-request monolithic prefill state (B == 1, capacity
    C = P_used * w) into ``slot`` and its ``pages`` [P_used], in place.
    KV rows land at ``pages[c // w] * w + c % w``; expert rows are rebased
    from cache-local to GLOBAL pool rows.  Only ``slot``'s entries and the
    rows of ``pages`` are written."""
    w = cfg.window
    c_pre = pre.k_cache.shape[-2]
    if c_pre % w:
        raise ValueError(f"prefill capacity {c_pre} not window-aligned")
    p_used = c_pre // w
    m_max = state.lm_q.shape[-2]
    m_pre = pre.lm_q.shape[-2]
    if p_used > m_max or m_pre > m_max:
        raise ValueError("request needs more pages than a slot owns")
    pages = pages.long()
    dst_rows = (pages[:, None] * w
                + torch.arange(w, device=pages.device)).reshape(-1)
    state.k_pool[dst_rows] = pre.k_cache[0].transpose(0, 1).to(
        state.k_pool.dtype)
    state.v_pool[dst_rows] = pre.v_cache[0].transpose(0, 1).to(
        state.v_pool.dtype)
    loc = pre.expert_idx[0].long()                       # [Hkv, M', K]
    grows = pages[loc // w] * w + loc % w
    for dst, src in ((state.lm_q, pre.lm_q[0]), (state.lm_v, pre.lm_v[0]),
                     (state.expert_idx, grows),
                     (state.expert_valid, pre.expert_valid[0])):
        dst[slot].zero_()
        dst[slot, :, :m_pre] = src.to(dst.dtype)
    state.q_sum[slot] = pre.q_sum[0]
    return state


# ------------------------------------------------- batched chunked prefill --
#
# `mita_batched_chunk_prefill` advances one chunk for EVERY prefilling slot
# in one dispatch: which slots advance, their resume points, chunk validity
# and the training/decode boundary are data ([P] vectors).  It serves
# non-window-aligned prompts too, replicating the monolithic head's n//m
# quirk with two landmark systems per slot: "A" (the training forward's
# w'-sized prompt windows, `pre_lm_q`/`pre_q_sum`) for prompt positions and
# "B" (the decode cache, `lm_q`/`q_sum`) for the decode state and for
# generated positions of a preemption recompute, which see landmarks with
# decode-time availability.  For window-aligned prompts the two coincide.


def _quirk_windows(n_train: torch.Tensor, w: int):
    """Per-slot prompt landmark structure (m_train, m_a, w_a): the decode
    cache's w-sized prompt windows, and the training forward's
    ``m_a = max(1, m_train)`` landmarks over ``w_a = n_train // m_a``-sized
    windows (w_a == w for window-aligned prompts).  Safe for n_train == 0."""
    m_train = n_train // w
    m_a = torch.clamp(m_train, min=1)
    w_a = torch.clamp(n_train // m_a, min=1)
    return m_train, m_a, w_a


def mita_batched_chunk_prefill(state: PagedMiTAState, q, k, v, page_table,
                               slots, t0, n_valid, n_train, active,
                               cfg: DecodeConfig):
    """Prefill one chunk for every active row in one call.

    q: [P, Hkv, G, nc, d] chunk queries (RoPE'd at ``t0[p] + arange(nc)``);
    k, v: [P, Hkv, nc, d]; page_table: [P, M] int32, the rows' slots' page
    tables (pages covering positions < t0 + n_valid allocated); slots: [P]
    UNIQUE slot ids; t0 / n_valid / n_train: [P] int32 resume point, valid
    tokens and original prompt length; active: [P] bool.  Inactive rows
    leave their slot's state and every owned page bit-identical.

    Returns (out [P, Hkv, G, nc, d], state): the rows' slot state is
    gathered by ``slots``, updated by `kernels.ops.batched_chunk_prefill`
    (the CUDA kernel on the card, the plain version on the CPU) and
    scattered back; the pools are appended to in place."""
    m_slot = page_table.shape[1]
    idx = slots.long()
    rows = [x[idx] for x in (state.lm_q, state.lm_v, state.expert_idx,
                             state.expert_valid, state.q_sum,
                             state.pre_lm_q, state.pre_q_sum)]
    (out, lm_q, lm_v, ei, ev, qs, plm, pqs) = ops.batched_chunk_prefill(
        q, k, v, *rows, state.k_pool, state.v_pool, page_table, t0,
        n_valid, n_train, active, window=cfg.window, k_width=cfg.k,
        n_route=min(cfg.s, m_slot), external_finalize=cfg.external_finalize)
    for dst, src in ((state.lm_q, lm_q), (state.lm_v, lm_v),
                     (state.expert_idx, ei), (state.expert_valid, ev),
                     (state.q_sum, qs), (state.pre_lm_q, plm),
                     (state.pre_q_sum, pqs)):
        dst[idx] = src.to(dst.dtype)
    return out, state


# ------------------------------------------------- per-job chunked prefill --
#
# `mita_chunk_prefill` is the per-job form: one chunk of ONE slot's
# window-aligned prompt (or recompute stream).  The reference computes it in
# plain XLA (it reaches no Pallas kernel: it takes only the page gathers of
# `kernels.ops`), so plain PyTorch on the card is its faithful port, not a
# fallback.  Positions >= n_train replicate the decode step's landmark
# availability (external finalize: the last token of a window routes one
# expert stale), positions < n_train the training forward's.


def mita_chunk_prefill(state: PagedMiTAState, q, k, v, page_table, slot: int,
                       t0: int, n_valid: int, n_train: int,
                       cfg: DecodeConfig):
    """Prefill one chunk of one slot into the paged pool.

    q: [Hkv, G, nc, d] chunk queries (RoPE'd at ``t0 + arange(nc)``); k, v:
    [Hkv, nc, d]; page_table: [M] int32, the slot's row (pages covering
    positions < t0 + n_valid allocated); slot, t0 (tokens already packed;
    need not be window-aligned: the open window resumes from ``q_sum``),
    n_valid (valid tokens; padding rows go to the scratch row, their
    outputs mean nothing) and n_train (the original prompt length) are
    host integers.  Returns (out [Hkv, G, nc, d], state): the pools get
    the chunk's rows and the slot's landmark, expert and ``q_sum`` rows
    are updated, in place."""
    w = cfg.window
    hkv, g, nc, d = q.shape
    dev = q.device
    m_slot = page_table.shape[0]
    ctx = m_slot * w
    scratch = state.k_pool.shape[0] - 1
    pt = page_table.long()

    pos = t0 + torch.arange(nc, device=dev)              # [nc]
    valid_tok = torch.arange(nc, device=dev) < n_valid

    # 1. append the chunk's rows (padding -> the scratch row)
    page_idx = (pos // w).clamp(0, m_slot - 1)
    dst = torch.where(valid_tok, pt[page_idx] * w + pos % w, scratch)
    state.k_pool[dst] = k.transpose(0, 1).to(state.k_pool.dtype)
    state.v_pool[dst] = v.transpose(0, 1).to(state.v_pool.dtype)
    owned = torch.tensor([(t0 + n_valid + w - 1) // w], device=dev)
    k_ctx = ops.gather_pages(state.k_pool, pt[None], w, owned=owned)[0]
    v_ctx = ops.gather_pages(state.v_pool, pt[None], w, owned=owned)[0]

    # 2. finalise every window the chunk completes ([m0, m_new)), resuming
    # the open window's query sum from the previous chunk
    m0 = t0 // w
    m_new = (t0 + n_valid) // w
    li = torch.arange(m_slot, device=dev)
    ql = q.mean(dim=1)                                   # [Hkv, nc, d]
    win_of = pos // w
    tok_in_win = valid_tok[None, :] & (win_of[None, :] == li[:, None])
    sums = torch.einsum("mn,hnd->hmd", tok_in_win.float(), ql.float())
    qs_slot = state.q_sum[slot]
    if t0 % w:
        resume = (li == m0)[None, :, None]
        sums = sums + torch.where(resume, qs_slot[:, None, :], 0.0)

    q_lm_new = (sums / w).to(state.k_pool.dtype)         # [Hkv, M, d]
    ends = (li + 1) * w
    s_lm = torch.einsum("chd,hmd->hmc", k_ctx, q_lm_new) / math.sqrt(d)
    vis = torch.arange(ctx, device=dev)[None, None, :] < ends[None, :, None]
    s_lm = torch.where(vis, s_lm.float(), NEG_INF)
    top_vals, top_loc = mref.topk_first(s_lm, cfg.k)     # ctx positions
    new_valid = top_vals > NEG_INF / 2
    ctx_rows = (pt[:, None] * w
                + torch.arange(w, device=dev)[None, :]).reshape(ctx)
    new_rows = ctx_rows[top_loc].to(torch.int32)
    p_lm = torch.softmax(s_lm, dim=-1)
    v_lm_new = torch.einsum("hmc,chd->hmd", p_lm.to(state.v_pool.dtype),
                            v_ctx)

    commit = ((li >= m0) & (li < m_new))[None, :, None]
    lm_q_s = torch.where(commit, q_lm_new, state.lm_q[slot])
    lm_v_s = torch.where(commit, v_lm_new.to(state.lm_v.dtype),
                         state.lm_v[slot])
    ei_s = torch.where(commit, new_rows, state.expert_idx[slot])
    ev_s = torch.where(commit, new_valid, state.expert_valid[slot])
    # the open window after the chunk: its tail in this chunk, plus the
    # resumed sum if the chunk closed no window at all
    tail = torch.einsum("n,hnd->hd",
                        (valid_tok & (win_of == m_new)).float(), ql.float())
    q_sum_s = tail + qs_slot if (m_new == m0 and t0 % w) else tail + 0.0

    # 3. the chunk's attention: shared + routed + local, per-position
    # landmark availability (training rule below n_train, decode rule past)
    is_train = (pos < n_train)[:, None]
    avail_train = ends[None, :] <= pos[:, None] + 1
    avail_dec = ends[None, :] <= pos[:, None] if cfg.external_finalize \
        else avail_train
    avail = torch.where(is_train, avail_train, avail_dec)       # [nc, M]

    r = torch.einsum("hgnd,hmd->hgnm", q, lm_q_s) / math.sqrt(d)
    r = torch.where(avail[None, None], r.float(), NEG_INF)
    parts: list[Partial] = [partial_from_scores(r, lm_v_s[:, None])]

    s_ = min(cfg.s, m_slot)
    top_r, e_idx = mref.topk_first(r, s_)               # [Hkv, G, nc, s]
    e_ok = top_r > NEG_INF / 2
    flat_e = e_idx.reshape(hkv, g * nc * s_)
    sel = flat_e[..., None].expand(flat_e.shape + (cfg.k,))
    rows = torch.gather(ei_s, 1, sel)
    rows_valid = torch.gather(ev_s, 1, sel)
    rows = rows.reshape(hkv, g * nc * s_ * cfg.k)
    k_sel = ops.gather_pool_rows(state.k_pool, rows[None])[0].reshape(
        hkv, g, nc, s_ * cfg.k, d)
    v_sel = ops.gather_pool_rows(state.v_pool, rows[None])[0].reshape(
        hkv, g, nc, s_ * cfg.k, d)
    logits = torch.einsum("hgnd,hgnkd->hgnk", q, k_sel) / math.sqrt(d)
    mask = (rows_valid.reshape(hkv, g, nc, s_, cfg.k)
            & e_ok[..., None]).reshape(hkv, g, nc, s_ * cfg.k)
    parts.append(partial_from_logits(logits, v_sel, mask=mask))

    # local: each position attends its own window, which may start in an
    # earlier chunk (resume); the gathered context covers both
    loc_idx = ((pos // w).clamp(0, m_slot - 1) * w)[:, None] \
        + torch.arange(w, device=dev)[None, :]           # [nc, w]
    k_loc = torch.movedim(k_ctx[loc_idx], 2, 0)          # [Hkv, nc, w, d]
    v_loc = torch.movedim(v_ctx[loc_idx], 2, 0)
    loc_logits = torch.einsum("hgnd,hnwd->hgnw", q, k_loc) / math.sqrt(d)
    loc_mask = (loc_idx <= pos[:, None])[None, None]
    parts.append(partial_from_logits(loc_logits, v_loc[:, None],
                                     mask=loc_mask))

    out = combine(parts)
    for dst_t, src in ((state.lm_q, lm_q_s), (state.lm_v, lm_v_s),
                       (state.expert_idx, ei_s),
                       (state.expert_valid, ev_s), (state.q_sum, q_sum_s)):
        dst_t[slot] = src.to(dst_t.dtype)
    return out, state
