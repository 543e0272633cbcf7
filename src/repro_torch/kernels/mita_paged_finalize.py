"""Fused paged landmark finalize: CUDA kernel + plain PyTorch version.

Port of ``repro.kernels.mita_paged_finalize.mita_paged_finalize_fused``
(Pallas).  Every ``window`` tokens a slot's open window completes: its
pooled query becomes a landmark row, and the landmark's scores over the
slot's whole context give a fresh top-K expert gather (global pool rows)
and the landmark value (softmax-weighted sum of V).

* `mita_paged_finalize_fused` launches ``csrc/mita_paged_finalize.cu``
  on CUDA tensors -- a split stage (one block per page of each due
  slot's context and KV head: scores into a float32 workspace row and
  per-split softmax partials) and a merge stage (one block per (slot, KV
  head): the exact top-K of the row, by radix select for K <= 128, and
  the partials merged in split order) -- and adds one to ``LAUNCHES``
  per call.
* `paged_finalize_plain` is the same function in plain PyTorch, following
  the XLA oracle of ``core.mita_decode._paged_finalize``.

Both commit IN PLACE at window ordinal ``t_new // w - 1`` (when it lies
in [0, M)) for ``due`` slots only and zero the q_sum of every due slot;
the reference returns new arrays instead.  Cast points: the plain
version casts the softmax weights to the pool dtype before the value sum
(as XLA does), the kernel keeps them in float32 (as the Pallas kernel
does); below float32 the two differ within the bf16 tolerance.
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.core.mita import topk_first
from repro_torch.device import NEG_INF
from repro_torch.kernels import _build
from repro_torch.kernels.ops import gather_pages

LAUNCHES = 0            # calls of the kernel since the last reset


def paged_finalize_plain(q_sum, lm_q, lm_v, expert_idx, expert_valid,
                         k_pool, v_pool, page_table, t_new, due, *,
                         window: int, k_width: int,
                         round_dtype=None) -> None:
    """Plain PyTorch version of the kernel (the XLA oracle), in place.

    The landmark query ``q_sum / w`` is rounded to ``round_dtype``
    (default: the pool dtype) before it is stored and scored, as the
    kernel rounds it.  A check of the bfloat16 kernel runs this version on
    float32 copies with ``round_dtype=torch.bfloat16``, so both round the
    landmark query at the same point and score it in float32."""
    w = window
    n_slots, hkv, m_max, _ = expert_idx.shape
    d = k_pool.shape[-1]
    ctx = m_max * w
    tn = t_new.long()
    owned = (tn + w - 1) // w
    k_ctx = gather_pages(k_pool, page_table, w, owned=owned)  # [S,ctx,H,d]
    v_ctx = gather_pages(v_pool, page_table, w, owned=owned)
    q_lm = (q_sum / w).to(round_dtype or k_pool.dtype).to(k_pool.dtype)

    scores = torch.einsum("schd,shd->shc", k_ctx, q_lm) / math.sqrt(d)
    visible = torch.arange(ctx, device=q_sum.device)[None, None, :] \
        < tn[:, None, None]
    scores = torch.where(visible, scores.float(), NEG_INF)
    top_vals, top_loc = topk_first(scores, k_width)          # [S, H, K]
    valid = top_vals > NEG_INF / 2
    ctx_rows = (page_table.long()[:, :, None] * w
                + torch.arange(w, device=q_sum.device)).reshape(n_slots, ctx)
    rows = torch.gather(ctx_rows[:, None, :].expand(n_slots, hkv, ctx), -1,
                        top_loc)
    p = torch.softmax(scores, dim=-1)
    v_lm = torch.einsum("shc,schd->shd", p.to(v_pool.dtype), v_ctx)

    i = tn // w - 1
    sel = due[:, None] & (torch.arange(m_max, device=q_sum.device)[None, :]
                          == i[:, None])
    sel4 = sel[:, None, :, None]
    lm_q.copy_(torch.where(sel4, q_lm[:, :, None, :], lm_q))
    lm_v.copy_(torch.where(sel4, v_lm[:, :, None, :].to(lm_v.dtype), lm_v))
    expert_idx.copy_(torch.where(sel4, rows[:, :, None, :].to(
        expert_idx.dtype), expert_idx))
    expert_valid.copy_(torch.where(sel4, valid[:, :, None, :],
                                   expert_valid))
    q_sum.copy_(torch.where(due[:, None, None], 0.0, q_sum))


SPLIT, MERGE = 0, 1      # the kernel's two stages, launched in this order
SORT_N = 1024            # least sort buffer of the merge's sorted top-K
SORT_SMEM = 48 * 1024    # larger sort buffers go to global memory


def _lib():
    lib = _build.load("mita_paged_finalize")
    fn = lib.mita_paged_finalize
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [i, i] + [p] * 15 + [i] * 7 + [p]
        fn.restype = ctypes.c_int
    return lib


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"mita_paged_finalize_fused: {msg}")


def sort_size(k_width: int) -> int:
    """Keys in the merge's sort buffer: a power of two >= 2K, at least
    `SORT_N` (``csrc/topk_sort.cuh`` takes K <= half the buffer)."""
    return max(SORT_N, 1 << (2 * k_width - 1).bit_length())


def _ws_sizes(n_slots: int, hkv: int, m_slot: int, window: int,
              d: int) -> list[int]:
    """Words of each part of the workspace: scores, m, l, o."""
    sh, ctx = n_slots * hkv, m_slot * window
    return [sh * ctx, sh * m_slot, sh * m_slot, sh * m_slot * d]


def workspace_views(call: dict) -> dict:
    """The float32 workspace of a `prepare`d call, one buffer: ``scores``
    [S, Hkv, ctx] (each (slot, head)'s score row over its context, written
    by the split stage, ranked by the merge) and the splits' softmax
    partials ``m``, ``l`` [S, Hkv, M] and ``o`` [S, Hkv, M, d] (split j is
    page j of the context)."""
    n_slots, hkv, m_slot, d, _, w, _ = call["dims"]
    sc, m, l, o = call["ws"].split(_ws_sizes(n_slots, hkv, m_slot, w, d))
    return {"scores": sc.view(n_slots, hkv, m_slot * w),
            "m": m.view(n_slots, hkv, m_slot),
            "l": l.view(n_slots, hkv, m_slot),
            "o": o.view(n_slots, hkv, m_slot, d)}


def prepare(q_sum, lm_q, lm_v, expert_idx, expert_valid, k_pool, v_pool,
            page_table, t_new, due, *, window: int, k_width: int) -> dict:
    """Check the operands of one call and allocate its workspace (one
    float32 buffer, `workspace_views`); returns the call, whose stages
    `launch_stage` runs on the current stream.  Shapes as
    `mita_paged_finalize_fused`."""
    dt = k_pool.dtype
    _check(dt in (torch.float32, torch.bfloat16),
           f"pool dtype {dt} (float32 or bfloat16 only)")
    dev = k_pool.device
    _check(dev.type == "cuda", "needs CUDA tensors")
    n_slots, hkv, m_slot, d = lm_q.shape
    k_w = expert_idx.shape[-1]
    ctx = m_slot * window
    _check(k_w == k_width, "k_width must match expert_idx")
    _check(k_w <= ctx, f"k_width {k_w} exceeds the slot context {ctx}")
    _check(q_sum.dtype == torch.float32 and q_sum.shape == (n_slots, hkv, d),
           "q_sum must be float32 [S, Hkv, d]")
    _check(lm_v.shape == lm_q.shape and lm_q.dtype == dt
           and lm_v.dtype == dt, "landmark shape/dtype")
    _check(expert_idx.dtype == torch.int32 and expert_valid.dtype
           == torch.bool and expert_valid.shape == expert_idx.shape,
           "expert_idx int32 / expert_valid bool")
    _check(v_pool.shape == k_pool.shape and v_pool.dtype == dt
           and k_pool.shape[1:] == (hkv, d), "pool shape/dtype")
    _check(page_table.shape == (n_slots, m_slot), "page_table shape")
    for x in (q_sum, lm_q, lm_v, expert_idx, expert_valid):
        _check(x.is_contiguous(), "state tensors must be contiguous "
               "(updated in place)")
    for x in (q_sum, lm_q, lm_v, expert_idx, expert_valid, v_pool,
              page_table, t_new, due):
        _check(x.device == dev, "all tensors must be on one device")
    sizes = _ws_sizes(n_slots, hkv, m_slot, window, d)
    ws = torch.empty(sum(sizes), dtype=torch.float32, device=dev)
    sort_n = sort_size(k_w)
    sort_ws = (torch.empty(n_slots * hkv * sort_n, dtype=torch.int64,
                           device=dev) if sort_n * 8 > SORT_SMEM else None)
    keep = (k_pool.contiguous(), v_pool.contiguous(),
            page_table.to(torch.int32).contiguous(),
            t_new.to(torch.int32).contiguous(),
            due.to(torch.bool).contiguous().view(torch.uint8))
    base = ws.data_ptr()
    offs = [base + 4 * sum(sizes[:i]) for i in range(len(sizes))]
    args = (0 if dt == torch.float32 else 1, q_sum.data_ptr(),
            lm_q.data_ptr(), lm_v.data_ptr(), expert_idx.data_ptr(),
            expert_valid.data_ptr(), *[x.data_ptr() for x in keep], *offs,
            None if sort_ws is None else sort_ws.data_ptr(), n_slots, hkv,
            m_slot, d, k_w, window, sort_n,
            torch.cuda.current_stream(dev).cuda_stream)
    return dict(args=args, keep=keep, ws=ws, sort_ws=sort_ws,
                dims=(n_slots, hkv, m_slot, d, k_w, window, sort_n))


def launch_stage(call: dict, stage: int) -> None:
    """Launch one stage (`SPLIT`, then `MERGE`) of a `prepare`d call."""
    err = _lib().mita_paged_finalize(stage, *call["args"])
    _build.check(err, f"mita_paged_finalize stage {stage} launch")


def mita_paged_finalize_fused(q_sum, lm_q, lm_v, expert_idx, expert_valid,
                              k_pool, v_pool, page_table, t_new, due, *,
                              window: int, k_width: int) -> None:
    """Launch the CUDA kernel (in place): the split stage, then the merge
    stage; one count in ``LAUNCHES`` per call.

    q_sum: [S, Hkv, d] float32; lm_q/lm_v: [S, Hkv, M, d] in the pool
    dtype; expert_idx: [S, Hkv, M, K] int32; expert_valid: [S, Hkv, M, K]
    bool -- all contiguous, updated in place; k_pool/v_pool: [R + 1, Hkv, d]
    float32 or bfloat16 (read only); page_table: [S, M] int32; t_new: [S]
    int32 positions after the step; due: [S] bool.
    """
    global LAUNCHES
    call = prepare(q_sum, lm_q, lm_v, expert_idx, expert_valid, k_pool,
                   v_pool, page_table, t_new, due, window=window,
                   k_width=k_width)
    launch_stage(call, SPLIT)
    launch_stage(call, MERGE)
    LAUNCHES += 1
