"""Fused paged-decode MiTA attention: CUDA kernel + plain PyTorch version.

Port of ``repro.kernels.mita_paged_attn.mita_paged_attention`` (Pallas).
One decode step of the serving engine's paged cache: optional in-place
append of the new K/V row, then the shared-landmark, local-window and
routed-expert branches merged with one guarded online softmax.

* `mita_paged_attention` launches ``csrc/mita_paged_attn.cu`` on CUDA
  tensors and adds one to ``LAUNCHES`` per call.  The call makes two CUDA
  launches: `split_plan` spreads each (slot, KV head)'s keys over
  ``n_split`` blocks that write float32 partials (o, m, l) into a
  workspace, and a second kernel merges them in split order.
* `paged_attention_plain` is the same function in plain PyTorch,
  following the XLA oracle of ``core.mita_decode.mita_paged_decode_step``;
  the CPU path and the on-card comparisons use it.

Both update the pools IN PLACE (the reference donates and aliases them):
with ``fuse_append`` the new row lands at ``page_table[s, t//w]*w + t%w``,
or at the trailing scratch row R for an inactive slot.  Several inactive
slots may write row R at once; nothing reads it.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

from repro_torch.core.combine import (combine, partial_from_logits,
                                      partial_from_scores)
from repro_torch.core.mita import topk_first
from repro_torch.device import NEG_INF
from repro_torch.kernels import _build
from repro_torch.kernels.ops import (gather_pages, gather_pool_rows,
                                     scatter_pool_rows)

LAUNCHES = 0            # kernel launches since the last reset
SMEM_LIMIT = 227 * 1024
MAX_CHUNKS = 128        # 16-byte chunks of a row: one per thread at most


class SplitPlan(NamedTuple):
    """How the kernel spreads the keys of one (slot, KV head) over blocks:
    split 0 takes the shared landmarks (and the fused append), splits
    1 .. ``n_local`` the current page in slices of ``rows`` positions, the
    last ``n_routed`` splits the routed experts as (round, slice) pairs of
    ``rows`` expert rows each (round = index // ceil(K / rows))."""

    rows: int
    n_local: int
    n_routed: int

    @property
    def n_split(self) -> int:
        return 1 + self.n_local + self.n_routed


def split_plan(k_w: int, window: int, n_route: int, g: int) -> SplitPlan:
    """The split of a call with expert width ``k_w``, page ``window``,
    ``n_route`` routed experts and ``g`` query heads per KV head.  A block
    scores G x rows keys: 64 keys a block, rows between 8 and 64.  It
    depends on these shapes only -- never on the number of slots, on t or
    on which slots are active -- so a slot's output does not depend on its
    batch neighbours."""
    rows = max(8, min(64, 64 // max(g, 1)))
    return SplitPlan(rows=rows, n_local=-(-window // rows),
                     n_routed=n_route * -(-k_w // rows))


def paged_attention_plain(q, k_new, v_new, lm_q, lm_v, expert_idx,
                          expert_valid, k_pool, v_pool, page_table, t,
                          active, m_cnt, *, window: int, n_route: int,
                          fuse_append: bool) -> torch.Tensor:
    """Plain PyTorch version of the kernel (the XLA oracle's branch math).
    Shapes as `mita_paged_attention`; returns out [S, Hkv, G, d]."""
    n_slots, hkv, g, d = q.shape
    w = window
    m_max, k_w = expert_idx.shape[-2:]
    scratch = k_pool.shape[0] - 1
    tl = t.long()
    cur_page = page_table.long().gather(1, (tl // w)[:, None])[:, 0]
    if fuse_append:
        rows_new = torch.where(active, cur_page * w + tl % w, scratch)
        scatter_pool_rows(k_pool, rows_new, k_new)
        scatter_pool_rows(v_pool, rows_new, v_new)

    lm_mask = (torch.arange(m_max, device=q.device)[None, None, None, :]
               < m_cnt.long()[:, None, None, None])
    r = torch.einsum("shgd,shmd->shgm", q, lm_q) / math.sqrt(d)
    r = torch.where(lm_mask, r.float(), NEG_INF)
    parts = [partial_from_scores(r, lm_v)]

    top_r, e_idx = topk_first(r, n_route)               # [S, Hkv, G, s]
    e_ok = top_r > NEG_INF / 2
    flat_e = e_idx.reshape(n_slots, hkv, g * n_route)
    sel = flat_e[..., None].expand(flat_e.shape + (k_w,))
    rows = torch.gather(expert_idx, 2, sel)
    rows_valid = torch.gather(expert_valid, 2, sel)
    rows = rows.reshape(n_slots, hkv, g * n_route * k_w)
    k_sel = gather_pool_rows(k_pool, rows).reshape(
        n_slots, hkv, g, n_route * k_w, d)
    v_sel = gather_pool_rows(v_pool, rows).reshape(
        n_slots, hkv, g, n_route * k_w, d)
    logits = torch.einsum("shgd,shgkd->shgk", q, k_sel) / math.sqrt(d)
    mask = (rows_valid.reshape(n_slots, hkv, g, n_route, k_w)
            & e_ok[..., None]).reshape(n_slots, hkv, g, n_route * k_w)
    parts.append(partial_from_logits(logits, v_sel, mask=mask))

    k_loc = gather_pages(k_pool, cur_page[:, None], w).transpose(1, 2)
    v_loc = gather_pages(v_pool, cur_page[:, None], w).transpose(1, 2)
    loc_logits = torch.einsum("shgd,shwd->shgw", q, k_loc) / math.sqrt(d)
    start = (tl // w) * w
    loc_mask = (torch.arange(w, device=q.device)[None, :] + start[:, None]
                < (tl + 1)[:, None])[:, None, None, :]
    parts.append(partial_from_scores(loc_logits, v_loc, mask=loc_mask))

    out = combine(parts)
    return torch.where(active[:, None, None, None], out, 0.0)


def _lib():
    lib = _build.load("mita_paged_attn")
    fn = lib.mita_paged_attention
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = ([i] + [p] * 15 + [i] * 7
                       + [ctypes.c_longlong] + [i] * 4 + [p])
        fn.restype = ctypes.c_int
        sb = lib.mita_paged_attention_smem_bytes
        sb.argtypes = [i] * 6
        sb.restype = ctypes.c_longlong
    return lib


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"mita_paged_attention: {msg}")


def mita_paged_attention(q, k_new, v_new, lm_q, lm_v, expert_idx,
                         expert_valid, k_pool, v_pool, page_table, t,
                         active, m_cnt, *, window: int, n_route: int = 1,
                         fuse_append: bool = True) -> torch.Tensor:
    """Launch the CUDA kernel.

    q: [S, Hkv, G, d]; k_new/v_new: [S, Hkv, d]; lm_q/lm_v: [S, Hkv, M, d]
    in the pool dtype; expert_idx: [S, Hkv, M, K] int32 GLOBAL pool rows;
    expert_valid: [S, Hkv, M, K] bool; k_pool/v_pool: [R + 1, Hkv, d]
    float32 or bfloat16, contiguous, updated in place; page_table: [S, M]
    int32; t: [S] int32; active: [S] bool; m_cnt: [S] int32 landmarks
    visible to this step.  Returns out [S, Hkv, G, d] in the pool dtype.
    """
    global LAUNCHES
    dt = k_pool.dtype
    _check(dt in (torch.float32, torch.bfloat16),
           f"pool dtype {dt} (float32 or bfloat16 only)")
    dev = k_pool.device
    _check(dev.type == "cuda", "needs CUDA tensors")
    n_slots, hkv, g, d = q.shape
    m_slot, k_w = expert_idx.shape[-2:]
    rows_total = k_pool.shape[0]
    _check(v_pool.shape == k_pool.shape and v_pool.dtype == dt,
           "k_pool/v_pool mismatch")
    _check(k_pool.shape[1:] == (hkv, d), "pool shape")
    _check(k_pool.is_contiguous() and v_pool.is_contiguous(),
           "pools must be contiguous (updated in place)")
    _check(lm_q.shape == (n_slots, hkv, m_slot, d) and lm_q.shape
           == lm_v.shape, "landmark shape")
    _check(lm_q.dtype == dt and lm_v.dtype == dt, "landmark dtype")
    _check(expert_valid.shape == expert_idx.shape
           and expert_idx.shape[:2] == (n_slots, hkv), "expert shape")
    _check(page_table.shape == (n_slots, m_slot), "page_table shape")
    for x in (q, k_new, v_new, lm_q, lm_v, expert_idx, expert_valid,
              v_pool, page_table, t, active, m_cnt):
        _check(x.device == dev, "all tensors must be on one device")
    plan = split_plan(k_w, window, n_route, g)
    args = [q.to(dt).contiguous(), k_new.to(dt).contiguous(),
            v_new.to(dt).contiguous(), lm_q.contiguous(),
            lm_v.contiguous(), expert_idx.to(torch.int32).contiguous(),
            expert_valid.to(torch.bool).contiguous().view(torch.uint8),
            k_pool, v_pool, page_table.to(torch.int32).contiguous(),
            t.to(torch.int32).contiguous(),
            active.to(torch.bool).contiguous().view(torch.uint8),
            m_cnt.to(torch.int32).contiguous()]
    # key and value rows are read as 16-byte vectors
    v = 16 // k_pool.element_size()
    _check(d % v == 0 and d // v <= MAX_CHUNKS,
           f"head dim {d} (a multiple of {v}, at most {v * MAX_CHUNKS})")
    _check(k_pool.data_ptr() % 16 == 0 and v_pool.data_ptr() % 16 == 0,
           "pools must be 16-byte aligned (updated in place)")
    args = [a if a.data_ptr() % 16 == 0 else a.clone() for a in args]
    lib = _lib()
    smem = lib.mita_paged_attention_smem_bytes(g, d, m_slot, plan.rows, v,
                                               plan.n_split)
    _check(smem <= SMEM_LIMIT, f"needs {smem} B of shared memory")
    ws = torch.empty(n_slots * hkv * plan.n_split * g * (d + 2),
                     dtype=torch.float32, device=dev)
    out = torch.empty((n_slots, hkv, g, d), dtype=dt, device=dev)
    err = lib.mita_paged_attention(
        0 if dt == torch.float32 else 1,
        *[a.data_ptr() for a in args], ws.data_ptr(), out.data_ptr(),
        n_slots, hkv, g, d, m_slot, k_w, window, rows_total,
        int(fuse_append), plan.rows, plan.n_local, plan.n_split,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "mita_paged_attention launch")
    LAUNCHES += 1
    return out
