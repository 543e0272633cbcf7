"""Fused batched chunk prefill: CUDA kernel + plain PyTorch version.

Port of ``repro.kernels.mita_chunk_prefill.mita_chunk_prefill_fused``
(Pallas).  One prefill chunk for every row (a job: one prefilling slot)
of the serving engine's batched chunk program:

  * append the chunk's valid K/V rows to the row's pages, in place;
  * resume both open-window query sums -- the decode cache's w-sized
    windows (B system: ``lm_q``/``q_sum``) and the training head's
    ``n // m``-sized prompt windows (A system: ``pre_lm_q``/``pre_q_sum``)
    -- and commit every landmark the chunk completes, with its top-K
    expert rows (GLOBAL pool rows) and its value;
  * shared + routed + local attention for every chunk position, prompt
    positions (< ``n_train``) through the A system, generated positions
    (the preemption-recompute shape) through the B system with decode-time
    landmark availability.

* `mita_chunk_prefill_fused` launches ``csrc/mita_chunk_prefill.cu`` on
  CUDA tensors (three ordered CUDA launches: append, landmark, attend) and
  adds one to ``LAUNCHES``.  `chunk_path` names the attend step a call
  takes: bf16 at head dim 64 or 128 on the tensor cores, float32 and the
  other head dims on the CUDA cores in float32.
* `chunk_prefill_plain` is the same function in plain PyTorch, a port of
  the XLA oracle ``core.mita_decode._batched_chunk_prefill_xla``.
* `topk_sort_keys` mirrors on the host the packed keys of the kernel's
  sort-based top-K (``csrc/topk_sort.cuh``).

Both take the rows' compact ``[P, ...]`` state, return the updated state
as new tensors (inputs are left as they were) and write the pools in
place.  Cast points: the plain version casts the landmark softmax weights
to the pool dtype before the value sum (as XLA does); the kernel keeps
them in float32 (as the Pallas kernel does), and on the tensor cores it
rounds the attention weights and the A-system landmark values to bf16
before their value products.  Below float32 the two differ within the
bf16 tolerance.
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.core.combine import (Partial, combine, partial_from_logits,
                                      partial_from_scores)
from repro_torch.core.mita import topk_first
from repro_torch.core.mita_decode import _quirk_windows
from repro_torch.device import NEG_INF
from repro_torch.kernels import _build
from repro_torch.kernels.ops import gather_pages, gather_pool_rows

LAUNCHES = 0            # kernel launches since the last reset
SMEM_LIMIT = 227 * 1024


def chunk_prefill_plain(q, k, v, lm_q, lm_v, expert_idx, expert_valid,
                        q_sum, pre_lm_q, pre_q_sum, k_pool, v_pool,
                        page_table, t0, n_valid, n_train, active, *,
                        window: int, k_width: int, n_route: int = 1,
                        external_finalize: bool = True, round_dtype=None):
    """Plain PyTorch version of the kernel (the XLA oracle).  Shapes as
    `mita_chunk_prefill_fused`.  Returns (out, lm_q, lm_v, expert_idx,
    expert_valid, q_sum, pre_lm_q, pre_q_sum); the pools gain the chunk's
    rows in place (padding and inactive rows write the scratch row).

    Landmark queries are rounded to ``round_dtype`` (default: the pool
    dtype) before they are stored and scored, as the reference rounds
    them.  A check of the bfloat16 kernel runs this version on float32
    copies with ``round_dtype=torch.bfloat16``, so both round the
    landmark queries at the same point and score them in float32."""
    w = window
    p_rows, hkv, g, nc, d = q.shape
    m_slot = page_table.shape[1]
    ctx = m_slot * w
    scratch = k_pool.shape[0] - 1
    pdt = k_pool.dtype
    rdt = round_dtype or pdt
    dev = q.device
    s_ = n_route
    t0, n_valid, n_train = t0.long(), n_valid.long(), n_train.long()
    pt = page_table.long()
    ar = torch.arange(nc, device=dev)
    pos = t0[:, None] + ar                              # [P, nc]
    valid = (ar[None, :] < n_valid[:, None]) & active[:, None]
    li = torch.arange(m_slot, device=dev)
    cpos = torch.arange(ctx, device=dev)
    m_train, m_a, w_a = _quirk_windows(n_train, w)

    # 1. append (a token's context index IS its position)
    page_idx = torch.clamp(pos // w, 0, m_slot - 1)
    dst = torch.where(valid, pt.gather(1, page_idx) * w + pos % w, scratch)
    k_pool[dst.reshape(-1)] = k.transpose(1, 2).reshape(-1, hkv, d).to(pdt)
    v_pool[dst.reshape(-1)] = v.transpose(1, 2).reshape(-1, hkv, d).to(pdt)
    owned = (t0 + n_valid + w - 1) // w
    k_ctx = gather_pages(k_pool, page_table, w, owned=owned)  # [P,ctx,H,d]
    v_ctx = gather_pages(v_pool, page_table, w, owned=owned)
    ql32 = q.mean(dim=2).float()                        # [P, H, nc, d]

    # 2. B system: the decode cache
    win_b = pos // w
    tok_b = valid[:, None, :] & (win_b[:, None, :] == li[None, :, None])
    sums_b = torch.einsum("smn,shnd->shmd", tok_b.float(), ql32)
    m0 = t0 // w
    resume_b = (li[None, :] == m0[:, None]) & (t0 % w != 0)[:, None]
    sums_b = sums_b + torch.where(resume_b[:, None, :, None],
                                  q_sum[:, :, None, :], 0.0)
    q_lm_b = (sums_b / w).to(rdt).to(pdt)
    wend = (li + 1) * w
    new_end = t0 + n_valid
    qdone_b = (active[:, None] & (wend[None, :] > t0[:, None])
               & (wend[None, :] <= new_end[:, None]))
    lm_q_s = torch.where(qdone_b[:, None, :, None], q_lm_b, lm_q)

    ends_b = torch.where(li[None, :] < m_train[:, None],
                         (li[None, :] + 1) * w_a[:, None], wend[None, :])
    s_b = torch.einsum("schd,shmd->shmc", k_ctx, lm_q_s) / math.sqrt(d)
    vis_b = cpos[None, None, :] < ends_b[:, :, None]
    s_b = torch.where(vis_b[:, None], s_b.float(), NEG_INF)
    top_vals, top_loc = topk_first(s_b, k_width)        # [P, H, M, K]
    new_valid = top_vals > NEG_INF / 2
    ctx_rows = (pt[:, :, None] * w
                + torch.arange(w, device=dev)).reshape(p_rows, ctx)
    new_rows = torch.gather(
        ctx_rows[:, None, None, :].expand(p_rows, hkv, m_slot, ctx), -1,
        top_loc)
    p_b = torch.softmax(s_b, dim=-1)
    v_lm_b = torch.einsum("shmc,schd->shmd", p_b.to(pdt), v_ctx)
    scommit = (active[:, None] & (ends_b > t0[:, None])
               & (ends_b <= new_end[:, None]))
    sc4 = scommit[:, None, :, None]
    lm_v_s = torch.where(sc4, v_lm_b.to(lm_v.dtype), lm_v)
    ei_s = torch.where(sc4, new_rows.to(expert_idx.dtype), expert_idx)
    ev_s = torch.where(sc4, new_valid, expert_valid.bool())
    m_new = new_end // w
    q_sum_s = torch.where((li[None, :] == m_new[:, None])[:, None, :, None],
                          sums_b, 0.0).sum(dim=2)
    q_sum_s = torch.where(active[:, None, None], q_sum_s, q_sum)

    # 3. A system: the training head's prompt windows
    is_tr = pos < n_train[:, None]
    win_a = pos // w_a[:, None]
    tok_a = ((valid & is_tr)[:, None, :]
             & (win_a[:, None, :] == li[None, :, None]))
    sums_a = torch.einsum("smn,shnd->shmd", tok_a.float(), ql32)
    m0_a = t0 // w_a
    resume_a = ((li[None, :] == m0_a[:, None])
                & ((t0 % w_a != 0) & (t0 < n_train))[:, None])
    sums_a = sums_a + torch.where(resume_a[:, None, :, None],
                                  pre_q_sum[:, :, None, :], 0.0)
    q_lm_a = (sums_a / w_a[:, None, None, None].float()).to(rdt).to(pdt)
    ends_a = (li[None, :] + 1) * w_a[:, None]           # [P, M]
    qdone_a = (active[:, None] & (ends_a > t0[:, None])
               & (ends_a <= new_end[:, None]) & (li[None, :] < m_a[:, None]))
    pre_lm_q_s = torch.where(qdone_a[:, None, :, None], q_lm_a, pre_lm_q)
    open_a = new_end // w_a
    pre_q_sum_s = torch.where(
        (li[None, :] == open_a[:, None])[:, None, :, None], sums_a,
        0.0).sum(dim=2)
    pre_q_sum_s = torch.where(active[:, None, None], pre_q_sum_s, pre_q_sum)

    if bool((active & (n_train % w != 0)).any()):
        # the quirk build: A products from the w_a-pooled queries
        s_a = torch.einsum("schd,shmd->shmc", k_ctx, pre_lm_q_s) \
            / math.sqrt(d)
        vis_a = ((cpos[None, None, :] < ends_a[:, :, None])
                 & (li[None, :, None] < m_a[:, None, None]))
        s_a = torch.where(vis_a[:, None], s_a.float(), NEG_INF)
        tv_a, tl_a = topk_first(s_a, k_width)
        v_lm_a = torch.einsum("shmc,schd->shmd",
                              torch.softmax(s_a, dim=-1).to(pdt), v_ctx)
        val_a = tv_a > NEG_INF / 2
    else:
        # all rows aligned: the A system IS the B system on every
        # landmark a prompt position can see
        v_lm_a, tl_a, val_a = v_lm_b, top_loc, new_valid

    k_ctx_h = k_ctx.transpose(1, 2)                     # [P, H, ctx, d]
    v_ctx_h = v_ctx.transpose(1, 2)

    def shared_routed(lm_q_sys, lm_v_sys, avail):
        r = torch.einsum("shgnd,shmd->shgnm", q, lm_q_sys) / math.sqrt(d)
        r = torch.where(avail[:, None, None], r.float(), NEG_INF)
        shared = partial_from_scores(
            r, lm_v_sys[:, :, None].expand(p_rows, hkv, g, m_slot, d))
        top_r, e_idx = topk_first(r, s_)                # [P, H, G, nc, s]
        return shared, e_idx, top_r > NEG_INF / 2

    def routed(e_idx, e_ok, rows_of, valid_of):
        """Routed partial over the picked landmarks' expert rows:
        ``rows_of(flat_e)`` gives their K/V rows [P, H, G*nc*s*K, d]."""
        fe = e_idx.reshape(p_rows, hkv, g * nc * s_)
        k_sel, v_sel = (x.reshape(p_rows, hkv, g, nc, s_ * k_width, d)
                        for x in rows_of(fe))
        ok = torch.gather(valid_of, 2, fe[..., None].expand(
            p_rows, hkv, g * nc * s_, k_width))
        lg = torch.einsum("shgnd,shgnkd->shgnk", q, k_sel) / math.sqrt(d)
        mask = (ok.reshape(p_rows, hkv, g, nc, s_, k_width)
                & e_ok[..., None]).reshape(p_rows, hkv, g, nc, s_ * k_width)
        return partial_from_logits(lg, v_sel, mask=mask)

    # A system partials (prompt positions)
    avail_a = ((ends_a[:, None, :] <= pos[:, :, None] + 1)
               & (li[None, None, :] < m_a[:, None, None]) & is_tr[:, :, None])
    sh_a, e_a, eok_a = shared_routed(pre_lm_q_s, v_lm_a, avail_a)

    def rows_a(fe):
        loc = torch.gather(tl_a.reshape(p_rows, hkv, m_slot * k_width), 2,
                           (fe[..., None] * k_width
                            + torch.arange(k_width, device=dev)).reshape(
                                p_rows, hkv, -1))
        idx = loc[..., None].expand(loc.shape + (d,))
        return (torch.gather(k_ctx_h, 2, idx), torch.gather(v_ctx_h, 2, idx))

    ro_a = routed(e_a, eok_a, rows_a, val_a)

    # B system partials (generated positions: decode-time availability)
    off = 0 if external_finalize else 1
    avail_b = ((wend[None, None, :] <= pos[:, :, None] + off)
               & ~is_tr[:, :, None])
    sh_b, e_b, eok_b = shared_routed(lm_q_s, lm_v_s, avail_b)

    def rows_b(fe):
        rows = torch.gather(ei_s.reshape(p_rows, hkv, m_slot * k_width), 2,
                            (fe[..., None] * k_width
                             + torch.arange(k_width, device=dev)).reshape(
                                 p_rows, hkv, -1))
        return gather_pool_rows(k_pool, rows), gather_pool_rows(v_pool, rows)

    ro_b = routed(e_b, eok_b, rows_b, ev_s)

    # local: each position's own window (w_a-sized in the prompt, w-sized
    # past it; w_a <= 2w - 1, so a 2w-wide gather covers both)
    lw = 2 * w
    start = torch.where(is_tr, win_a * w_a[:, None], (pos // w) * w)
    loc_pos = start[:, :, None] + torch.arange(lw, device=dev)
    loc_idx = torch.clamp(loc_pos, 0, ctx - 1).reshape(p_rows, 1, nc * lw, 1)
    k_loc, v_loc = (torch.gather(x, 2, loc_idx.expand(p_rows, hkv, nc * lw,
                                                      d)).reshape(
                        p_rows, hkv, 1, nc, lw, d).expand(
                            p_rows, hkv, g, nc, lw, d)
                    for x in (k_ctx_h, v_ctx_h))
    s_loc = torch.einsum("shgnd,shgnwd->shgnw", q, k_loc) / math.sqrt(d)
    local = partial_from_logits(
        s_loc, v_loc, mask=(loc_pos <= pos[:, :, None])[:, None, None])

    sel = is_tr[:, None, None, :]                       # over [P, H, G, nc]

    def pick(a: Partial, b: Partial) -> Partial:
        return Partial(o=torch.where(sel[..., None], a.o, b.o),
                       m=torch.where(sel, a.m, b.m),
                       l=torch.where(sel, a.l, b.l))

    out = combine([pick(sh_a, sh_b), pick(ro_a, ro_b), local])
    out = torch.where(active[:, None, None, None, None], out, 0.0)
    return (out, lm_q_s, lm_v_s, ei_s, ev_s, q_sum_s, pre_lm_q_s,
            pre_q_sum_s)


TENSOR_CORES = "tensor cores (wgmma, bf16)"
CUDA_CORES = "CUDA cores (float32)"
SORT_N = 1024           # the kernel's top-K sort buffer: K <= SORT_N / 2


def chunk_path(dtype: torch.dtype, d: int) -> str:
    """The attend step a CUDA call with this pool dtype and head dim
    runs."""
    return TENSOR_CORES if dtype == torch.bfloat16 and d in (64, 128) \
        else CUDA_CORES


def topk_sort_keys(scores: torch.Tensor) -> torch.Tensor:
    """The kernel's top-K keys on the host: one int64 per score (last
    axis = candidate index) whose order is the device key's unsigned
    order, so a descending sort of the keys is ``lax.top_k``'s order
    (scores descending, ties by ascending index; -0 ties with +0).
    ``~keys & 0xFFFFFFFF`` is the index."""
    s = scores.float().contiguous()
    s = torch.where(s == 0, torch.zeros_like(s), s)
    u = s.view(torch.int32).long() & 0xFFFFFFFF
    hi = torch.where(u >= 1 << 31, ~u & 0xFFFFFFFF, u | 1 << 31)
    lo = ~torch.arange(s.shape[-1], device=s.device) & 0xFFFFFFFF
    # unsigned 64-bit order as signed int64: the high word less 2^31
    return ((hi - (1 << 31)) << 32) | lo


def _lib():
    lib = _build.load("mita_chunk_prefill")
    fn = lib.mita_chunk_prefill
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [i, p] + [i] * 10 + [p]
        fn.restype = ctypes.c_int
        sb = lib.mita_chunk_prefill_smem_bytes
        sb.argtypes = [i] * 6
        sb.restype = ctypes.c_longlong
    return lib


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"mita_chunk_prefill_fused: {msg}")


def mita_chunk_prefill_fused(q, k, v, lm_q, lm_v, expert_idx, expert_valid,
                             q_sum, pre_lm_q, pre_q_sum, k_pool, v_pool,
                             page_table, t0, n_valid, n_train, active, *,
                             window: int, k_width: int, n_route: int = 1,
                             external_finalize: bool = True):
    """Launch the CUDA kernel.

    q: [P, Hkv, G, nc, d]; k/v: [P, Hkv, nc, d]; lm_q/lm_v/pre_lm_q:
    [P, Hkv, M, d] in the pool dtype; expert_idx: [P, Hkv, M, K] int32
    GLOBAL pool rows; expert_valid: [P, Hkv, M, K] bool; q_sum/pre_q_sum:
    [P, Hkv, d] float32; k_pool/v_pool: [R + 1, Hkv, d] float32 or
    bfloat16, contiguous, appended to in place; page_table: [P, M] int32;
    t0/n_valid/n_train: [P] int32; active: [P] bool.  d must be a
    multiple of 32 up to 128, G at most 64 and K at most 512.

    Returns (out [P, Hkv, G, nc, d] (zeros past n_valid and on inactive
    rows), lm_q, lm_v, expert_idx, expert_valid (bool), q_sum, pre_lm_q,
    pre_q_sum) as new tensors; inactive rows pass through bit for bit.
    """
    global LAUNCHES
    dt = k_pool.dtype
    _check(dt in (torch.float32, torch.bfloat16),
           f"pool dtype {dt} (float32 or bfloat16 only)")
    dev = k_pool.device
    _check(dev.type == "cuda", "needs CUDA tensors")
    p_rows, hkv, g, nc, d = q.shape
    m_slot, k_w = expert_idx.shape[-2:]
    ctx = m_slot * window
    _check(k_w == k_width, "k_width must match expert_idx")
    _check(k_w <= ctx, f"k_width {k_w} exceeds the slot context {ctx}")
    _check(d % 32 == 0 and d <= 128, f"head dim {d} (multiple of 32, <= 128)")
    _check(1 <= g <= 64, f"group size {g} (at most 64)")
    _check(k_w <= SORT_N // 2, f"k_width {k_w} (at most {SORT_N // 2})")
    _check(1 <= n_route <= m_slot, f"n_route {n_route}")
    _check(k.shape == v.shape == (p_rows, hkv, nc, d), "k/v shape")
    _check(v_pool.shape == k_pool.shape and v_pool.dtype == dt
           and k_pool.shape[1:] == (hkv, d), "pool shape/dtype")
    _check(k_pool.is_contiguous() and v_pool.is_contiguous(),
           "pools must be contiguous (appended to in place)")
    _check(k_pool.data_ptr() % 16 == 0 and v_pool.data_ptr() % 16 == 0,
           "pools must be 16-byte aligned (read as 16-byte vectors)")
    for x in (lm_q, lm_v, pre_lm_q):
        _check(x.shape == (p_rows, hkv, m_slot, d) and x.dtype == dt,
               "landmark shape/dtype")
    _check(expert_idx.shape == expert_valid.shape
           and expert_idx.shape[:2] == (p_rows, hkv), "expert shape")
    for x in (q_sum, pre_q_sum):
        _check(x.shape == (p_rows, hkv, d) and x.dtype == torch.float32,
               "q_sum/pre_q_sum must be float32 [P, Hkv, d]")
    _check(page_table.shape == (p_rows, m_slot), "page_table shape")
    for x in (q, k, v, lm_q, lm_v, expert_idx, expert_valid, q_sum,
              pre_lm_q, pre_q_sum, v_pool, page_table, t0, n_valid, n_train,
              active):
        _check(x.device == dev, "all tensors must be on one device")
    lib = _lib()
    dcode = 0 if dt == torch.float32 else 1
    smem = lib.mita_chunk_prefill_smem_bytes(dcode, d, m_slot, window, k_w,
                                             n_route)
    _check(smem <= SMEM_LIMIT, f"needs {smem} B of shared memory")

    def aligned(x):     # the kernels read 16-byte vectors
        x = x.contiguous()
        return x if x.data_ptr() % 16 == 0 else x.clone()

    ins = [aligned(q.to(dt)), aligned(k.to(dt)), aligned(v.to(dt)),
           q_sum.contiguous(), pre_q_sum.contiguous(), k_pool, v_pool,
           page_table.to(torch.int32).contiguous(),
           t0.to(torch.int32).contiguous(),
           n_valid.to(torch.int32).contiguous(),
           n_train.to(torch.int32).contiguous(),
           active.to(torch.bool).contiguous().view(torch.uint8)]
    out = torch.empty((p_rows, hkv, g, nc, d), dtype=dt, device=dev)
    # the state on entry, read as it is where it has the kernel's types;
    # the kernel writes the state on exit whole
    state_in = [lm_q.contiguous(), lm_v.contiguous(),
                expert_idx.to(torch.int32).contiguous(),
                expert_valid.to(torch.bool).contiguous(),
                pre_lm_q.contiguous()]
    outs = [torch.empty_like(x, memory_format=torch.contiguous_format)
            for x in (state_in[0], state_in[1], state_in[2], state_in[3],
                      q_sum, state_in[4], pre_q_sum)]
    ws_v = torch.empty((p_rows, hkv, m_slot, d), dtype=torch.float32,
                       device=dev)
    ws_i = torch.empty((p_rows, hkv, m_slot, k_w), dtype=torch.int32,
                       device=dev)
    ptrs = [x.data_ptr() for x in ins + [out] + outs + [ws_v, ws_i]
            + state_in]
    err = lib.mita_chunk_prefill(
        dcode, (ctypes.c_void_p * len(ptrs))(*ptrs), p_rows, hkv, g, nc, d,
        m_slot, k_w, window, n_route, int(external_finalize),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "mita_chunk_prefill launch")
    LAUNCHES += 1
    return (out, *outs)
