"""Dispatch layer of the port's kernels (port of ``repro.kernels.ops``).

`paged_decode_attend`, `paged_finalize` and `batched_chunk_prefill` are
the only points where the serving path reaches a kernel;
`routed_expert_partial` is where the full-sequence forward reaches one
(``impl="pallas"``), and `flash_attention` is the one entry of the flash
kernel, which no model path calls.  The tensors decide where it runs:

* all on the CPU  -> the plain PyTorch version beside the kernel;
* all on CUDA     -> the hand-written CUDA kernel, or an error is raised;
* mixed devices   -> an error;
* fake tensors (a dry run's trace) -> an error.

Nothing on a CUDA tensor ever falls back to the plain version, so there
is no fallback counter to keep: the backend's ``*_kernel_fallbacks`` stats
stay in the schema and read 0.  Each kernel wrapper counts its own
launches (`launch_counts`).

The page-pool gathers below are shared by the plain versions and the
model code; pools are [R + 1, Hkv, d] with row = page_id * page + offset
and the trailing row R a write scratch.
"""

from __future__ import annotations

import os

import torch
from torch._subclasses.fake_tensor import FakeTensor

DEFAULT_BLOCK_Q = 128
DEFAULT_BLOCK_K = 128


def default_block_q() -> int:
    """Query block of the full-sequence paths: ``REPRO_BLOCK_Q`` or 128."""
    return int(os.environ.get("REPRO_BLOCK_Q", DEFAULT_BLOCK_Q))


def default_block_k() -> int:
    return int(os.environ.get("REPRO_BLOCK_K", DEFAULT_BLOCK_K))


def gather_pool_rows(pool: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """pool [R, Hkv, d]; rows [S, Hkv, n] global row ids -> [S, Hkv, n, d]."""
    hkv = pool.shape[1]
    heads = torch.arange(hkv, device=pool.device)[None, :, None]
    return pool.transpose(0, 1)[heads, rows.long()]


def gather_pages(pool: torch.Tensor, page_ids: torch.Tensor, page_size: int,
                 owned: torch.Tensor | None = None) -> torch.Tensor:
    """Whole pages in page-table order: pool [R, Hkv, d], page_ids [S, P]
    -> [S, P * page_size, Hkv, d].  Entries at ordinal >= ``owned[s]`` read
    the trailing scratch row instead of another request's page."""
    rows = page_ids.long()[..., None] * page_size \
        + torch.arange(page_size, device=pool.device)
    if owned is not None:
        scratch = pool.shape[0] - 1
        is_owned = (torch.arange(page_ids.shape[-1], device=pool.device)
                    [None, :, None] < owned.long()[:, None, None])
        rows = torch.where(is_owned, rows, scratch)
    return pool[rows.reshape(rows.shape[:-2] + (-1,))]


def scatter_pool_rows(pool: torch.Tensor, rows: torch.Tensor,
                      new: torch.Tensor) -> torch.Tensor:
    """Write one row per slot in place: pool [R, Hkv, d], rows [S], new
    [S, Hkv, d].  Scratch-row duplicates are allowed (inactive slots)."""
    pool[rows.long()] = new.to(pool.dtype)
    return pool


def _device_of(*tensors: torch.Tensor) -> str:
    if any(isinstance(x, FakeTensor) for x in tensors):
        # a dry run's trace (`launch.dryrun`): the kernels have no fake
        # implementation, and a trace does not take the plain version
        raise NotImplementedError(
            "a port kernel reached on fake tensors: kernels have no fake "
            "implementation")
    kinds = {x.device.type for x in tensors}
    if len(kinds) != 1:
        raise ValueError(f"tensors on mixed devices: {sorted(kinds)}")
    kind = kinds.pop()
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"no kernel or plain path for device {kind!r}")
    return kind


def paged_decode_attend(q, k_new, v_new, lm_q, lm_v, expert_idx,
                        expert_valid, k_pool, v_pool, page_table, t, active,
                        m_cnt, *, window: int, n_route: int,
                        fuse_append: bool) -> torch.Tensor:
    """Fused decode step: (append +) three-branch attend.  Returns out
    [S, Hkv, G, d]; with ``fuse_append`` the pools gain the new row in
    place.  See `kernels.mita_paged_attn.mita_paged_attention`."""
    from repro_torch.kernels import mita_paged_attn as mpa
    args = (q, k_new, v_new, lm_q, lm_v, expert_idx, expert_valid, k_pool,
            v_pool, page_table, t, active, m_cnt)
    fn = (mpa.mita_paged_attention if _device_of(*args) == "cuda"
          else mpa.paged_attention_plain)
    return fn(*args, window=window, n_route=n_route, fuse_append=fuse_append)


def paged_finalize(q_sum, lm_q, lm_v, expert_idx, expert_valid, k_pool,
                   v_pool, page_table, t_new, due, *, window: int,
                   k_width: int) -> None:
    """Window finalize for every ``due`` slot, IN PLACE on q_sum, lm_q,
    lm_v, expert_idx and expert_valid; other slots stay bit-identical.
    See `kernels.mita_paged_finalize.mita_paged_finalize_fused`."""
    from repro_torch.kernels import mita_paged_finalize as mpf
    args = (q_sum, lm_q, lm_v, expert_idx, expert_valid, k_pool, v_pool,
            page_table, t_new, due)
    fn = (mpf.mita_paged_finalize_fused if _device_of(*args) == "cuda"
          else mpf.paged_finalize_plain)
    fn(*args, window=window, k_width=k_width)


def batched_chunk_prefill(q, k, v, lm_q, lm_v, expert_idx, expert_valid,
                          q_sum, pre_lm_q, pre_q_sum, k_pool, v_pool,
                          page_table, t0, n_valid, n_train, active, *,
                          window: int, k_width: int, n_route: int,
                          external_finalize: bool):
    """One prefill chunk for every row: appends to the pools in place and
    returns (out, lm_q, lm_v, expert_idx, expert_valid, q_sum, pre_lm_q,
    pre_q_sum) for the rows' compact state (``expert_valid`` bool).  The
    kernel chooses its own tiling; nothing here sizes it.  See
    `kernels.mita_chunk_prefill.mita_chunk_prefill_fused`."""
    from repro_torch.kernels import mita_chunk_prefill as mcp
    args = (q, k, v, lm_q, lm_v, expert_idx, expert_valid, q_sum, pre_lm_q,
            pre_q_sum, k_pool, v_pool, page_table, t0, n_valid, n_train,
            active)
    fn = (mcp.mita_chunk_prefill_fused if _device_of(*args) == "cuda"
          else mcp.chunk_prefill_plain)
    return fn(*args, window=window, k_width=k_width, n_route=n_route,
              external_finalize=external_finalize)


def routed_expert_partial(q_sorted, assign, k_e, v_e, valid,
                          block_q: int | None = None):
    """Routed-expert partials (o, m, l) of sub-queries sorted by expert:
    q_sorted [..., NS, d], assign [..., NS] (``>= M`` inactive), k_e / v_e
    [kv_lead..., M, K, d] and valid [kv_lead..., M, K], where kv_lead may
    hold broadcast-1 dims.  NS need not divide any block.  Forward only,
    on either device.  See
    `kernels.mita_expert_attn.mita_expert_attention`."""
    from repro_torch.kernels import mita_expert_attn as mea
    mea.check_forward_only(q_sorted, k_e, v_e)
    args = (q_sorted, assign, k_e, v_e, valid)
    fn = (mea.mita_expert_attention if _device_of(*args) == "cuda"
          else mea.expert_attention_plain)
    block_q = min(block_q or default_block_q(), q_sorted.shape[-2])
    return fn(*args, block_q=block_q)


def flash_attention(q, k, v, causal: bool = False,
                    block_q: int | None = None, block_k: int | None = None):
    """[B, H, N, d] flash attention; ``block_q`` / ``block_k`` must divide
    N / Nk (the JAX contract).  See `kernels.flash_attn.flash_attention`."""
    from repro_torch.kernels import flash_attn as fa
    fn = (fa.flash_attention if _device_of(q, k, v) == "cuda"
          else fa.flash_attention_plain)
    return fn(q, k, v, causal=causal, block_q=block_q or default_block_q(),
              block_k=block_k or default_block_k())


def _kernel_modules():
    from repro_torch.kernels import flash_attn as fa
    from repro_torch.kernels import mita_chunk_prefill as mcp
    from repro_torch.kernels import mita_expert_attn as mea
    from repro_torch.kernels import mita_paged_attn as mpa
    from repro_torch.kernels import mita_paged_finalize as mpf
    return {"mita_paged_attention": mpa, "mita_paged_finalize_fused": mpf,
            "mita_chunk_prefill_fused": mcp, "mita_expert_attention": mea,
            "flash_attention": fa}


def launch_counts() -> dict[str, int]:
    """Kernel launches per kernel since the last `reset_launch_counts`."""
    return {name: mod.LAUNCHES for name, mod in _kernel_modules().items()}


def reset_launch_counts() -> None:
    for mod in _kernel_modules().values():
        mod.LAUNCHES = 0
