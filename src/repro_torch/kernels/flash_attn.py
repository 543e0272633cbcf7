"""Blocked flash attention: CUDA kernel + plain PyTorch version.

Port of ``repro.kernels.flash_attn.flash_attention`` (Pallas) and of its
oracle ``repro.kernels.ref.flash_attention_ref``: q [B, H, N, d], k / v
[B, H, Nk, d] -> [B, H, N, d] in q's dtype, causal (row i sees keys
0..i, also when Nk != N) or full.

* `flash_attention` launches ``csrc/flash_attn.cu`` on CUDA tensors and
  adds one to ``LAUNCHES``.  `flash_path` names the kernel a call takes:
  bf16 at head dim 64 or 128 runs on the tensor cores (wgmma; the softmax
  weights are rounded to bf16 before the value product, as the reference
  oracle rounds them), float32 and the other head dims on the CUDA cores
  in float32.
* `flash_attention_plain` is the same function in plain PyTorch: q is
  scaled in float32, the softmax weights stay float32 and the output is
  rounded once.

Both keep the JAX contract: ``block_q`` / ``block_k`` (capped at N / Nk)
must divide N / Nk, else ValueError; neither changes the result.  No
model path calls this kernel; its one entry point is
`repro_torch.kernels.ops.flash_attention`.
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.device import NEG_INF
from repro_torch.kernels import _build

LAUNCHES = 0            # kernel launches since the last reset


def check_blocks(q, k, v, block_q: int, block_k: int) -> None:
    """The JAX kernel's shape contract."""
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape \
            or k.shape[:2] != q.shape[:2] or k.shape[-1] != q.shape[-1]:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)}: expected [B, H, N, d] and "
                         "[B, H, Nk, d]")
    n, nk = q.shape[-2], k.shape[-2]
    if n % min(block_q, n) or nk % min(block_k, nk):
        raise ValueError("sequence length must divide block size")


def flash_attention_plain(q, k, v, causal: bool = False, block_q: int = 128,
                          block_k: int = 128):
    """Plain PyTorch version of the kernel."""
    check_blocks(q, k, v, block_q, block_k)
    n, nk, d = q.shape[-2], k.shape[-2], q.shape[-1]
    s = (q.float() * (1.0 / math.sqrt(d))) @ k.float().transpose(-1, -2)
    if causal:
        rows = torch.arange(n, device=q.device)[:, None]
        s = torch.where(torch.arange(nk, device=q.device) <= rows, s,
                        NEG_INF)
    mx = s.amax(dim=-1, keepdim=True)
    safe = torch.where(mx == NEG_INF, 0.0, mx)
    p = torch.where(s == NEG_INF, 0.0, torch.exp(s - safe))
    l = p.sum(dim=-1, keepdim=True)
    return ((p @ v.float()) / torch.where(l == 0.0, 1.0, l)).to(q.dtype)


TENSOR_CORES = "tensor cores (wgmma, bf16)"
CUDA_CORES = "CUDA cores (float32)"


def flash_path(dtype: torch.dtype, d: int) -> str:
    """The kernel a CUDA call with this dtype and head dim runs."""
    return TENSOR_CORES if dtype == torch.bfloat16 and d in (64, 128) \
        else CUDA_CORES


def _lib():
    lib = _build.load("flash_attn")
    fn = lib.flash_attention
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [i] + [p] * 4 + [i] * 5 + [ctypes.c_float, p]
        fn.restype = ctypes.c_int
        mma = lib.flash_attention_mma
        mma.argtypes = [p] * 4 + [i] * 5 + [ctypes.c_float, p]
        mma.restype = ctypes.c_int
    return lib


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"flash_attention: {msg}")


def flash_attention(q, k, v, causal: bool = False, block_q: int = 128,
                    block_k: int = 128):
    """Launch the CUDA kernel.  q, k, v float32 or bfloat16 (one dtype),
    head dim a multiple of 16 up to 128."""
    global LAUNCHES
    check_blocks(q, k, v, block_q, block_k)
    dt, dev = q.dtype, q.device
    _check(dev.type == "cuda", "needs CUDA tensors")
    _check(dt in (torch.float32, torch.bfloat16),
           f"dtype {dt} (float32 or bfloat16 only)")
    _check(k.dtype == dt and v.dtype == dt, "q, k, v dtypes differ")
    _check(k.device == dev and v.device == dev,
           "all tensors must be on one device")
    b, h, n, d = q.shape
    nk = k.shape[-2]
    _check(d % 16 == 0 and 16 <= d <= 128,
           f"head dim {d} (a multiple of 16, at most 128)")
    o = torch.empty_like(q, memory_format=torch.contiguous_format)
    if b * h * n == 0:
        return o
    # the kernels read 16-byte vectors (a copy realigns an odd view)
    args = [a if a.data_ptr() % 16 == 0 else a.clone()
            for a in (q.contiguous(), k.contiguous(), v.contiguous())]
    ptrs = [a.data_ptr() for a in args] + [o.data_ptr()]
    stream = torch.cuda.current_stream(dev).cuda_stream
    if flash_path(dt, d) == TENSOR_CORES:
        err = _lib().flash_attention_mma(*ptrs, b * h, n, nk, d, int(causal),
                                         1.0 / math.sqrt(d), stream)
    else:
        err = _lib().flash_attention(0 if dt == torch.float32 else 1, *ptrs,
                                     b * h, n, nk, d, int(causal),
                                     1.0 / math.sqrt(d), stream)
    _build.check(err, "flash_attention launch")
    LAUNCHES += 1
    return o
