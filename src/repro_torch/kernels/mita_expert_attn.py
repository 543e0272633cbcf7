"""Routed-expert attention partials: CUDA kernel + plain PyTorch version.

Port of ``repro.kernels.mita_expert_attn.mita_expert_attention`` (Pallas)
and of its oracle ``repro.kernels.ref.mita_expert_attention_ref``: the
routed branch of the full-sequence MiTA forward (paper Alg. 1 line 14).
Each sub-query row attends the K key/value rows of its own expert
``assign`` (validity-masked) and returns the un-normalised online-softmax
partial ``(o, m, l)``; an inactive row (``assign >= M``) gives exactly
``o = 0``, ``m = NEG_INF``, ``l = 0``.

* `mita_expert_attention` launches ``csrc/mita_expert_attn.cu`` on CUDA
  tensors (one CUDA launch a call) and adds one to ``LAUNCHES``.
  `expert_path` names the kernel a call takes: bf16 at head dim 64 or 128
  runs on the tensor cores (wgmma; the softmax weights are rounded to bf16
  before the value product), float32 and the other head dims (up to 256)
  on the CUDA cores in float32.
* `expert_attention_plain` is the same function in plain PyTorch with the
  CUDA-core kernel's rounding: q is scaled in float32 before the product,
  every product and statistic is float32, and o is rounded to q's dtype
  once at the end (the reference oracle multiplies in the input dtype).
  ``round_p=True`` also rounds the softmax weights to bf16 before the
  value product, as the tensor-core kernel does.

Both take any query lead: q [..., NS, d], assign [..., NS], k_e / v_e
[kv_lead..., M, K, d] and valid [kv_lead..., M, K], where ``kv_lead`` may
hold broadcast-1 dims (GQA: one expert bank per KV head serves its G query
heads).  The kernel finds the KV lead row of each query lead row from the
KV lead's broadcast strides (`kv_lead_strides`) and never makes the G
copies that the JAX wrapper (``ops.routed_expert_partial``) makes.
``block_q`` keeps its place in the signature; neither version depends on
it (the kernel tiles by itself and walks the distinct experts of each
tile, so neither the tiling nor the sort order changes the result).

Forward only, as in the JAX package, whose Pallas call has no VJP: the
kernel wrapper raises on inputs that require grad.
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.device import NEG_INF
from repro_torch.kernels import _build

LAUNCHES = 0            # kernel launches since the last reset
SMEM_LIMIT = 227 * 1024
MAX_D = 256             # the CUDA-core kernel's widest head dim


def _shapes(q_sorted, assign, k_e, v_e, valid):
    """(lead, kv_lead, ns, d, m, kw) after checking that the operands fit
    together; raises ValueError otherwise."""
    lead = tuple(q_sorted.shape[:-2])
    ns, d = q_sorted.shape[-2:]
    m, kw = k_e.shape[-3], k_e.shape[-2]
    kv_lead = tuple(k_e.shape[:-3])
    if k_e.shape[-1] != d or v_e.shape != k_e.shape:
        raise ValueError(f"k_e {tuple(k_e.shape)} / v_e {tuple(v_e.shape)} "
                         f"do not match q {tuple(q_sorted.shape)}")
    if tuple(valid.shape) != kv_lead + (m, kw):
        raise ValueError(f"valid {tuple(valid.shape)} != kv lead + (M, K)")
    if torch.broadcast_shapes(kv_lead, lead) != lead:
        raise ValueError(f"kv lead {kv_lead} does not broadcast to the "
                         f"query lead {lead}")
    if torch.broadcast_shapes(tuple(assign.shape), lead + (ns,)) \
            != lead + (ns,):
        raise ValueError(f"assign {tuple(assign.shape)} does not broadcast "
                         f"to {lead + (ns,)}")
    return lead, kv_lead, ns, d, m, kw


def check_forward_only(*tensors) -> None:
    """Raise when autograd would need a backward: the expert kernel has
    none, in this package as in the JAX one."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            "mita_expert_attention is forward only (the JAX kernel has no "
            "VJP either): call it under torch.no_grad() or on tensors that "
            "do not require grad")


def expert_attention_plain(q_sorted, assign, k_e, v_e, valid,
                           block_q: int = 128, round_p: bool = False):
    """Plain PyTorch version of the kernel.  Returns (o [..., NS, d] in
    q's dtype, m [..., NS] float32, l [..., NS] float32).  ``round_p``
    rounds the softmax weights to bf16 before the value product (l keeps
    them in float32), as the tensor-core kernel does."""
    _, kv_lead, _, d, m, kw = _shapes(q_sorted, assign, k_e, v_e, valid)
    qf = q_sorted.float() * (1.0 / math.sqrt(d))
    kf = k_e.float().reshape(kv_lead + (m * kw, d))
    vf = v_e.float().reshape(kv_lead + (m * kw, d))
    scores = qf @ kf.transpose(-1, -2)                  # [..., NS, M*K]
    expert_of_lane = torch.arange(m, device=q_sorted.device) \
        .repeat_interleave(kw)
    mask = (assign.long()[..., None] == expert_of_lane) \
        & valid.reshape(kv_lead + (1, m * kw))
    scores = torch.where(mask, scores, NEG_INF)
    mx = scores.amax(dim=-1)
    safe = torch.where(mx == NEG_INF, 0.0, mx)
    p = torch.where(mask, torch.exp(scores - safe[..., None]), 0.0)
    pv = p.to(torch.bfloat16).float() if round_p else p
    return (pv @ vf).to(q_sorted.dtype), mx, p.sum(dim=-1)


TENSOR_CORES = "tensor cores (wgmma, bf16)"
CUDA_CORES = "CUDA cores (float32)"


def expert_path(dtype: torch.dtype, d: int) -> str:
    """The kernel a CUDA call with this dtype and head dim runs."""
    return TENSOR_CORES if dtype == torch.bfloat16 and d in (64, 128) \
        else CUDA_CORES


def kv_lead_strides(lead: tuple, kv_lead: tuple):
    """The query lead as 4 dims and the KV lead row's stride over each:
    query lead row ``i`` (row-major over ``lead``) reads KV lead row
    ``sum_j idx_j(i) * strides[j]``, where ``idx_j`` are the digits of
    ``i`` over ``dims``.  A dim where the KV lead is 1 (broadcast) has
    stride 0.  Adjacent dims merge where they can; raises ValueError if
    more than 4 remain.  Returns (dims, strides), each a tuple of 4."""
    kv = (1,) * (len(lead) - len(kv_lead)) + tuple(kv_lead)
    strides, step = [], 1
    for n_q, n_kv in zip(reversed(lead), reversed(kv)):
        strides.append(step if n_kv == n_q else 0)
        step *= n_kv
    merged = []
    for n, st in zip(lead, reversed(strides)):
        if n == 1:
            continue
        if merged and merged[-1][1] == st * n:      # contiguous in kv
            merged[-1] = (merged[-1][0] * n, st)
        elif merged and merged[-1][1] == 0 and st == 0:
            merged[-1] = (merged[-1][0] * n, 0)
        else:
            merged.append((n, st))
    if len(merged) > 4:
        raise ValueError(f"query lead {lead} over KV lead {kv_lead}: "
                         f"{len(merged)} dims after merging (at most 4)")
    merged = [(1, 0)] * (4 - len(merged)) + merged
    return tuple(n for n, _ in merged), tuple(st for _, st in merged)


def _lib():
    lib = _build.load("mita_expert_attn")
    fn = lib.mita_expert_attention
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        ip = ctypes.POINTER(i)
        fn.argtypes = [i, p, p, i] + [p] * 3 + [ip, ip] + [p] * 3 \
            + [i] * 5 + [ctypes.c_float, p]
        fn.restype = ctypes.c_int
        sb = lib.mita_expert_attention_smem_bytes
        sb.argtypes = [i]
        sb.restype = ctypes.c_longlong
    return lib


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"mita_expert_attention: {msg}")


def mita_expert_attention(q_sorted, assign, k_e, v_e, valid,
                          block_q: int = 128):
    """Launch the CUDA kernel.  Shapes as `expert_attention_plain`; q,
    k_e and v_e float32 or bfloat16 (one dtype), head dim a multiple of 16
    up to 256 (recurrentgemma-9b's is 256); assign int32 or int64 and
    valid bool are read as they are.
    Returns (o, m, l) as the plain version does."""
    global LAUNCHES
    check_forward_only(q_sorted, k_e, v_e)
    dt = q_sorted.dtype
    dev = q_sorted.device
    _check(dev.type == "cuda", "needs CUDA tensors")
    _check(dt in (torch.float32, torch.bfloat16),
           f"dtype {dt} (float32 or bfloat16 only)")
    _check(k_e.dtype == dt and v_e.dtype == dt, "q, k_e, v_e dtypes differ")
    for x in (assign, k_e, v_e, valid):
        _check(x.device == dev, "all tensors must be on one device")
    lead, kv_lead, ns, d, m, kw = _shapes(q_sorted, assign, k_e, v_e, valid)
    _check(d % 16 == 0 and 16 <= d <= MAX_D,
           f"head dim {d} (a multiple of 16, at most {MAX_D})")
    n_lead = math.prod(lead)
    o = torch.empty(lead + (ns, d), dtype=dt, device=dev)
    m_out = torch.empty(lead + (ns,), dtype=torch.float32, device=dev)
    l_out = torch.empty(lead + (ns,), dtype=torch.float32, device=dev)
    if n_lead * ns == 0:
        return o, m_out, l_out
    lib = _lib()
    smem = lib.mita_expert_attention_smem_bytes(d)
    _check(smem <= SMEM_LIMIT, f"needs {smem} B of shared memory")
    dims, strides = kv_lead_strides(lead, kv_lead)
    # converted only where the kernel cannot read the operand as it is
    if assign.dtype not in (torch.int32, torch.int64):
        assign = assign.to(torch.int32)
    assign = assign.expand(lead + (ns,)).contiguous()
    ok = valid if valid.dtype == torch.bool else valid.to(torch.bool)
    # the tensor-core kernel reads 16-byte vectors (a copy realigns an odd
    # view)
    qkv = [a if a.data_ptr() % 16 == 0 else a.clone()
           for a in (q_sorted.contiguous(), k_e.contiguous(),
                     v_e.contiguous())]
    err = lib.mita_expert_attention(
        0 if dt == torch.float32 else 1, qkv[0].data_ptr(),
        assign.data_ptr(), int(assign.dtype == torch.int64),
        qkv[1].data_ptr(), qkv[2].data_ptr(),
        ok.contiguous().view(torch.uint8).data_ptr(),
        (ctypes.c_int * 4)(*dims), (ctypes.c_int * 4)(*strides),
        o.data_ptr(), m_out.data_ptr(), l_out.data_ptr(), n_lead, ns, d, m,
        kw, 1.0 / math.sqrt(d), torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "mita_expert_attention launch")
    LAUNCHES += 1
    return o, m_out, l_out
