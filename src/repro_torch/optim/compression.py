"""Compressed data-parallel gradient reduction (port of
``repro.optim.compression``).

A mean all-reduce of a gradient tree over a process group that moves
**int8** on the wire:

  1. per-tensor absmax-quantize the local gradient to int8 (+ a float32
     scale);
  2. reduce-scatter: ``all_to_all_single`` of the n int8 chunks (each rank
     receives every peer's chunk of its own segment) and an
     ``all_gather_into_tensor`` of the n scales;
  3. dequantize and sum the segment in float32, in peer order, divide by
     n, and re-quantize it;
  4. ``all_gather_into_tensor`` of the int8 segments and their scales.

Only int8 payloads and one float32 scale per rank and step go on the
wire: 2 (n - 1) / n bytes an element against 8 (n - 1) / n for a float32
ring all-reduce.  Quantization error is carried by error feedback (Seide
et al., 1-bit SGD): the residual ``g - Q(g)`` of the local quantization is
added to the next step's gradient.  The arithmetic is the reference's, in
its order (``round`` half to even, ``g / scale`` as a division), so
payloads, results and residuals are equal to its values bit for bit.
"""

from __future__ import annotations

from typing import Any, Callable

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.device import fma32
from repro_torch.optim.adamw import tree_map
from repro_torch.optim.grads import batch_share, value_and_grads


def _f32(v: float, like: torch.Tensor) -> torch.Tensor:
    """A float32 divisor on ``like``'s device: the card multiplies by the
    reciprocal of a Python float divisor, which rounds differently."""
    return torch.tensor(v, dtype=torch.float32, device=like.device)


def quantize_int8(g: torch.Tensor):
    """Per-tensor symmetric absmax quantization: (q int8, scale float32
    scalar)."""
    g32 = g.float()
    scale = torch.clamp(g32.abs().max(), min=1e-12) / _f32(127.0, g32)
    q = torch.clamp(torch.round(g32 / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def _all_gather(x: torch.Tensor, group) -> torch.Tensor:
    """[n, *x.shape]: every rank's ``x`` in rank order."""
    n = dist.get_world_size(group)
    out = torch.empty(n * x.numel(), dtype=x.dtype, device=x.device)
    dist.all_gather_into_tensor(out, x.reshape(-1).contiguous(), group=group)
    return out.reshape((n,) + tuple(x.shape))


def _compressed_allreduce_leaf(q: torch.Tensor, scale: torch.Tensor,
                               group) -> torch.Tensor:
    """Mean-all-reduce one tensor, given as its int8 quantization (q,
    scale), with int8 wire traffic.  Zero padding to a multiple of the
    group's size leaves the quantization as it is (the absmax is the
    same), so ``q`` is padded, not re-quantized."""
    n = dist.get_world_size(group)
    size = q.numel()
    padded = F.pad(q.reshape(-1), (0, (-size) % n))

    # reduce-scatter: every peer's int8 copy of our segment
    recv = torch.empty_like(padded)
    dist.all_to_all_single(recv, padded, group=group)
    recv = recv.reshape(n, -1)
    scales = _all_gather(scale.reshape(1), group)[:, 0]
    seg = recv[0].float() * scales[0]
    for i in range(1, n):
        seg = seg + recv[i].float() * scales[i]
    seg = seg / _f32(n, seg)

    q2, s2 = quantize_int8(seg)
    segs = _all_gather(q2, group)                  # [n, seg] int8
    s2s = _all_gather(s2.reshape(1), group)        # [n, 1]
    full = (segs.float() * s2s).reshape(-1)
    return full[:size].reshape(q.shape)


def compressed_grad_mean(grads: Any, group=None, err: Any = None):
    """Mean-reduce a gradient tree across ``group`` (default: the default
    process group) with int8 wire traffic and error feedback.  Returns
    (reduced grads, new error feedback), both float32 trees."""
    if err is None:
        err = init_error_feedback(grads)

    def leaf(g, e):
        g_fb = g.float() + e
        # the residual of the local quantization (what was not sent), one
        # rounding: the reference's compiled code fuses it into an FMA
        q, s = quantize_int8(g_fb)
        return (_compressed_allreduce_leaf(q, s, group),
                fma32(q.float(), -s, g_fb))

    out = tree_map(leaf, grads, err)
    return tree_map(lambda t: t[0], out), tree_map(lambda t: t[1], out)


def dp_compressed_train_step(loss_fn: Callable, opt_update: Callable, mesh,
                             axis: str = "data"):
    """A pure-DP train step with compressed gradient reduction over the
    mesh axis ``axis``.

    ``loss_fn(params, batch) -> loss``; ``opt_update(grads, opt_state,
    params) -> (params, opt_state, metrics)``.  Every rank holds the whole
    parameters; ``batch`` is the global batch (the same on every rank),
    of which each rank takes its consecutive share of the rows.  The
    returned step has signature (params, opt_state, err, batch) ->
    (params, opt_state, err, metrics); ``metrics["loss"]`` is the mean of
    the ranks' losses."""
    group = mesh.get_group(axis)
    n = dist.get_world_size(group)

    def step(params, opt_state, err, batch):
        loss, grads = value_and_grads(loss_fn, params, batch_share(
            batch, n, dist.get_rank(group)))
        grads, err = compressed_grad_mean(grads, group, err)
        params, opt_state, metrics = opt_update(grads, opt_state, params)
        total = loss.float().clone()
        dist.all_reduce(total, group=group)
        metrics["loss"] = total / _f32(n, total)
        return params, opt_state, err, metrics

    return step


def init_error_feedback(params: Any) -> Any:
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


__all__ = ["quantize_int8", "dequantize_int8", "compressed_grad_mean",
           "dp_compressed_train_step", "init_error_feedback"]
