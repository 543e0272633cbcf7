"""Per-family model functions and the train step (port of the training
half of ``repro.launch.steps``).

`family_fns(arch)` gives each family's ``init`` (from a
``torch.Generator``), ``loss`` and, where the port has them in the
reference's batch form, ``prefill`` / ``decode`` / ``init_states``.
`train_step` is the reference's ``build_cell(..., kind="train").fn``: the
loss's gradients (accumulated over microbatches in float32), then one
AdamW update.  ``build_cell``'s abstract shapes and shardings, and its
prefill and decode cells, belong to the port's distribution (ROADMAP
A.14).
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.device import cpu_log_ready
from repro_torch.models import mamba2 as mb
from repro_torch.models import rglru as rg
from repro_torch.models import transformer as tfm
from repro_torch.models import whisper as wh
from repro_torch.optim.adamw import (AdamWState, OptConfig, adamw_update,
                                     tree_leaves, tree_map)


def family_fns(arch) -> dict:
    """(init, loss, prefill, decode, init_states) of ``arch``'s family;
    ``init(gen, device="cuda")``, ``init_states(batch, capacity,
    device="cuda")``, the rest as in the reference."""
    cfg = arch.model
    fam = arch.family
    if fam in ("dense", "moe", "vlm"):
        return dict(
            init=lambda gen, device="cuda": tfm.lm_init(gen, cfg, device),
            loss=lambda p, b: tfm.lm_loss(p, b, cfg),
            prefill=lambda p, b, cap: tfm.lm_prefill(
                p, b["tokens"], cfg, cap,
                extra_embeds=b.get("image_embeds")),
            decode=lambda p, st, tok, pos: tfm.lm_decode_step(p, st, tok,
                                                              pos, cfg),
            init_states=lambda b, cap, device="cuda": tfm.init_decode_states(
                cfg, b, cap, device),
        )
    if fam == "hybrid":
        # the reference's batch-form decode (its only caller is
        # ``build_cell``) waits for A.14; the port serves the hybrid in
        # slot form (`rglru.rg_slot_decode_step`)
        return dict(
            init=lambda gen, device="cuda": rg.rg_init(gen, cfg, device),
            loss=lambda p, b: rg.rg_loss(p, b, cfg),
            prefill=None, decode=None, init_states=None,
        )
    if fam == "ssm":
        return dict(
            init=lambda gen, device="cuda": mb.mamba_init(gen, cfg, device),
            loss=lambda p, b: mb.mamba_loss(p, b, cfg),
            prefill=None,
            decode=lambda p, st, tok, pos: mb.mamba_decode_step(p, st, tok,
                                                                pos, cfg),
            init_states=lambda b, cap, device="cuda":
                mb.mamba_init_decode_states(cfg, b, cap, device),
        )
    if fam == "encdec":
        return dict(
            init=lambda gen, device="cuda": wh.whisper_init(
                gen, cfg, t_enc=arch.t_enc, device=device),
            loss=lambda p, b: wh.whisper_loss(p, b, cfg),
            prefill=None,
            decode=lambda p, st, tok, pos: wh.whisper_decode_step(p, st, tok,
                                                                  pos, cfg),
            init_states=None,   # whisper serve states need params (xattn KV)
        )
    raise ValueError(fam)


def _grads(loss_fn: Callable, params, batch):
    """(loss, grads) of ``loss_fn(params, batch)``: grads a tree like
    ``params`` in the parameters' dtype (zeros for a leaf the loss does
    not reach)."""
    p = tree_map(lambda t: t.detach().requires_grad_(), params)
    leaves = tree_leaves(p)
    loss = loss_fn(p, batch)
    got = torch.autograd.grad(loss, leaves, allow_unused=True)
    by_id = {id(x): torch.zeros_like(x) if g is None else g
             for x, g in zip(leaves, got)}
    return loss.detach(), tree_map(lambda t: by_id[id(t)], p)


def train_step(params, opt_state: AdamWState, batch: dict,
               loss_fn: Callable, opt_cfg: OptConfig, microbatch: int = 1):
    """One training step: (new params, new opt state, metrics {"loss",
    "lr", "grad_norm"}), each metric a float32 scalar on the device.

    With ``microbatch`` A > 1 the batch (numpy arrays or tensors, leading
    axis the batch) is split into A consecutive slices, as the reference's
    reshape to [A, B / A, ...] does; each slice's backward runs before the
    next forward (its activations are freed), the float32 gradients are
    summed in slice order and divided by A, and the loss is the mean of
    the slices' losses.  A loss that needs a backward the port lacks (the
    expert kernel, ``impl="pallas"``) raises."""
    if tree_leaves(params)[0].device.type == "cpu":
        cpu_log_ready()
    if microbatch == 1:
        loss, grads = _grads(loss_fn, params, batch)
    else:
        n = len(next(iter(batch.values())))
        if n % microbatch:
            raise ValueError("microbatch must divide global batch")
        size = n // microbatch
        grads = tree_map(lambda t: torch.zeros(t.shape, dtype=torch.float32,
                                               device=t.device), params)
        loss = 0.0
        for i in range(microbatch):
            part = {k: v[i * size:(i + 1) * size] for k, v in batch.items()}
            li, gi = _grads(loss_fn, params, part)
            grads = tree_map(torch.add, grads, gi)
            loss = loss + li
        div = torch.tensor(float(microbatch), dtype=torch.float32,
                           device=loss.device)
        grads = tree_map(lambda g: g / div, grads)
        loss = loss / div
    new_p, new_opt, metrics = adamw_update(grads, opt_state, params, opt_cfg)
    metrics["loss"] = loss
    return new_p, new_opt, metrics
