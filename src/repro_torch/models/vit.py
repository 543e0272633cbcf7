"""Vision transformer (encoder) of the paper's own experiments (port of
``repro.models.vit``): image classification over patches.

Patchification is a fixed linear projection of raw patches; the blocks are
`models.transformer`'s, run with bidirectional attention, so MiTA's routed
branch takes every sub-query (``impl="pallas"``: the routed-expert kernel
on the card).  Positions: a learned table of 1024 rows added to the patch
embeddings, and RoPE on the patch index inside attention, as in the
reference.  The landmark extractor is whatever ``cfg.attn.landmark`` names
(pool1d by default; ``vit_forward`` passes no patch grid, as the
reference's does not).
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.core.mita import argmax_first
from repro_torch.models import modules as nn
from repro_torch.models import transformer as tfm

Params = dict[str, Any]

POS_ROWS = 1024


def vit_init(gen: torch.Generator, cfg: nn.ModelConfig, patch_dim: int,
             n_classes: int, device="cuda") -> Params:
    """Random parameters with the reference's shapes, dtypes and init
    scales, drawn from ``gen``; blocks stacked on axis 0."""
    blocks = tfm.stack_layers([tfm.block_init(gen, cfg, device)
                               for _ in range(cfg.n_layers)])
    pd = cfg.param_dtype
    return {"patch": nn.dense_init(gen, patch_dim, cfg.d_model, pd, device),
            "pos": nn._normal(gen, (POS_ROWS, cfg.d_model), 0.02, pd, device),
            "blocks": blocks,
            "ln_f": torch.zeros((cfg.d_model,), dtype=pd, device=device),
            "head": nn.dense_init(gen, cfg.d_model, n_classes, pd, device)}


def vit_embed(params: Params, patches, cfg: nn.ModelConfig):
    """The blocks' input: the patch projection plus the position table,
    in the compute dtype."""
    ct = cfg.compute_dtype
    x = patches.to(ct) @ params["patch"].to(ct)
    return x + params["pos"][:patches.shape[1]].to(ct)


def vit_forward(params: Params, patches, cfg: nn.ModelConfig):
    """patches: [B, N, patch_dim] (N <= 1024) -> logits [B, n_classes]."""
    x = vit_embed(params, patches, cfg)
    positions = torch.arange(x.shape[1], device=x.device)
    for i in range(cfg.n_layers):
        x, _ = tfm.block_apply(tfm.layer_params(params["blocks"], i), x, cfg,
                               positions, bidir=True)
    x = nn.rms_norm(x.mean(dim=1), params["ln_f"])
    return x @ params["head"].to(cfg.compute_dtype)


def _batch(params: Params, batch: dict):
    dev = params["head"].device
    return (torch.as_tensor(batch["patches"], device=dev),
            torch.as_tensor(batch["label"], device=dev))


def vit_loss(params: Params, batch: dict, cfg: nn.ModelConfig):
    """Mean cross-entropy of ``batch`` ("patches", "label"; tensors or
    numpy arrays)."""
    patches, label = _batch(params, batch)
    return nn.cross_entropy(vit_forward(params, patches, cfg), label)


def vit_accuracy(params: Params, batch: dict, cfg: nn.ModelConfig):
    """Share of ``batch`` whose first-index argmax is its label."""
    patches, label = _batch(params, batch)
    pred = argmax_first(vit_forward(params, patches, cfg))
    return (pred == label.long()).float().mean()
