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

`synthetic_vision_batch` is the reference's training data, bit for bit:
the same threefry draws (`prng.normal`, `randint`, `uniform`) on the
key's device.
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch import prng
from repro_torch.core.mita import argmax_first, topk_first
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


def synthetic_vision_batch(key: torch.Tensor, b: int, n_patches: int,
                           patch_dim: int, n_classes: int,
                           n_signal: int = 6, noise: float = 1.0) -> dict:
    """Sparse-signal synthetic images from the threefry ``key`` [2] (on
    the device the batch is made on): ``n_signal`` patches at random
    positions of each sample carry its class prototype (drawn from
    ``PRNGKey(17)``) plus noise, the rest is noise.  Returns {"patches":
    float32 [b, n_patches, patch_dim], "label": int32 [b]}, equal bit for
    bit to the reference's.  The positions are the ``n_signal`` largest
    uniform scores of each row, ties to the lower index, as ``lax.top_k``
    picks them."""
    dev = key.device
    kp, kn, kl = prng.split(key, 3)
    f32 = lambda v: torch.tensor(v, dtype=torch.float32,  # noqa: E731
                                 device=dev)
    protos = prng.normal(prng.PRNGKey(17, dev),
                         (n_classes, patch_dim)) * f32(1.2)
    labels = prng.randint(kl, (b,), 0, n_classes)
    x = prng.normal(kn, (b, n_patches, patch_dim)) * f32(noise)
    scores = prng.uniform(kp, (b, n_patches))
    _, pos = topk_first(scores, n_signal)                 # [b, n_signal]
    sig = protos[labels.long()][:, None, :] + f32(0.3) * prng.normal(
        prng.fold_in(kn, 1), (b, n_signal, patch_dim))
    x.scatter_(1, pos[..., None].expand(-1, -1, patch_dim), sig)
    return {"patches": x, "label": labels}
