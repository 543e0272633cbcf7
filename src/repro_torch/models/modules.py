"""Neural-net primitives of the LM (port of ``repro.models.modules``).

Conventions kept from the reference:
  * parameters are nested dicts of tensors (``<name>_init`` builds them,
    ``<name>_apply`` uses them), in ``cfg.param_dtype``; activations run in
    ``cfg.compute_dtype``; norms and softmax accumulate in float32;
  * attention tensors are [B, Hkv, G, N, dh] (G query heads per KV group).

Initialisers take an explicit ``torch.Generator`` and ``device``.  They use
the reference's shapes, dtypes and scales; the random draws differ from
``jax.random`` (tests share weights through `repro_torch.convert`).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import torch
import torch.utils.checkpoint

from repro_torch.core.baselines import (full_attention, linear_attention,
                                        local_attention, moba_attention)
from repro_torch.core.mita import MiTAConfig, mita_attention
from repro_torch.core.mita_sparse import mita_attention_sparse
from repro_torch.kernels.ops import default_block_q

Params = dict[str, Any]


@dataclasses.dataclass(frozen=True)
class AttnConfig:
    """Attention backend selection + MiTA hyper-parameters (the TPU dispatch
    switches have no counterpart here: the tensors' device decides)."""
    backend: str = "mita"     # mita | mita_ref | agent | mita_route |
    #                           full | local | moba | linear (baselines)
    window: int = 128         # landmark window w  (m = N // w)
    k: int = 128              # expert width
    s: int = 1                # routed experts per query
    causal: bool = True
    impl: str = "sorted"      # sorted | capacity | pallas (mita_sparse)
    block_q: int = 128        # 0 = ops.default_block_q (REPRO_BLOCK_Q)
    expert_span: int = 4
    capacity_factor: float = 1.25
    landmark: str = "pool1d"
    landmark_per_group: bool = True
    route_per_group: bool = False
    # "grouped": [B, Hkv, G, N, dh] (KV broadcast, group landmarks);
    # "repeat":  [B, H, N, dh] with K/V repeated per query head.
    gqa_layout: str = "grouped"
    local_window: int = 2048  # for backend == "local" (recurrentgemma)
    enc_window: int = 0       # enc-dec: encoder-side window (0 = same)
    external_finalize: bool = False

    def mita_cfg(self, n: int, bidir: bool = False) -> MiTAConfig:
        m = max(1, n // self.window)
        return MiTAConfig(
            m=m, k=min(self.k, n), s=min(self.s, m),
            causal=self.causal and not bidir, landmark=self.landmark,
            compress_only=self.backend == "agent",
            route_only=self.backend == "mita_route",
            route_per_group=self.route_per_group)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    n_layers: int = 4
    d_model: int = 256
    n_heads: int = 4
    n_kv: int = 4
    d_ff: int = 1024
    vocab: int = 1024
    head_dim: int = 0          # 0 -> d_model // n_heads
    rope_theta: float = 1e6
    qk_norm: bool = False
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    attn: AttnConfig = dataclasses.field(default_factory=AttnConfig)
    # MoE (n_experts == 0 -> dense FFN; `models.moe`)
    n_experts: int = 0
    moe_top_k: int = 2
    n_shared_experts: int = 0
    moe_capacity_factor: float = 1.25
    param_dtype: Any = torch.float32
    compute_dtype: Any = torch.float32
    remat: bool = False        # recompute each layer in the backward

    @property
    def dh(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def group(self) -> int:
        return self.n_heads // self.n_kv


# ------------------------------------------------------------ primitives ---

def _records(tree) -> bool:
    if isinstance(tree, dict):
        return any(_records(v) for v in tree.values())
    return isinstance(tree, torch.Tensor) and tree.requires_grad


def layer_call(cfg: ModelConfig, fn, *args):
    """``fn(*args)`` for one layer.  With ``cfg.remat``, and only while
    autograd records (an argument requires grad), the layer keeps no
    activations and is recomputed in the backward: the reference's
    ``jax.checkpoint(body, policy=nothing_saveable)``.  The recomputed
    forward runs the same ops on the same inputs, so it takes the same
    top-k and routing decisions and the gradients keep their bits."""
    if cfg.remat and torch.is_grad_enabled() and any(map(_records, args)):
        return torch.utils.checkpoint.checkpoint(fn, *args,
                                                 use_reentrant=False)
    return fn(*args)


def _normal(gen: torch.Generator, shape, scale, dtype, device):
    """``scale`` x standard normal draws from ``gen`` on its own device,
    moved to ``device``; on the meta device only the shape and dtype (the
    abstract parameters of `launch.steps.abstract_params`)."""
    if torch.device(device).type == "meta":
        return torch.empty(shape, dtype=dtype, device="meta")
    x = torch.randn(shape, generator=gen, dtype=torch.float32,
                    device=gen.device)
    return (x * scale).to(device=device, dtype=dtype)


def dense_init(gen, d_in: int, d_out: int, dtype, device) -> torch.Tensor:
    return _normal(gen, (d_in, d_out), 1.0 / math.sqrt(d_in), dtype, device)


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    dtype = x.dtype
    x = x.float()
    var = (x * x).mean(dim=-1, keepdim=True)
    return ((x * torch.rsqrt(var + eps)) * (1.0 + scale.float())).to(dtype)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis, float32 statistics (population
    variance), the result in x's dtype."""
    dtype = x.dtype
    x = x.float()
    mu = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, keepdim=True, unbiased=False)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * scale + bias).to(dtype)


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """Rotary embedding. x: [..., N, dh]; positions: [N] or broadcastable
    to x's leading dims + [N]."""
    dh = x.shape[-1]
    half = dh // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    angles = positions[..., :, None].float() * freqs
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# -------------------------------------------------------------- attention ---

def attention_init(gen, cfg: ModelConfig, device) -> Params:
    d, h, kv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.dh
    pd = cfg.param_dtype
    p = {"wq": dense_init(gen, d, h * dh, pd, device),
         "wk": dense_init(gen, d, kv * dh, pd, device),
         "wv": dense_init(gen, d, kv * dh, pd, device),
         "wo": dense_init(gen, h * dh, d, pd, device)}
    if cfg.qk_norm:
        p["q_norm"] = torch.zeros((dh,), dtype=pd, device=device)
        p["k_norm"] = torch.zeros((dh,), dtype=pd, device=device)
    return p


def _qkv(params: Params, x: torch.Tensor, cfg: ModelConfig,
         positions: torch.Tensor):
    """Project to [B,Hkv,G,N,dh] query and [B,Hkv,1,N,dh] key/value."""
    b, n, _ = x.shape
    kv, g, dh = cfg.n_kv, cfg.group, cfg.dh
    ct = cfg.compute_dtype
    q = (x @ params["wq"].to(ct)).reshape(b, n, kv, g, dh)
    k = (x @ params["wk"].to(ct)).reshape(b, n, kv, 1, dh)
    v = (x @ params["wv"].to(ct)).reshape(b, n, kv, 1, dh)
    q = torch.movedim(q, 1, 3)
    k = torch.movedim(k, 1, 3)
    v = torch.movedim(v, 1, 3)
    if cfg.qk_norm:
        q = rms_norm(q, params["q_norm"], cfg.norm_eps)
        k = rms_norm(k, params["k_norm"], cfg.norm_eps)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    return q, k, v


def attention_apply(params: Params, x: torch.Tensor, cfg: ModelConfig,
                    positions: Optional[torch.Tensor] = None,
                    bidir: bool = False, tp=None) -> torch.Tensor:
    """Full-sequence attention (training forward / prefill).  x:
    [B, N, D].  MiTA backends, or one of the paper's baselines (full,
    local, moba, linear: `core.baselines`).  ``impl="pallas"`` runs MiTA's
    routed branch on the expert kernel (forward only).  ``bidir`` drops
    causality for every backend (the ViT, whisper's encoder).  ``tp``: a
    `distributed.tensor_parallel.ModelSplit`; ``params`` and ``cfg`` are
    then this rank's shards and local config, and the output is summed
    over the "model" ranks."""
    b, n, _ = x.shape
    if positions is None:
        positions = torch.arange(n, device=x.device)
    if tp is not None:
        x = tp.enter(x)
    q, k, v = _qkv(attention_weights(params, tp), x, cfg, positions)
    o = attention_core(q, k, v, cfg, bidir=bidir,
                       own=None if tp is None else tp.own)
    o = o @ params["wo"].to(cfg.compute_dtype)
    return o if tp is None else tp.leave(o)


def attention_weights(params: Params, tp=None) -> Params:
    """The projections that `_qkv` takes: ``params``, or under a model
    split whose KV groups span several ranks, this rank's group's columns
    of wq, wk and wv (`ModelSplit.group_weights`)."""
    return params if tp is None else tp.group_weights(params)


def attention_core(q, k, v, cfg: ModelConfig, bidir: bool = False,
                   own: Optional[slice] = None) -> torch.Tensor:
    """The attention of `attention_apply` on projected q [B, Hkv, G, N,
    dh] and k / v [B, Hkv, 1, N, dh]: o [B, N, heads x dh].  ``own``
    keeps only those of each group's G query heads (a model split's
    rank); the group landmark query still pools all G."""
    b, _, _, n, dh = q.shape
    a = cfg.attn
    causal = a.causal and not bidir
    repeat = a.gqa_layout == "repeat"
    mita = a.backend in ("mita", "mita_ref", "agent", "mita_route")
    q_lm = q.mean(dim=2, keepdim=True) if (
        mita and a.landmark_per_group and q.shape[2] > 1 and not repeat) \
        else None
    if own is not None:
        q = q[:, :, own]
    if repeat:
        full = q.shape
        h = full[1] * full[2]
        q = q.reshape(b, h, n, dh)
        k = k.expand(full).reshape(b, h, n, dh)
        v = v.expand(full).reshape(b, h, n, dh)
    if mita:
        mcfg = a.mita_cfg(n, bidir=bidir)
        if a.backend == "mita_ref" or mcfg.compress_only:
            o = mita_attention(q, k, v, mcfg, q_landmarks=q_lm)
        else:
            bq = min(a.block_q or default_block_q(), a.window * mcfg.s,
                     n * mcfg.s)
            o = mita_attention_sparse(
                q, k, v, mcfg, impl=a.impl, block_q=bq,
                expert_span=min(a.expert_span, mcfg.m),
                capacity_factor=a.capacity_factor, q_landmarks=q_lm)
    elif a.backend == "full":
        o = full_attention(q, k, v, causal=causal)
    elif a.backend == "local":
        o = local_attention(q, k, v, window=min(a.local_window, n),
                            causal=causal)
    elif a.backend == "moba":
        o = moba_attention(q, k, v, block_size=a.window,
                           top_blocks=max(1, a.k // a.window), causal=causal)
    elif a.backend == "linear":
        o = linear_attention(q, k, v, causal=causal)
    else:
        raise ValueError(f"unknown attention backend {a.backend!r}")
    o = torch.movedim(o, 2 if repeat else 3, 1)
    return o.reshape(b, n, -1)


# -------------------------------------------------------------------- ffn ---

def swiglu_init(gen, cfg: ModelConfig, device) -> Params:
    pd = cfg.param_dtype
    return {"wi": dense_init(gen, cfg.d_model, cfg.d_ff, pd, device),
            "wg": dense_init(gen, cfg.d_model, cfg.d_ff, pd, device),
            "wo": dense_init(gen, cfg.d_ff, cfg.d_model, pd, device)}


def swiglu_apply(params: Params, x: torch.Tensor,
                 cfg: ModelConfig, tp=None) -> torch.Tensor:
    """SwiGLU FFN; under a model split (``tp``) on this rank's columns of
    wi / wg and rows of wo, the output summed over the "model" ranks."""
    ct = cfg.compute_dtype
    if tp is not None:
        x = tp.enter(x)
    h = torch.nn.functional.silu(x @ params["wg"].to(ct)) \
        * (x @ params["wi"].to(ct))
    out = h @ params["wo"].to(ct)
    return out if tp is None else tp.leave(out)


def gelu_mlp_init(gen, cfg: ModelConfig, device,
                  d_ff: Optional[int] = None) -> Params:
    pd = cfg.param_dtype
    d_ff = d_ff or cfg.d_ff
    return {"wi": dense_init(gen, cfg.d_model, d_ff, pd, device),
            "bi": torch.zeros((d_ff,), dtype=pd, device=device),
            "wo": dense_init(gen, d_ff, cfg.d_model, pd, device),
            "bo": torch.zeros((cfg.d_model,), dtype=pd, device=device)}


def gelu_mlp_apply(params: Params, x: torch.Tensor,
                   cfg: ModelConfig) -> torch.Tensor:
    """GELU MLP with biases; the GELU is the tanh approximation, which is
    ``jax.nn.gelu``'s default."""
    ct = cfg.compute_dtype
    h = torch.nn.functional.gelu(
        x @ params["wi"].to(ct) + params["bi"].to(ct), approximate="tanh")
    return h @ params["wo"].to(ct) + params["bo"].to(ct)


# ------------------------------------------------------------- embeddings ---

def embedding_init(gen, cfg: ModelConfig, device) -> Params:
    p = {"tok": _normal(gen, (cfg.vocab, cfg.d_model), 0.02,
                        cfg.param_dtype, device)}
    if not cfg.tie_embeddings:
        p["head"] = dense_init(gen, cfg.d_model, cfg.vocab, cfg.param_dtype,
                               device)
    return p


def embed(params: Params, tokens: torch.Tensor,
          cfg: ModelConfig, tp=None) -> torch.Tensor:
    """Token embeddings; under a model split (``tp``) vocabulary-parallel
    where the table is split (`ModelSplit.embed`)."""
    if tp is not None:
        return tp.embed(params["tok"], tokens, cfg.compute_dtype)
    return params["tok"][tokens.long()].to(cfg.compute_dtype)


def unembed(params: Params, x: torch.Tensor, cfg: ModelConfig,
            tp=None) -> torch.Tensor:
    """Logits; under a model split whose vocabulary is split, this rank's
    classes only (``cfg.vocab`` of them)."""
    ct = cfg.compute_dtype
    if tp is not None and tp.vocab is not None:
        x = tp.enter(x)
    if cfg.tie_embeddings:
        return x @ params["tok"].to(ct).T
    return x @ params["head"].to(ct)


def last_logits(params: Params, x: torch.Tensor, n_valid: torch.Tensor,
                cfg: ModelConfig) -> torch.Tensor:
    """Logits [P, V] at each row's last valid position of a chunk's hidden
    states x [P, nc, D] (``n_valid`` [P]; a row with none reads position
    0), after the final norm."""
    x = rms_norm(x, params["ln_f"])
    last = torch.clamp(n_valid.long() - 1, min=0)
    return unembed(params["emb"], x[torch.arange(x.shape[0], device=x.device),
                                    last], cfg)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: Optional[torch.Tensor] = None,
                  tp=None) -> torch.Tensor:
    """Mean token cross-entropy, float32 accumulation.  logits: [..., V],
    or under a model split whose vocabulary is split this rank's classes
    (``tp``, vocabulary-parallel: `ModelSplit.nll`)."""
    logits = logits.float()
    if tp is not None and tp.vocab is not None:
        nll = tp.nll(logits, labels)
    else:
        nll = torch.logsumexp(logits, dim=-1) \
            - torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    if mask is not None:
        mask = mask.float()
        return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return nll.mean()
