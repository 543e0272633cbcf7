"""Decoder-only MiTA transformer LM, dense or MoE FFN (port of
``repro.models.transformer``; the MoE layers are `models.moe`).

Parameters are the reference's pytree as a nested dict of tensors, with
per-layer parameters stacked on axis 0; the reference's ``lax.scan`` over
layers is a Python loop over that axis.  Decode states are stacked the same
way, and each layer works on views of its slice (updates are in place).

Entry points: ``lm_forward``, ``lm_loss`` and ``lm_prefill`` (full
sequence; ``AttnConfig.impl`` picks the routed branch: "sorted",
"capacity", or "pallas" for the expert kernel),
``lm_decode_step`` + ``lm_finalize_states`` (the static path's monolithic
caches: MiTA caches for ``mita`` / ``mita_ref``, full-attention caches for
the other backends), ``lm_paged_decode_step``, ``lm_prefill_chunks`` (batched),
``lm_prefill_chunk`` (per-job) and ``lm_landmark_draft`` (the serving
engine's paged pools; `sample_tokens` samples on the device), and
``init_slot_attn_state`` / ``block_decode_slots`` (the hybrid model's
per-slot attention caches).  ``lm_forward``, ``lm_loss`` (batch
``"image_embeds"``) and ``lm_prefill`` take the VLM's multimodal
embeddings, which overwrite the first P positions.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from repro_torch import prng
from repro_torch.core import mita_decode as mdec
from repro_torch.models import modules as nn
from repro_torch.models.moe import moe_apply, moe_init

Params = dict[str, Any]


def layer_params(tree, i: int):
    """Layer ``i`` of a tree of stacked per-layer tensors (views)."""
    if isinstance(tree, dict):
        return {k: layer_params(v, i) for k, v in tree.items()}
    return tree[i]


def layer_state(states, i: int):
    """Layer ``i`` of stacked decode states: a state of views."""
    return type(states)(*(x[i] for x in states))


def stack_layers(trees: list) -> Params:
    """Per-layer parameter trees -> one tree of leaves stacked on axis 0.
    Each leaf leaves its per-layer tree as it is stacked, so at most one
    leaf's layers exist twice at a time (not the whole model)."""
    if isinstance(trees[0], dict):
        return {k: stack_layers([t.pop(k) for t in trees])
                for k in list(trees[0])}
    return torch.stack(trees)


def _stack_states(per_layer: list):
    return type(per_layer[0])(*(torch.stack(xs) for xs in zip(*per_layer)))


# ------------------------------------------------------------------ block ---

def block_init(gen, cfg: nn.ModelConfig, device, ffn: bool = True) -> Params:
    """One block's parameters; ``ffn`` False leaves out the FFN (`lm_init`
    draws the MoE layers' leaves stacked, `moe.moe_init`)."""
    pd = cfg.param_dtype
    p = {"ln1": torch.zeros((cfg.d_model,), dtype=pd, device=device),
         "ln2": torch.zeros((cfg.d_model,), dtype=pd, device=device),
         "attn": nn.attention_init(gen, cfg, device)}
    if ffn and cfg.n_experts:
        p["moe"] = moe_init(gen, cfg, device)
    elif ffn:
        p["ffn"] = nn.swiglu_init(gen, cfg, device)
    return p


def _ffn(params: Params, xn, cfg: nn.ModelConfig, tp=None):
    """The block's FFN on normed activations xn [B, N, D]: (out, aux)."""
    if cfg.n_experts:
        return moe_apply(params["moe"], xn, cfg, tp)
    return nn.swiglu_apply(params["ffn"], xn, cfg, tp), 0.0


def block_apply(params: Params, x, cfg: nn.ModelConfig, positions,
                bidir: bool = False, tp=None):
    """x: [B, N, D] -> (x, aux), aux the MoE load-balance loss (0 for a
    dense FFN).  ``bidir``: bidirectional attention (the ViT).  ``tp``: a
    `distributed.tensor_parallel.ModelSplit` (``params`` this rank's
    shards, ``cfg`` its local config): one all-reduce over "model" after
    the attention and one after the FFN (dense, or the MoE layer's
    experts and shared expert together)."""
    h = nn.attention_apply(params["attn"], nn.rms_norm(x, params["ln1"]),
                           cfg, positions, bidir=bidir, tp=tp)
    x = x + h
    f, aux = _ffn(params, nn.rms_norm(x, params["ln2"]), cfg, tp)
    return x + f, aux


def lm_init(gen: torch.Generator, cfg: nn.ModelConfig,
            device="cuda") -> Params:
    """Random parameters with the reference's shapes, dtypes and init
    scales (``transformer.lm_init``), drawn from ``gen``.  MoE layers'
    leaves are allocated stacked and drawn layer by layer into their
    slices, after the other blocks' parameters."""
    emb = nn.embedding_init(gen, cfg, device)
    blocks = [block_init(gen, cfg, device, ffn=not cfg.n_experts)
              for _ in range(cfg.n_layers)]
    blocks = stack_layers(blocks)
    if cfg.n_experts:
        blocks["moe"] = moe_init(gen, cfg, device, n_layers=cfg.n_layers)
    return {"emb": emb, "blocks": blocks,
            "ln_f": torch.zeros((cfg.d_model,), dtype=cfg.param_dtype,
                                device=device)}


def lm_backbone(params: Params, x, cfg: nn.ModelConfig, positions=None,
                tp=None):
    """Run the layer stack on embeddings x: [B, N, D] -> (x, aux), aux the
    per-layer MoE losses summed (a float32 scalar; 0.0 for a dense FFN).
    Each layer is rematerialised under ``cfg.remat`` (`nn.layer_call`),
    its collectives under ``tp`` too."""
    if positions is None:
        positions = torch.arange(x.shape[1], device=x.device)
    aux = 0.0
    for i in range(cfg.n_layers):
        x, a = nn.layer_call(cfg, block_apply,
                             layer_params(params["blocks"], i), x, cfg,
                             positions, False, tp)
        aux = aux + a
    return nn.rms_norm(x, params["ln_f"]), aux


def _embed(params: Params, tokens, cfg: nn.ModelConfig, extra_embeds=None,
           tp=None):
    """Token embeddings [B, N, D]; ``extra_embeds`` [B, P, D] (VLM)
    overwrite the first P positions.  Under a model split (``tp``) the
    lookup is summed over "model" first, and ``extra_embeds`` are the
    rank's data rows, the same on every "model" rank."""
    x = nn.embed(params["emb"], tokens, cfg, tp)
    if extra_embeds is not None:
        p = extra_embeds.shape[1]
        x = torch.cat([extra_embeds.to(x.dtype), x[:, p:]], dim=1)
    return x


def lm_forward_aux(params: Params, tokens, cfg: nn.ModelConfig,
                   extra_embeds=None, tp=None):
    """tokens: [B, N] -> (logits [B, N, V], aux): the reference's
    ``lm_forward``.  Under a model split (``tp``) whose vocabulary is
    split, the logits are this rank's classes."""
    x, aux = lm_backbone(params, _embed(params, tokens, cfg, extra_embeds,
                                        tp), cfg, tp=tp)
    return nn.unembed(params["emb"], x, cfg, tp), aux


def lm_forward(params: Params, tokens, cfg: nn.ModelConfig,
               extra_embeds=None):
    """tokens: [B, N] -> logits [B, N, V] (`lm_forward_aux` also returns
    the MoE aux loss)."""
    return lm_forward_aux(params, tokens, cfg, extra_embeds)[0]


def lm_loss(params: Params, batch: dict, cfg: nn.ModelConfig,
            aux_weight: float = 0.01, tp=None) -> torch.Tensor:
    """Next-token cross-entropy of ``batch`` ("tokens", "labels", optional
    "loss_mask" and "image_embeds"; tensors or numpy arrays) plus
    ``aux_weight`` times the MoE aux loss per layer.  With
    ``impl="pallas"`` it is forward only (scoring).  ``tp``: the model
    (dense, MoE or the VLM's LM) on this rank's shards of a model split,
    the same loss on every rank of it (`distributed.tensor_parallel`)."""
    dev = params["ln_f"].device

    def up(x):
        return None if x is None else torch.as_tensor(x, device=dev)

    logits, aux = lm_forward_aux(params, up(batch["tokens"]), cfg,
                                 up(batch.get("image_embeds")), tp)
    loss = nn.cross_entropy(logits, up(batch["labels"]),
                            up(batch.get("loss_mask")), tp)
    return loss + aux_weight * aux / cfg.n_layers


def uses_mita_state(cfg: nn.ModelConfig) -> bool:
    """Whether the attention decodes on a MiTA cache (``mita`` /
    ``mita_ref``); every other backend keeps the full-attention cache
    (`core.mita_decode.FullDecodeState`), as the reference does."""
    return cfg.attn.backend in ("mita", "mita_ref")


def _decode_cfg(cfg: nn.ModelConfig) -> mdec.DecodeConfig:
    return mdec.DecodeConfig(window=cfg.attn.window, k=cfg.attn.k,
                             s=cfg.attn.s,
                             external_finalize=cfg.attn.external_finalize)


def lm_prefill(params: Params, tokens, cfg: nn.ModelConfig, capacity: int,
               extra_embeds=None, tp=None):
    """Forward over the prompt, building per-layer decode states
    (``extra_embeds`` as in `lm_forward`).  Returns (last_logits [B, V],
    stacked states).  Under a model split (``tp``: dense, MoE or the
    VLM's LM on this rank's shards) the states hold this rank's KV heads
    (its group's, shared by the ranks of the group, when the group spans
    several) and the logits its classes where the vocabulary is split."""
    n = tokens.shape[1]
    positions = torch.arange(n, device=tokens.device)
    x = _embed(params, tokens, cfg, extra_embeds, tp)
    dcfg = _decode_cfg(cfg)
    states = []
    for i in range(cfg.n_layers):
        lp = layer_params(params["blocks"], i)
        q, k, v = nn._qkv(nn.attention_weights(lp["attn"], tp),
                          nn.rms_norm(x, lp["ln1"]), cfg, positions)
        if uses_mita_state(cfg):
            states.append(mdec.mita_prefill_state(q, k, v, dcfg, capacity))
        else:
            states.append(mdec.full_prefill_state(k, v, capacity))
        x, _ = block_apply(lp, x, cfg, positions, tp=tp)
    x = nn.rms_norm(x, params["ln_f"])
    return nn.unembed(params["emb"], x[:, -1], cfg, tp), _stack_states(states)


# ----------------------------------------------------------------- decode ---

def init_decode_states(cfg: nn.ModelConfig, batch: int, capacity: int,
                       device="cuda"):
    """Stacked per-layer empty decode states, MiTA caches or, for the
    other backends, full-attention caches; each layer its own storage (the
    steps write in place)."""
    dt = cfg.compute_dtype
    if uses_mita_state(cfg):
        one = [mdec.init_decode_state(batch, cfg.n_kv, cfg.dh, capacity,
                                      _decode_cfg(cfg), dtype=dt,
                                      device=device)
               for _ in range(cfg.n_layers)]
    else:
        one = [mdec.init_full_state(batch, cfg.n_kv, cfg.dh, capacity,
                                    dtype=dt, device=device)
               for _ in range(cfg.n_layers)]
    return _stack_states(one)


def lm_finalize_states(states, cfg: nn.ModelConfig):
    """External-mode landmark finalize for every layer (in place)."""
    dcfg = _decode_cfg(cfg)
    for i in range(cfg.n_layers):
        mdec.mita_finalize_if_due(layer_state(states, i), dcfg)
    return states


def _project(params: Params, x, cfg: nn.ModelConfig, pos):
    """One-token q [S, Hkv, G, dh], k/v [S, Hkv, dh] at positions ``pos``
    (a scalar or [S])."""
    b = x.shape[0]
    kv, g, dh = cfg.n_kv, cfg.group, cfg.dh
    ct = cfg.compute_dtype
    q = (x @ params["wq"].to(ct)).reshape(b, kv, g, dh)
    k = (x @ params["wk"].to(ct)).reshape(b, kv, dh)
    v = (x @ params["wv"].to(ct)).reshape(b, kv, dh)
    if cfg.qk_norm:
        q = nn.rms_norm(q, params["q_norm"], cfg.norm_eps)
        k = nn.rms_norm(k, params["k_norm"], cfg.norm_eps)
    if pos.ndim == 0:
        q = nn.rope(q[..., None, :], pos[None], cfg.rope_theta)[..., 0, :]
        k = nn.rope(k[..., None, :], pos[None], cfg.rope_theta)[..., 0, :]
    else:
        q = nn.rope(q[..., None, :], pos[:, None, None, None],
                    cfg.rope_theta)[..., 0, :]
        k = nn.rope(k[..., None, :], pos[:, None, None],
                    cfg.rope_theta)[..., 0, :]
    return q, k, v


def attention_decode(params: Params, x, state, cfg: nn.ModelConfig, pos):
    """One-token attention on a monolithic cache (MiTA, or full attention
    for the other backends). x: [B, D]; pos scalar."""
    q, k, v = _project(params, x, cfg, pos)
    if uses_mita_state(cfg):
        o, state = mdec.mita_decode_step(state, q, k, v, _decode_cfg(cfg))
    else:
        o, state = mdec.full_decode_step(state, q, k, v)
    o = o.reshape(x.shape[0], cfg.n_heads * cfg.dh)
    return o @ params["wo"].to(cfg.compute_dtype), state


def _ffn_residual(params: Params, x, cfg: nn.ModelConfig):
    """x + FFN(norm(x)) for x [B, N, D], or one token a row, x [S, D]: an
    MoE FFN then sees [S, 1, D], the reference's shape at that call (its
    capacity groups are cut from the flattened tokens)."""
    xn = nn.rms_norm(x, params["ln2"])
    if x.ndim == 2:
        return x + _ffn(params, xn[:, None, :], cfg)[0][:, 0]
    return x + _ffn(params, xn, cfg)[0]


def block_decode(params: Params, x, state, cfg: nn.ModelConfig, pos):
    h, state = attention_decode(params["attn"],
                                nn.rms_norm(x, params["ln1"]), state, cfg,
                                pos)
    return _ffn_residual(params, x + h, cfg), state


def init_slot_attn_state(cfg: nn.ModelConfig, n_slots: int, capacity: int,
                         device="cuda"):
    """ONE layer's per-slot monolithic attention decode state: leaves
    [S, 1, ...] and a per-slot ``t`` [S], each slot a B == 1 cache, so
    slots advance at independent positions (`attention_decode_slots`).
    The non-MiTA backends keep the full-attention cache, at most
    ``attn.local_window`` rows."""
    dt = cfg.compute_dtype
    if uses_mita_state(cfg):
        one = mdec.init_decode_state(n_slots, cfg.n_kv, cfg.dh, capacity,
                                     _decode_cfg(cfg), dtype=dt,
                                     device=device)
    else:
        one = mdec.init_full_state(n_slots, cfg.n_kv, cfg.dh,
                                   min(capacity, cfg.attn.local_window),
                                   dtype=dt, device=device)
    return type(one)(*(x[:, None] for x in one[:-1]),
                     torch.zeros(n_slots, dtype=torch.int32, device=device))


def attention_decode_slots(params: Params, x, state, cfg: nn.ModelConfig,
                           pos, commit=None, due_hint: Optional[bool] = None):
    """One-token attention at PER-SLOT positions over per-slot monolithic
    caches.  x: [S, D]; pos: [S]; state: a slot-form layer state (leaves
    [S, 1, ...], per-slot ``t``); commit: [S] bool, the slots whose state
    may change (None: all).  The reference vmaps the B == 1
    `mita_decode_step` / `full_decode_step` over slots; here one batched
    step does it in place (`core.mita_decode.mita_decode_step_slots`).
    ``due_hint`` False skips the inline finalize when the caller knows
    that no slot closes a window."""
    s = x.shape[0]
    q, k, v = _project(params, x, cfg, pos)
    if uses_mita_state(cfg):
        o, state = mdec.mita_decode_step_slots(state, q, k, v,
                                               _decode_cfg(cfg), commit,
                                               due_hint)
    else:
        o, state = mdec.full_decode_step_slots(state, q, k, v, commit)
    o = o.reshape(s, cfg.n_heads * cfg.dh)
    return o @ params["wo"].to(cfg.compute_dtype), state


def block_decode_slots(params: Params, x, state, cfg: nn.ModelConfig, pos,
                       commit=None, due_hint: Optional[bool] = None):
    """`block_decode` at per-slot positions (`attention_decode_slots`)."""
    h, state = attention_decode_slots(
        params["attn"], nn.rms_norm(x, params["ln1"]), state, cfg, pos,
        commit, due_hint)
    return _ffn_residual(params, x + h, cfg), state


def lm_decode_step(params: Params, states, token, pos, cfg: nn.ModelConfig):
    """token: [B]; pos: scalar position.  Returns (logits [B, V], states
    with t + 1); the caches are updated in place."""
    pos = torch.as_tensor(pos, device=token.device)
    x = nn.embed(params["emb"], token, cfg)
    for i in range(cfg.n_layers):
        x, _ = block_decode(layer_params(params["blocks"], i), x,
                            layer_state(states, i), cfg, pos)
    logits = nn.unembed(params["emb"], nn.rms_norm(x, params["ln_f"]), cfg)
    return logits, states._replace(t=states.t + 1)


# ---------------------------------------------------------- paged decode ---

def init_paged_states(cfg: nn.ModelConfig, n_slots: int, n_pages: int,
                      pages_per_slot: int, device="cuda"):
    """Stacked per-layer paged pools (layer axis 0)."""
    if not uses_mita_state(cfg):
        raise ValueError("paged decode states require a MiTA attention "
                         "backend (the pool layout is landmark/expert aware)")
    one = [mdec.init_paged_state(cfg.n_kv, cfg.dh, n_pages, n_slots,
                                 pages_per_slot, _decode_cfg(cfg),
                                 dtype=cfg.compute_dtype, device=device)
           for _ in range(cfg.n_layers)]
    return _stack_states(one)


def attention_decode_paged(params: Params, x, state, cfg: nn.ModelConfig,
                           pos, page_table, active):
    """One-token attention over the paged pool. x: [S, D]; pos: [S]."""
    q, k, v = _project(params, x, cfg, pos)
    o, state = mdec.mita_paged_decode_step(state, q, k, v, page_table, pos,
                                           active, _decode_cfg(cfg))
    o = o.reshape(x.shape[0], cfg.n_heads * cfg.dh)
    return o @ params["wo"].to(cfg.compute_dtype), state


def block_decode_paged(params: Params, x, state, cfg: nn.ModelConfig, pos,
                       page_table, active):
    h, state = attention_decode_paged(
        params["attn"], nn.rms_norm(x, params["ln1"]), state, cfg, pos,
        page_table, active)
    return _ffn_residual(params, x + h, cfg), state


def sample_tokens(logits, rid, index, temperature, key) -> torch.Tensor:
    """Per-slot sampling on the logits' device: greedy first-index argmax,
    or a categorical keyed by ``fold_in(fold_in(key, rid), index)`` — the
    derivation the host sampler uses, so tokens do not depend on batching,
    slot placement or preemption.

    logits: [S, V]; rid / index: [S] int32 and temperature: [S] float32,
    HOST arrays (<= 0 means greedy); key: a threefry key [2] (`prng`) on
    the host.  Returns [S] int32.  A batch with no tempered slot does no
    threefry work, decided on the host as the reference's ``lax.cond``
    decides it.  The per-slot keys are derived on the host (a few [S]
    words) and uploaded once; the gumbel draw over [S, V] runs on the
    logits' device.  The tempered sum is float32 (``temperature`` is a
    float32 array, so bfloat16 logits are promoted by the division); the
    gumbel draw itself is made in the logits' dtype."""
    greedy = prng.argmax_first(logits)
    temp = np.asarray(temperature, np.float32)
    if not (temp > 0.0).any():
        return greedy
    dev = logits.device

    def host(x):
        return torch.as_tensor(np.asarray(x))

    keys = prng.fold_in(prng.fold_in(host(key), host(rid)), host(index))
    noise = prng.gumbel(keys.to(dev), (logits.shape[-1],), logits.dtype)
    z = noise + logits / torch.clamp_min(host(temp).to(dev), 1e-6)[:, None]
    return torch.where(host(temp > 0.0).to(dev), prng.argmax_first(z),
                       greedy)


def lm_paged_decode_step(params: Params, states, token, pos, page_table,
                         active, cfg: nn.ModelConfig,
                         due: Optional[np.ndarray] = None,
                         sample: Optional[tuple] = None):
    """token, pos: [S]; page_table: [S, M]; active: [S] bool.  Returns
    (logits [S, V], states), or, with ``sample`` = (rid, index,
    temperature, key) set (host arrays and a key, see `sample_tokens`),
    (tokens [S] int32, states) sampled on the device.  Pools update in
    place.

    ``due`` (external finalize): HOST [S] bool — slots whose last completed
    window still needs its landmark.  The branch is taken once per step in
    Python on this host value, never by reading a device flag per layer."""
    dcfg = _decode_cfg(cfg)
    due_dev = None
    if due is not None and np.asarray(due).any():
        due_dev = torch.as_tensor(np.asarray(due, bool), device=token.device)
    x = nn.embed(params["emb"], token, cfg)
    for i in range(cfg.n_layers):
        st = layer_state(states, i)
        if due_dev is not None:
            mdec.mita_paged_finalize(st, page_table, pos, due_dev, dcfg)
        x, _ = block_decode_paged(layer_params(params["blocks"], i), x, st,
                                  cfg, pos, page_table, active)
    logits = nn.unembed(params["emb"], nn.rms_norm(x, params["ln_f"]), cfg)
    if sample is None:
        return logits, states
    return sample_tokens(logits, *sample), states


# ------------------------------------------------------ landmark drafter ---

def attention_decode_landmark(params: Params, x, state, cfg: nn.ModelConfig,
                              pos, m_cnt):
    """Landmark-branch-only attention for the speculative drafter: the q
    projection alone (nothing is appended), qk-normed and RoPE'd at the
    per-slot draft position ``pos`` [S], attending the slot's first
    ``m_cnt`` [S] landmarks (`core.mita_decode.mita_paged_landmark_attend`).
    Reads ``state`` only."""
    b = x.shape[0]
    kv, g, dh = cfg.n_kv, cfg.group, cfg.dh
    ct = cfg.compute_dtype
    q = (x @ params["wq"].to(ct)).reshape(b, kv, g, dh)
    if cfg.qk_norm:
        q = nn.rms_norm(q, params["q_norm"], cfg.norm_eps)
    q = nn.rope(q[..., None, :], pos[:, None, None, None],
                cfg.rope_theta)[..., 0, :]
    o = mdec.mita_paged_landmark_attend(state, q, m_cnt, _decode_cfg(cfg))
    return o.reshape(b, cfg.n_heads * dh) @ params["wo"].to(ct)


def block_decode_landmark(params: Params, x, state, cfg: nn.ModelConfig,
                          pos, m_cnt):
    h = attention_decode_landmark(params["attn"],
                                  nn.rms_norm(x, params["ln1"]), state, cfg,
                                  pos, m_cnt)
    return _ffn_residual(params, x + h, cfg)


def lm_landmark_draft(params: Params, states, tokens, t, active, m_cnt,
                      cfg: nn.ModelConfig, n_pos: int, rid, sample_idx,
                      temperature, key) -> torch.Tensor:
    """Self-drafting forward: propose ``n_pos`` tokens per slot against the
    landmark branch only, feeding each draft to the next position.

    tokens: [S] last committed token per slot (device); t: [S] position of
    the first draft (device); active: [S] bool, HOST — an inactive slot's
    token passes through unchanged; m_cnt: [S] finalised landmark count
    (device), frozen across the draft.  rid / sample_idx / temperature are
    host arrays: position ``i`` samples with ``(rid, sample_idx + i)``, the
    key the verify step uses at the same output index, so a tempered draft
    can match its verification.  Returns drafts [n_pos, S] int32.  Reads
    the states only: no append, no ``q_sum`` change, nothing to undo."""
    active = np.asarray(active, bool)
    ac_dev = torch.as_tensor(active, device=tokens.device)
    si = np.asarray(sample_idx, np.int32).copy()
    tok = tokens
    drafts = []
    for i in range(n_pos):
        x = nn.embed(params["emb"], tok, cfg)
        for j in range(cfg.n_layers):
            x = block_decode_landmark(layer_params(params["blocks"], j), x,
                                      layer_state(states, j), cfg, t + i,
                                      m_cnt)
        logits = nn.unembed(params["emb"], nn.rms_norm(x, params["ln_f"]),
                            cfg)
        tok = torch.where(ac_dev, sample_tokens(logits, rid, si, temperature,
                                                key), tok)
        si = si + active
        drafts.append(tok)
    return torch.stack(drafts)


def _chunk_block_body(lp: Params, h, st, cfg: nn.ModelConfig, positions,
                      attn):
    """Per-layer body of the chunk-prefill forwards: norm -> qkv -> paged
    chunk attention (``attn(st, q, k, v)`` returns o [B, Hkv, G, nc, d])
    -> output projection -> FFN residual.  The layer's state ``st`` is
    updated in place."""
    b, nc, _ = h.shape
    q, k, v = nn._qkv(lp["attn"], nn.rms_norm(h, lp["ln1"]), cfg, positions)
    o = attn(st, q, k[:, :, 0], v[:, :, 0])
    o = torch.movedim(o, 3, 1).reshape(b, nc, cfg.n_heads * cfg.dh)
    h = h + o @ lp["attn"]["wo"].to(cfg.compute_dtype)
    return _ffn_residual(lp, h, cfg)


def lm_prefill_chunk(params: Params, states, tokens, slot: int,
                     page_table_row, t0: int, n_valid: int, n_train: int,
                     cfg: nn.ModelConfig):
    """Prefill one chunk of ONE slot's prompt into the paged pools (the
    per-job mode; `core.mita_decode.mita_chunk_prefill` per layer).

    tokens: [nc] int32, zero-padded past ``n_valid``; page_table_row: [M]
    int32 (pages covering positions < t0 + n_valid allocated); slot, t0,
    n_valid and n_train (the original prompt length: recomputed generated
    positions replicate decode-time landmark availability) are host
    integers.  Returns (logits [V] at position ``t0 + n_valid - 1``,
    states); the pools and the slot's rows update in place."""
    nc = tokens.shape[0]
    pos = t0 + torch.arange(nc, device=tokens.device)
    x = nn.embed(params["emb"], tokens[None], cfg)
    dcfg = _decode_cfg(cfg)

    def attn(st, q, k, v):
        o, _ = mdec.mita_chunk_prefill(st, q[0], k[0], v[0], page_table_row,
                                       slot, t0, n_valid, n_train, dcfg)
        return o[None]

    for i in range(cfg.n_layers):
        x = _chunk_block_body(layer_params(params["blocks"], i), x,
                              layer_state(states, i), cfg, pos, attn)
    x = nn.rms_norm(x, params["ln_f"])
    return nn.unembed(params["emb"], x[0, n_valid - 1], cfg), states


def lm_prefill_chunks(params: Params, states, tokens, job_active,
                      page_table, slots, t0, n_valid, n_train,
                      cfg: nn.ModelConfig):
    """Prefill one chunk for EVERY active prefilling row in one call.

    tokens: [P, nc] int32 (zero-padded past each row's ``n_valid``);
    job_active: [P] bool; page_table: [P, M] int32; slots: [P] UNIQUE slot
    ids; t0 / n_valid / n_train: [P] int32 (see
    `core.mita_decode.mita_batched_chunk_prefill`).  Returns (logits
    [P, V] at each row's position ``t0 + n_valid - 1``, states); the
    stacked pools and the rows' slot state are updated in place, one
    chunk-prefill call per layer."""
    nc = tokens.shape[1]
    pos = t0.long()[:, None] + torch.arange(nc, device=tokens.device)
    x = nn.embed(params["emb"], tokens, cfg)
    dcfg = _decode_cfg(cfg)

    def attn(st, q, k, v):
        return mdec.mita_batched_chunk_prefill(
            st, q, k, v, page_table, slots, t0, n_valid, n_train,
            job_active, dcfg)[0]

    for i in range(cfg.n_layers):
        x = _chunk_block_body(layer_params(params["blocks"], i), x,
                              layer_state(states, i), cfg,
                              pos[:, None, None, :], attn)
    return nn.last_logits(params, x, n_valid, cfg), states


def pack_prefill_into_states(states, prefill_states, slot: int, pages,
                             cfg: nn.ModelConfig):
    """Copy per-layer single-request prefill states into a slot's pages."""
    dcfg = _decode_cfg(cfg)
    for i in range(cfg.n_layers):
        mdec.pack_prefill_into_pages(layer_state(states, i),
                                     layer_state(prefill_states, i), slot,
                                     pages, dcfg)
    return states
