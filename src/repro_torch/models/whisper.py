"""Whisper-style encoder-decoder, audio backbone only (port of
``repro.models.whisper``; the conv frontend is a stub).

The encoder takes precomputed frame embeddings [B, T_enc, D] (what the two
conv layers would produce).  MiTA runs bidirectionally in the encoder
(window ``attn.enc_window``; ``impl="pallas"``: the routed-expert kernel on
the card) and causally in the decoder; cross-attention stays full
(`core.baselines.full_attention`).

Decode: each decoder layer keeps its own self-attention cache (a MiTA
cache, or a full-attention cache for the other backends, as
`models.transformer.init_decode_states` builds them) and the cross K/V,
precomputed once from the encoder output.  Caches update in place.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch

from repro_torch.core.baselines import full_attention
from repro_torch.models import modules as nn
from repro_torch.models import transformer as tfm

Params = dict[str, Any]


def _xattn_init(gen, cfg: nn.ModelConfig, device) -> Params:
    d, h, dh, pd = cfg.d_model, cfg.n_heads, cfg.dh, cfg.param_dtype
    return {"wq": nn.dense_init(gen, d, h * dh, pd, device),
            "wk": nn.dense_init(gen, d, h * dh, pd, device),
            "wv": nn.dense_init(gen, d, h * dh, pd, device),
            "wo": nn.dense_init(gen, h * dh, d, pd, device)}


def _xattn_kv(p: Params, enc, cfg: nn.ModelConfig):
    """Cross K/V [B, H, T, dh] from the encoder output enc [B, T, D]."""
    b, t, _ = enc.shape
    h, dh, ct = cfg.n_heads, cfg.dh, cfg.compute_dtype
    k = (enc @ p["wk"].to(ct)).reshape(b, t, h, dh).transpose(1, 2)
    v = (enc @ p["wv"].to(ct)).reshape(b, t, h, dh).transpose(1, 2)
    return k, v


def _xattn_apply(p: Params, x, k, v, cfg: nn.ModelConfig):
    """x: [B, N, D] queries; k/v: [B, H, T, dh] from the encoder."""
    b, n, _ = x.shape
    h, dh, ct = cfg.n_heads, cfg.dh, cfg.compute_dtype
    q = (x @ p["wq"].to(ct)).reshape(b, n, h, dh).transpose(1, 2)
    o = full_attention(q, k, v, causal=False)
    return o.transpose(1, 2).reshape(b, n, h * dh) @ p["wo"].to(ct)


def _zeros(cfg: nn.ModelConfig, device):
    return torch.zeros((cfg.d_model,), dtype=cfg.param_dtype, device=device)


def enc_block_init(gen, cfg: nn.ModelConfig, device) -> Params:
    return {"ln1": _zeros(cfg, device), "ln2": _zeros(cfg, device),
            "attn": nn.attention_init(gen, cfg, device),
            "mlp": nn.gelu_mlp_init(gen, cfg, device)}


def dec_block_init(gen, cfg: nn.ModelConfig, device) -> Params:
    return {"ln1": _zeros(cfg, device), "ln2": _zeros(cfg, device),
            "ln3": _zeros(cfg, device),
            "attn": nn.attention_init(gen, cfg, device),
            "xattn": _xattn_init(gen, cfg, device),
            "mlp": nn.gelu_mlp_init(gen, cfg, device)}


def whisper_init(gen: torch.Generator, cfg: nn.ModelConfig,
                 t_enc: int = 1500, device="cuda") -> Params:
    """Random parameters with the reference's shapes, dtypes and init
    scales, drawn from ``gen``; encoder and decoder blocks stacked on
    axis 0."""
    enc = tfm.stack_layers([enc_block_init(gen, cfg, device)
                            for _ in range(cfg.n_layers)])
    dec = tfm.stack_layers([dec_block_init(gen, cfg, device)
                            for _ in range(cfg.n_layers)])
    return {"enc_pos": nn._normal(gen, (t_enc, cfg.d_model), 0.01,
                                  cfg.param_dtype, device),
            "enc": enc, "enc_ln": _zeros(cfg, device),
            "dec": dec, "dec_ln": _zeros(cfg, device),
            "emb": nn.embedding_init(gen, cfg, device)}


def encoder_cfg(cfg: nn.ModelConfig) -> nn.ModelConfig:
    """The config the encoder's attention runs with: window ``enc_window``
    where it is set."""
    if not cfg.attn.enc_window:
        return cfg
    return dataclasses.replace(cfg, attn=dataclasses.replace(
        cfg.attn, window=cfg.attn.enc_window))


def enc_embed(params: Params, audio_embeds, cfg: nn.ModelConfig):
    """The encoder's block input: the frame embeddings [B, T_enc, D] plus
    the learned position table, in the compute dtype."""
    ct = cfg.compute_dtype
    t = audio_embeds.shape[1]
    return audio_embeds.to(ct) + params["enc_pos"][:t].to(ct)


def enc_block_apply(bp: Params, x, cfg: nn.ModelConfig, positions):
    """One encoder block (the reference's scan body): bidirectional
    attention and the GELU MLP, each pre-normed and residual.  ``cfg`` is
    the encoder's (`encoder_cfg`)."""
    x = x + nn.attention_apply(bp["attn"], nn.rms_norm(x, bp["ln1"]), cfg,
                               positions, bidir=True)
    return x + nn.gelu_mlp_apply(bp["mlp"], nn.rms_norm(x, bp["ln2"]), cfg)


def whisper_encode(params: Params, audio_embeds, cfg: nn.ModelConfig):
    """audio_embeds: [B, T_enc, D] (the conv-frontend stub's output) ->
    encoder output [B, T_enc, D]."""
    cfg = encoder_cfg(cfg)
    x = enc_embed(params, audio_embeds, cfg)
    positions = torch.arange(x.shape[1], device=x.device)
    for i in range(cfg.n_layers):
        x = enc_block_apply(tfm.layer_params(params["enc"], i), x, cfg,
                            positions)
    return nn.rms_norm(x, params["enc_ln"])


def whisper_decode_train(params: Params, enc_out, tokens,
                         cfg: nn.ModelConfig):
    """Teacher-forced decoder: tokens [B, N] over the encoder output ->
    logits [B, N, V]."""
    x = nn.embed(params["emb"], tokens, cfg)
    positions = torch.arange(tokens.shape[1], device=x.device)
    for i in range(cfg.n_layers):
        bp = tfm.layer_params(params["dec"], i)
        x = x + nn.attention_apply(bp["attn"], nn.rms_norm(x, bp["ln1"]),
                                   cfg, positions)
        k, v = _xattn_kv(bp["xattn"], enc_out, cfg)
        x = x + _xattn_apply(bp["xattn"], nn.rms_norm(x, bp["ln2"]), k, v,
                             cfg)
        x = x + nn.gelu_mlp_apply(bp["mlp"], nn.rms_norm(x, bp["ln3"]), cfg)
    return nn.unembed(params["emb"], nn.rms_norm(x, params["dec_ln"]), cfg)


def whisper_loss(params: Params, batch: dict, cfg: nn.ModelConfig):
    """Cross-entropy of ``batch`` ("audio_embeds", "tokens", "labels",
    optional "loss_mask"; tensors or numpy arrays)."""
    dev = params["dec_ln"].device

    def up(x):
        return None if x is None else torch.as_tensor(x, device=dev)

    enc = whisper_encode(params, up(batch["audio_embeds"]), cfg)
    logits = whisper_decode_train(params, enc, up(batch["tokens"]), cfg)
    return nn.cross_entropy(logits, up(batch["labels"]),
                            up(batch.get("loss_mask")))


# ----------------------------------------------------------------- serving --

class WhisperDecState(NamedTuple):
    self_state: Any      # stacked per-layer self-attention caches
    xk: torch.Tensor     # [L, B, H, T_enc, dh] cross K (precomputed)
    xv: torch.Tensor


def whisper_init_serve(params: Params, audio_embeds, cfg: nn.ModelConfig,
                       capacity: int) -> WhisperDecState:
    """Encode the audio once; build the decoder's per-layer states.  Each
    layer gets its own self-attention cache (the decode step writes them
    in place, so they must not share storage)."""
    enc = whisper_encode(params, audio_embeds, cfg)
    kv = [_xattn_kv(tfm.layer_params(params["dec"], i)["xattn"], enc, cfg)
          for i in range(cfg.n_layers)]
    self_states = tfm.init_decode_states(cfg, enc.shape[0], capacity,
                                         device=enc.device)
    return WhisperDecState(self_state=self_states,
                           xk=torch.stack([k for k, _ in kv]),
                           xv=torch.stack([v for _, v in kv]))


def whisper_decode_step(params: Params, state: WhisperDecState, token, pos,
                        cfg: nn.ModelConfig):
    """token: [B]; pos: scalar position.  Returns (logits [B, V], state
    with every layer's t + 1); the caches are updated in place."""
    pos = torch.as_tensor(pos, device=token.device)
    x = nn.embed(params["emb"], token, cfg)
    for i in range(cfg.n_layers):
        bp = tfm.layer_params(params["dec"], i)
        a, _ = tfm.attention_decode(bp["attn"], nn.rms_norm(x, bp["ln1"]),
                                    tfm.layer_state(state.self_state, i),
                                    cfg, pos)
        x = x + a
        x = x + _xattn_apply(bp["xattn"], nn.rms_norm(x, bp["ln2"])[:, None],
                             state.xk[i], state.xv[i], cfg)[:, 0]
        x = x + nn.gelu_mlp_apply(bp["mlp"], nn.rms_norm(x, bp["ln3"]), cfg)
    logits = nn.unembed(params["emb"], nn.rms_norm(x, params["dec_ln"]), cfg)
    st = state.self_state
    return logits, state._replace(self_state=st._replace(t=st.t + 1))
