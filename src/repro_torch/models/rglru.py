"""RecurrentGemma-style hybrid (Griffin): RG-LRU recurrent blocks
interleaved 2:1 with MiTA attention blocks (port of
``repro.models.rglru``).

The RG-LRU recurrence h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)
runs over the whole sequence in the forward as a log-depth doubling scan
(`_doubling_scan`, ~12 steps of elementwise ops at N = 4096, where the
reference runs ``lax.associative_scan``: the two combine in another
order, within float32 rounding), and as one step per token at decode.

Dtype rules of the reference, kept as they are, asymmetry included: the
forward convolves in the compute dtype; decode and chunk prefill convolve
the float32 history in float32, then cast to the compute dtype.  The gates
and the recurrence are float32.

The reference's batch form (`rg_init_decode_states`, `rg_decode_step`:
one position for the whole batch, the attention layer's monolithic cache,
or for the non-MiTA backends a full cache of at most ``local_window``
rows) is the decode cell of `launch.steps.build_cell`.

Serving entry points (`serve.backends.recurrent`): per-super-block slot
states (`rg_slot_states`: RG-LRU leaves [NS, S, ...], attention caches in
slot form [NS, S, 1, ...] with a ``t`` per slot); `rg_slot_decode_step`
steps the slot batch at per-slot positions; `rg_prefill_chunk` runs the
RG-LRU layers and FFNs of a chunk in bulk, their recurrences and the
attention layer's cache-appending step per token, each token's arithmetic
the decode step's.  Both write the states they are given in place, only
for the slots (tokens) that are committed (valid).
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import mita_decode as mdec
from repro_torch.core import slotted
from repro_torch.models import modules as nn
from repro_torch.models import transformer as tfm
from repro_torch.models.mamba2 import conv_tail
from repro_torch.models.transformer import layer_params

Params = dict[str, Any]

_C = 8.0            # RG-LRU decay sharpness
_CONV_K = 4         # temporal conv width


def _gelu(x):
    """``jax.nn.gelu``'s default: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def rglru_block_init(gen, cfg: nn.ModelConfig, device) -> Params:
    d = dr = cfg.d_model            # recurrent width == d_model
    pd = cfg.param_dtype
    return {
        "ln": torch.zeros((d,), dtype=pd, device=device),
        "w_in": nn.dense_init(gen, d, dr, pd, device),
        "w_gate": nn.dense_init(gen, d, dr, pd, device),
        "conv": nn._normal(gen, (_CONV_K, dr), 0.1, pd, device),
        "w_a": nn.dense_init(gen, dr, dr, pd, device),
        "b_a": torch.zeros((dr,), dtype=pd, device=device),
        "w_x": nn.dense_init(gen, dr, dr, pd, device),
        "b_x": torch.zeros((dr,), dtype=pd, device=device),
        "lam": torch.full((dr,), 0.5, dtype=pd, device=device),
        "w_out": nn.dense_init(gen, dr, d, pd, device),
    }


def _rglru_gates(p: Params, xc, ct, whole=None):
    """The decay a_t and the gated input, float32.  Under a model split
    ``xc`` is the rank's channels and ``whole`` all of them (gathered
    over "model"), which the products with the rank's columns of ``w_a``
    and ``w_x`` take."""
    xw = xc if whole is None else whole
    r = torch.sigmoid(xw @ p["w_a"].to(ct) + p["b_a"].to(ct))
    i = torch.sigmoid(xw @ p["w_x"].to(ct) + p["b_x"].to(ct))
    log_a = (-_C * F.softplus(p["lam"].float())) * r.float()
    a = torch.exp(log_a)
    gated = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a),
                                   min=1e-12)) * (i.float() * xc.float())
    return a, gated


def _doubling_scan(a, b):
    """h_t = a_t * h_{t-1} + b_t over axis 1 (h_{-1} = 0), in
    ceil(log2 N) steps: step k combines each position with the one 2^k
    earlier, (a_l, b_l) . (a_r, b_r) = (a_l a_r, a_r b_l + b_r)."""
    n = a.shape[1]
    shift = 1
    while shift < n:
        a_r, b_r = a[:, shift:], b[:, shift:]
        b = torch.cat([b[:, :shift], a_r * b[:, :-shift] + b_r], dim=1)
        a = torch.cat([a[:, :shift], a_r * a[:, :-shift]], dim=1)
        shift *= 2
    return b


def rglru_block_apply(p: Params, x, cfg: nn.ModelConfig, tp=None):
    """x: [B, N, D] -> [B, N, D].  ``tp``: a `distributed.tensor_parallel.
    ModelSplit`, ``p`` this rank's shards (its channels of the recurrent
    width: columns of ``w_in``, ``w_gate``, ``w_a`` and ``w_x``, of
    ``conv``, ``b_a``, ``b_x`` and ``lam``, rows of ``w_out``).  The conv,
    the gates' biases and the scan are per channel; the gate products
    take every channel of the conv output, so each pass moves one
    all-gather of ``xc`` over "model" (a reduce-scatter of its gradient
    backward) and one all-reduce after ``w_out``."""
    ct = cfg.compute_dtype
    n = x.shape[1]
    xn = nn.rms_norm(x, p["ln"], cfg.norm_eps)
    if tp is not None:
        xn = tp.enter(xn)
    gate = _gelu(xn @ p["w_gate"].to(ct))
    xi = xn @ p["w_in"].to(ct)
    xpad = F.pad(xi, (0, 0, _CONV_K - 1, 0))
    conv = p["conv"].to(ct)
    xc = xpad[:, 0:n] * conv[0]
    for j in range(1, _CONV_K):
        xc = xc + xpad[:, j:j + n] * conv[j]
    a, gated = _rglru_gates(p, xc, ct,
                            None if tp is None else tp.gather(xc))
    h = _doubling_scan(a, gated)
    y = (h.to(ct) * gate) @ p["w_out"].to(ct)
    return x + (y if tp is None else tp.leave(y))


class RGLRUState(NamedTuple):
    h: torch.Tensor      # [B, Dr] recurrent state, float32
    conv: torch.Tensor   # [B, _CONV_K - 1, Dr] trailing conv inputs


def rglru_init_state(batch: int, dr: int, device="cuda") -> RGLRUState:
    return RGLRUState(
        h=torch.zeros((batch, dr), dtype=torch.float32, device=device),
        conv=torch.zeros((batch, _CONV_K - 1, dr), dtype=torch.float32,
                         device=device))


def _conv_f32(hist, conv, n: int, ct):
    """The width-4 causal conv over float32 history rows [B, n + 3, Dr],
    in float32, cast to the compute dtype."""
    cw = conv.float()
    acc = hist[:, 0:n] * cw[0]
    for j in range(1, _CONV_K):
        acc = acc + hist[:, j:j + n] * cw[j]
    return acc.to(ct)


def rglru_block_decode(p: Params, x, st: RGLRUState, cfg: nn.ModelConfig):
    """x: [B, D], one step.  Returns (x', new RGLRUState)."""
    ct = cfg.compute_dtype
    xn = nn.rms_norm(x, p["ln"], cfg.norm_eps)
    gate = _gelu(xn @ p["w_gate"].to(ct))
    xi = xn @ p["w_in"].to(ct)
    hist = torch.cat([st.conv, xi[:, None, :].float()], dim=1)
    xc = _conv_f32(hist, p["conv"], 1, ct)[:, 0]
    a, gated = _rglru_gates(p, xc, ct)
    h = a * st.h + gated
    y = (h.to(ct) * gate) @ p["w_out"].to(ct)
    return x + y, RGLRUState(h=h, conv=hist[:, 1:])


# ------------------------------------------------------------- super-block --

def super_block_init(gen, cfg: nn.ModelConfig, device) -> Params:
    """(RG-LRU, RG-LRU, attention + FFN): the Griffin 2:1 pattern."""
    return {"rec1": rglru_block_init(gen, cfg, device),
            "rec2": rglru_block_init(gen, cfg, device),
            "attn_blk": tfm.block_init(gen, cfg, device),
            "ffn1": nn.swiglu_init(gen, cfg, device),
            "ln_f1": torch.zeros((cfg.d_model,), dtype=cfg.param_dtype,
                                 device=device)}


def _ffn1(sp: Params, x, cfg: nn.ModelConfig, tp=None):
    return x + nn.swiglu_apply(sp["ffn1"], nn.rms_norm(x, sp["ln_f1"]), cfg,
                               tp)


def super_block_apply(p: Params, x, cfg: nn.ModelConfig, positions,
                      tp=None):
    """One super-block; under a model split (``tp``) each of its four
    parts ends in one all-reduce over "model" each pass."""
    x = rglru_block_apply(p["rec1"], x, cfg, tp)
    x = _ffn1(p, x, cfg, tp)
    x = rglru_block_apply(p["rec2"], x, cfg, tp)
    return tfm.block_apply(p["attn_blk"], x, cfg, positions, tp=tp)[0]


def n_super(cfg: nn.ModelConfig) -> int:
    return max(1, cfg.n_layers // 3)


def rg_init(gen: torch.Generator, cfg: nn.ModelConfig,
            device="cuda") -> Params:
    """Random parameters with the reference's shapes, dtypes and scales;
    super-block leaves stacked on axis 0."""
    emb = nn.embedding_init(gen, cfg, device)
    supers = [super_block_init(gen, cfg, device) for _ in range(n_super(cfg))]
    return {"emb": emb, "supers": tfm.stack_layers(supers),
            "ln_f": torch.zeros((cfg.d_model,), dtype=cfg.param_dtype,
                                device=device)}


def rg_forward(params: Params, tokens, cfg: nn.ModelConfig, tp=None):
    """tokens [B, N] -> (logits [B, N, V], aux 0).  The attention layers
    take ``cfg.attn`` as it is: ``impl="pallas"`` runs MiTA's routed
    branch on the expert kernel (head dim 256 at recurrentgemma-9b).
    Under a model split (``tp``: ``params`` this rank's shards, ``cfg``
    its local config) the embedding, head and super-blocks are split
    over "model", each layer rematerialised with its collectives under
    ``cfg.remat``; the logits are the rank's classes where the
    vocabulary is split."""
    x = nn.embed(params["emb"], tokens, cfg, tp)
    positions = torch.arange(tokens.shape[1], device=x.device)
    for i in range(n_super(cfg)):
        x = nn.layer_call(cfg, super_block_apply,
                          layer_params(params["supers"], i), x, cfg,
                          positions, tp)
    x = nn.rms_norm(x, params["ln_f"])
    return nn.unembed(params["emb"], x, cfg, tp), \
        torch.zeros((), device=x.device)


def rg_loss(params: Params, batch: dict, cfg: nn.ModelConfig, tp=None):
    """Next-token cross-entropy of ``batch``; ``tp``: on this rank's
    shards of a model split, the same loss on every rank of it."""
    dev = params["ln_f"].device

    def up(x):
        return None if x is None else torch.as_tensor(x, device=dev)

    logits, _ = rg_forward(params, up(batch["tokens"]), cfg, tp)
    return nn.cross_entropy(logits, up(batch["labels"]),
                            up(batch.get("loss_mask")), tp)


class RGSuperState(NamedTuple):
    rec1: RGLRUState
    rec2: RGLRUState
    attn: Any


def rg_slot_states(cfg: nn.ModelConfig, n_slots: int, capacity: int,
                   device="cuda") -> RGSuperState:
    """Stacked per-super-block slot states: RG-LRU leaves [NS, S, ...],
    attention leaves [NS, S, 1, ...] with a per-slot ``t`` [NS, S] (each
    slot a B == 1 monolithic cache of ``capacity`` tokens)."""
    ns = n_super(cfg)
    one = RGSuperState(
        rec1=rglru_init_state(n_slots, cfg.d_model, device),
        rec2=rglru_init_state(n_slots, cfg.d_model, device),
        attn=tfm.init_slot_attn_state(cfg, n_slots, capacity, device))
    return slotted.tree_map(
        lambda a: a[None].expand((ns,) + a.shape).contiguous(), one)


def rg_init_decode_states(cfg: nn.ModelConfig, batch: int, capacity: int,
                          device="cuda") -> RGSuperState:
    """Stacked per-super-block batch-form decode states: RG-LRU leaves
    [NS, B, ...]; the attention layer's monolithic cache (MiTA for
    ``mita`` / ``mita_ref``, else a full cache of ``min(capacity,
    local_window)`` rows) with leaves [NS, B, ...] and ``t`` [NS]."""
    def attn():
        if tfm.uses_mita_state(cfg):
            return mdec.init_decode_state(
                batch, cfg.n_kv, cfg.dh, capacity, tfm._decode_cfg(cfg),
                dtype=cfg.compute_dtype, device=device)
        return mdec.init_full_state(
            batch, cfg.n_kv, cfg.dh, min(capacity, cfg.attn.local_window),
            dtype=cfg.compute_dtype, device=device)

    rec = [rglru_init_state(batch, cfg.d_model, device)
           for _ in range(2 * n_super(cfg))]
    return RGSuperState(rec1=tfm._stack_states(rec[0::2]),
                        rec2=tfm._stack_states(rec[1::2]),
                        attn=tfm._stack_states([attn()
                                                for _ in range(n_super(cfg))]))


def rg_decode_step(params: Params, states: RGSuperState, token, pos,
                   cfg: nn.ModelConfig):
    """One token for the whole batch at one position.  token: [B]; pos: a
    scalar.  Returns (logits [B, V], states with the attention ``t`` + 1);
    every leaf is written in place."""
    pos = torch.as_tensor(pos, device=token.device)
    x = nn.embed(params["emb"], token, cfg)
    for i in range(n_super(cfg)):
        sp = layer_params(params["supers"], i)
        st = _super_state(states, i)
        h, r1 = rglru_block_decode(sp["rec1"], x, st.rec1, cfg)
        h = _ffn1(sp, h, cfg)
        h, r2 = rglru_block_decode(sp["rec2"], h, st.rec2, cfg)
        x, _ = tfm.block_decode(sp["attn_blk"], h, st.attn, cfg, pos)
        slotted.write_slots(st.rec1, r1)
        slotted.write_slots(st.rec2, r2)
    logits = nn.unembed(params["emb"], nn.rms_norm(x, params["ln_f"]), cfg)
    return logits, states._replace(
        attn=states.attn._replace(t=states.attn.t + 1))


def _super_state(states, i: int):
    return slotted.tree_map(lambda a: a[i], states)


def _super_block_step(sp: Params, x, st: RGSuperState, cfg: nn.ModelConfig,
                      pos, commit=None, due_hint: Optional[bool] = None):
    """One token through one super-block at per-slot positions, writing the
    slots in ``commit`` in place.  x: [S, D]; pos: [S]."""
    h, r1 = rglru_block_decode(sp["rec1"], x, st.rec1, cfg)
    h = _ffn1(sp, h, cfg)
    h, r2 = rglru_block_decode(sp["rec2"], h, st.rec2, cfg)
    h, _ = tfm.block_decode_slots(sp["attn_blk"], h, st.attn, cfg, pos,
                                  commit, due_hint)
    slotted.write_slots(st.rec1, r1, commit)
    slotted.write_slots(st.rec2, r2, commit)
    return h


def rg_slot_decode_step(params: Params, states, token, pos,
                        cfg: nn.ModelConfig, commit=None,
                        due_hint: Optional[bool] = None):
    """One token for the whole slot batch at PER-SLOT positions.  token,
    pos: [S]; commit: [S] bool (None: all).  Returns (logits [S, V],
    states), in place.  ``due_hint`` False (from a caller that knows the
    positions) skips the attention layers' finalize when no slot closes a
    window."""
    x = nn.embed(params["emb"], token, cfg)
    for i in range(n_super(cfg)):
        x = _super_block_step(layer_params(params["supers"], i), x,
                              _super_state(states, i), cfg, pos, commit,
                              due_hint)
    logits = nn.unembed(params["emb"], nn.rms_norm(x, params["ln_f"]), cfg)
    return logits, states


def _rglru_block_prefill(p: Params, x, st: RGLRUState, valid, n_valid,
                         cfg: nn.ModelConfig):
    """One RG-LRU layer over a [S, nc] chunk: norm, projections, conv and
    gates in bulk, the diagonal recurrence per token with the decode
    step's arithmetic.  Writes the layer's state in place."""
    ct = cfg.compute_dtype
    nc = x.shape[1]
    xn = nn.rms_norm(x, p["ln"], cfg.norm_eps)
    gate = _gelu(xn @ p["w_gate"].to(ct))
    xi = xn @ p["w_in"].to(ct)
    padded = torch.cat([st.conv, xi.float()], dim=1)
    xc = _conv_f32(padded, p["conv"], nc, ct)
    a, gated = _rglru_gates(p, xc, ct)
    h = st.h
    hs = []
    for j in range(nc):
        h_new = a[:, j] * h + gated[:, j]
        hs.append(h_new)
        h = torch.where(valid[:, j, None], h_new, h)
    y = (torch.stack(hs, dim=1).to(ct) * gate) @ p["w_out"].to(ct)
    st.h.copy_(h)
    st.conv.copy_(conv_tail(padded, n_valid))
    return x + y


def _host(x) -> np.ndarray:
    return np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x)


def rg_prefill_chunk(params: Params, states, tokens, t0, n_valid,
                     cfg: nn.ModelConfig):
    """Prefill one fixed-shape chunk into a row-packed subset of slots.

    tokens: [S, nc] int32; t0: [S] resume points (RoPE positions continue
    at t0 + j); n_valid: [S] valid tokens per row (0 leaves the row
    untouched).  t0 and n_valid may be host arrays: the attention layers'
    finalize is skipped at the tokens where the host sees no window close.
    Returns (logits [S, V] at each row's last valid position, states), the
    states updated in place."""
    nc = tokens.shape[1]
    dev = tokens.device
    t0_h, nv_h = _host(t0).astype(np.int64), _host(n_valid).astype(np.int64)
    w = cfg.attn.window
    x = nn.embed(params["emb"], tokens, cfg)
    nv = torch.as_tensor(nv_h, device=dev)
    valid = torch.arange(nc, device=dev)[None, :] < nv[:, None]
    pos = torch.as_tensor(t0_h, device=dev)[:, None] \
        + torch.arange(nc, device=dev)
    valid_h = np.arange(nc)[None, :] < nv_h[:, None]
    due_h = (valid_h & ((t0_h[:, None] + np.arange(nc) + 1) % w == 0)) \
        .any(axis=0)
    for i in range(n_super(cfg)):
        sp = layer_params(params["supers"], i)
        st = _super_state(states, i)
        h = _rglru_block_prefill(sp["rec1"], x, st.rec1, valid, nv, cfg)
        h = _ffn1(sp, h, cfg)
        h = _rglru_block_prefill(sp["rec2"], h, st.rec2, valid, nv, cfg)
        ys = []
        for j in range(nc):
            y, _ = tfm.block_decode_slots(sp["attn_blk"], h[:, j], st.attn,
                                          cfg, pos[:, j], valid[:, j],
                                          bool(due_h[j]))
            ys.append(y)
        x = torch.stack(ys, dim=1)
    return nn.last_logits(params, x, nv, cfg), states


def rg_prefill_chunk_seq(params: Params, states, tokens, t0, n_valid,
                         cfg: nn.ModelConfig):
    """Token-sequential reference of `rg_prefill_chunk`: the decode step's
    super-block update scanned over the chunk, masked per token."""
    nc = tokens.shape[1]
    dev = tokens.device
    x = nn.embed(params["emb"], tokens, cfg)
    nv = torch.as_tensor(_host(n_valid), device=dev)
    valid = torch.arange(nc, device=dev)[None, :] < nv[:, None]
    pos = torch.as_tensor(_host(t0), device=dev)[:, None] \
        + torch.arange(nc, device=dev)
    for i in range(n_super(cfg)):
        sp = layer_params(params["supers"], i)
        st = _super_state(states, i)
        x = torch.stack([_super_block_step(sp, x[:, j], st, cfg, pos[:, j],
                                           valid[:, j])
                         for j in range(nc)], dim=1)
    return nn.last_logits(params, x, nv, cfg), states
