"""Mamba-2 (SSD, state-space duality), attention-free (port of
``repro.models.mamba2``).

The full-sequence forward is the chunk-parallel SSD algorithm (Dao & Gu,
2024, "minimal SSD"): quadratic attention-like products inside 64-token
chunks plus a linear recurrence across chunk states, which runs here as a
loop over the chunks (the reference's ``associative_scan`` over them; the
two sum in another order, within float32 rounding).  Decode is the dual
recurrent form: h <- h * exp(dt A) + dt * B (x) x, y = C . h + D x.

Dtype rules of the reference, kept exactly: the projections run in the
compute dtype, the SSD and the decode recurrence in float32; decode and
chunk prefill keep the conv history in float32 and convolve there, the
forward convolves in the compute dtype.  The input projection is padded
to a multiple of 32 columns (`_mamba_proj`), as the reference pads it.

Serving entry points (`serve.backends.recurrent`): states stacked
``[L, S, ...]`` (`mamba_slot_states`); `mamba_decode_step` steps the whole
slot batch, writing only the slots in ``commit``; `mamba_prefill_chunk`
advances a chunk for a row-packed subset of slots: the projections, conv
and gates once over the chunk, the recurrence per token with the decode
step's own arithmetic (`_ssm_update`, `_ssm_read`), so a state rebuilt by
chunks is the state the decode steps build.  Both update the states they
are given in place.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.core import slotted
from repro_torch.models import modules as nn
from repro_torch.models.transformer import layer_params, stack_layers

Params = dict[str, Any]

_CONV_K = 4
_CHUNK = 64
_HDIM = 64
_STATE = 128


def _dims(cfg: nn.ModelConfig):
    d_in = 2 * cfg.d_model
    return d_in, _HDIM, d_in // _HDIM, _STATE


def _segsum(x: torch.Tensor) -> torch.Tensor:
    """[..., T] -> [..., T, T]: L[i, j] = sum_{j < t <= i} x_t, -inf above
    the diagonal (SSD's 1-semiseparable decay mask)."""
    t = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    out = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((t, t), dtype=torch.bool, device=x.device))
    return torch.where(mask, out, -torch.inf)


def ssd_chunked(x, dt, a_log, b, c, chunk: int = _CHUNK):
    """Chunk-parallel SSD.  x: [B, L, H, P]; dt: [B, L, H] (softplus'd);
    a_log: [H] (A = -exp(a_log)); b, c: [B, L, S] (one group).  Returns
    y [B, L, H, P]."""
    bsz, l, h, p = x.shape
    s = b.shape[-1]
    nc = l // chunk
    q = chunk
    da = dt * (-torch.exp(a_log.float()))[None, None, :]          # [B,L,H]
    xdt = x * dt[..., None]
    da_c = da.reshape(bsz, nc, q, h).permute(0, 3, 1, 2)          # [B,H,C,Q]
    x_c = xdt.reshape(bsz, nc, q, h, p)
    b_c = b.reshape(bsz, nc, q, s)
    c_c = c.reshape(bsz, nc, q, s)
    a_cs = torch.cumsum(da_c, dim=-1)

    # 1) intra-chunk (diagonal blocks)
    lmask = torch.exp(_segsum(da_c))                              # [B,H,C,Q,Q]
    cb = torch.einsum("bcis,bcjs->bcij", c_c, b_c)
    y_diag = torch.einsum("bcij,bhcij,bcjhp->bcihp", cb, lmask, x_c)

    # 2) each chunk's final state
    decay_states = torch.exp(a_cs[..., -1:] - a_cs)               # [B,H,C,Q]
    states = torch.einsum("bcjs,bhcj,bcjhp->bchps", b_c, decay_states, x_c)

    # 3) the linear recurrence over chunk states: the state BEFORE chunk c
    chunk_decay = torch.exp(a_cs[..., -1]).permute(0, 2, 1)       # [B,C,H]
    prev = [torch.zeros_like(states[:, 0])]
    for ci in range(nc - 1):
        prev.append(prev[-1] * chunk_decay[:, ci, :, None, None]
                    + states[:, ci])
    prev = torch.stack(prev, dim=1)                               # [B,C,H,P,S]

    # 4) state -> output
    state_decay = torch.exp(a_cs)
    y_off = torch.einsum("bcis,bhci,bchps->bcihp", c_c, state_decay, prev)
    return (y_diag + y_off).reshape(bsz, l, h, p)


def mamba_block_init(gen, cfg: nn.ModelConfig, device) -> Params:
    d = cfg.d_model
    d_in, _, heads, s = _dims(cfg)
    pd = cfg.param_dtype
    return {
        "ln": torch.zeros((d,), dtype=pd, device=device),
        "w_in": nn.dense_init(gen, d, 2 * d_in + 2 * s + heads, pd, device),
        "conv": nn._normal(gen, (_CONV_K, d_in + 2 * s), 0.1, pd, device),
        "a_log": torch.zeros((heads,), dtype=pd, device=device),
        "dt_bias": torch.full((heads,), -1.0, dtype=pd, device=device),
        "d_skip": torch.ones((heads,), dtype=pd, device=device),
        "ln_y": torch.zeros((d_in,), dtype=pd, device=device),
        "w_out": nn.dense_init(gen, d_in, d, pd, device),
    }


def _mamba_proj(p: Params, xn, cfg: nn.ModelConfig):
    """Input projection split into (z, xbc, dt).  The weight is padded with
    zero columns to a multiple of 32, as the reference pads it (there it
    keeps the chunk prefill's and the decode step's GEMMs on one CPU
    micro-kernel); the real columns' products are unchanged."""
    d_in, hdim, heads, s = _dims(cfg)
    ct = cfg.compute_dtype
    w_in = p["w_in"].to(ct)
    pad = (-w_in.shape[-1]) % 32
    if pad:
        w_in = torch.cat([w_in, w_in.new_zeros((w_in.shape[0], pad))], -1)
    zxbcdt = (xn @ w_in)[..., :2 * d_in + 2 * s + heads]
    z = zxbcdt[..., :d_in]
    xbc = zxbcdt[..., d_in:2 * d_in + 2 * s]
    dt = F.softplus(zxbcdt[..., 2 * d_in + 2 * s:].float()
                    + p["dt_bias"].float())
    return z, xbc, dt, (d_in, hdim, heads, s)


def _gate_out(p: Params, x, y, z, cfg: nn.ModelConfig):
    """Norm of the gated output, output projection, residual."""
    ct = cfg.compute_dtype
    y = nn.rms_norm(y.to(ct) * F.silu(z), p["ln_y"], cfg.norm_eps)
    return x + y @ p["w_out"].to(ct)


def mamba_block_apply(p: Params, x, cfg: nn.ModelConfig):
    ct = cfg.compute_dtype
    bsz, l, _ = x.shape
    xn = nn.rms_norm(x, p["ln"], cfg.norm_eps)
    z, xbc, dt, (d_in, hdim, heads, s) = _mamba_proj(p, xn, cfg)
    xpad = F.pad(xbc, (0, 0, _CONV_K - 1, 0))
    conv = p["conv"].to(ct)
    acc = xpad[:, 0:l] * conv[0]
    for j in range(1, _CONV_K):
        acc = acc + xpad[:, j:j + l] * conv[j]
    xbc = F.silu(acc)
    xs = xbc[..., :d_in].reshape(bsz, l, heads, hdim)
    b = xbc[..., d_in:d_in + s]
    c = xbc[..., d_in + s:]
    y = ssd_chunked(xs.float(), dt, p["a_log"], b.float(), c.float(),
                    chunk=min(_CHUNK, l))
    y = y + xs.float() * p["d_skip"].float()[None, None, :, None]
    return _gate_out(p, x, y.reshape(bsz, l, d_in), z, cfg)


def mamba_init(gen: torch.Generator, cfg: nn.ModelConfig,
               device="cuda") -> Params:
    """Random parameters with the reference's shapes, dtypes and scales,
    per-layer leaves stacked on axis 0."""
    emb = nn.embedding_init(gen, cfg, device)
    blocks = [mamba_block_init(gen, cfg, device) for _ in range(cfg.n_layers)]
    return {"emb": emb, "blocks": stack_layers(blocks),
            "ln_f": torch.zeros((cfg.d_model,), dtype=cfg.param_dtype,
                                device=device)}


def mamba_forward(params: Params, tokens, cfg: nn.ModelConfig):
    """tokens [B, N] (N a multiple of 64, or < 64) -> (logits [B, N, V],
    aux 0)."""
    x = nn.embed(params["emb"], tokens, cfg)
    for i in range(cfg.n_layers):
        x = nn.layer_call(cfg, mamba_block_apply,
                          layer_params(params["blocks"], i), x, cfg)
    x = nn.rms_norm(x, params["ln_f"])
    return nn.unembed(params["emb"], x, cfg), torch.zeros((), device=x.device)


def mamba_loss(params: Params, batch: dict, cfg: nn.ModelConfig):
    dev = params["ln_f"].device

    def up(x):
        return None if x is None else torch.as_tensor(x, device=dev)

    logits, _ = mamba_forward(params, up(batch["tokens"]), cfg)
    return nn.cross_entropy(logits, up(batch["labels"]),
                            up(batch.get("loss_mask")))


class MambaState(NamedTuple):
    h: torch.Tensor      # [B, H, P, S] ssm state, float32
    conv: torch.Tensor   # [B, _CONV_K - 1, d_in + 2S] conv history, float32


def mamba_init_decode_states(cfg: nn.ModelConfig, batch: int,
                             capacity: int = 0, device="cuda") -> MambaState:
    """Zero states stacked over layers: leaves [L, B, ...]."""
    d_in, hdim, heads, s = _dims(cfg)
    return MambaState(
        h=torch.zeros((cfg.n_layers, batch, heads, hdim, s),
                      dtype=torch.float32, device=device),
        conv=torch.zeros((cfg.n_layers, batch, _CONV_K - 1, d_in + 2 * s),
                         dtype=torch.float32, device=device))


def _ssm_update(h, da, dt, xs, b):
    """h * da + dt (x) xs (x) b: the recurrence step, one token.  h
    [B, H, P, S]; da, dt [B, H]; xs [B, H, P]; b [B, S]."""
    return h * da[..., None, None] + torch.einsum("bh,bhp,bs->bhps", dt, xs,
                                                  b)


def _ssm_read(h, c):
    return torch.einsum("bhps,bs->bhp", h, c)


def _conv_silu(hist, conv, n: int):
    """silu of the width-4 causal conv over float32 history rows
    [B, n + 3, C]: row j of the result reads hist[:, j .. j + 3]."""
    cw = conv.float()
    acc = hist[:, 0:n] * cw[0]
    for j in range(1, _CONV_K):
        acc = acc + hist[:, j:j + n] * cw[j]
    return F.silu(acc).float()


def mamba_block_decode(p: Params, x, st: MambaState, cfg: nn.ModelConfig):
    """x: [B, D], one token.  Returns (x', new MambaState)."""
    bsz = x.shape[0]
    xn = nn.rms_norm(x, p["ln"], cfg.norm_eps)
    z, xbc, dt, (d_in, hdim, heads, s) = _mamba_proj(p, xn[:, None, :], cfg)
    z, xbc, dt = z[:, 0], xbc[:, 0], dt[:, 0]
    hist = torch.cat([st.conv, xbc[:, None, :].float()], dim=1)
    xbc = _conv_silu(hist, p["conv"], 1)[:, 0]
    xs = xbc[..., :d_in].reshape(bsz, heads, hdim)
    b = xbc[..., d_in:d_in + s]
    c = xbc[..., d_in + s:]
    da = torch.exp(dt * (-torch.exp(p["a_log"].float()))[None, :])
    h = _ssm_update(st.h, da, dt, xs, b)
    y = _ssm_read(h, c) + xs * p["d_skip"].float()[None, :, None]
    return (_gate_out(p, x, y.reshape(bsz, d_in), z, cfg),
            MambaState(h=h, conv=hist[:, 1:]))


def mamba_decode_step(params: Params, states: MambaState, token, pos,
                      cfg: nn.ModelConfig, commit=None):
    """token: [S] int32 (pos unused: the recurrence is position-free).
    Returns (logits [S, V], states); the slots in ``commit`` [S] bool
    (None: all) advance in place, the others keep their bits."""
    del pos
    x = nn.embed(params["emb"], token, cfg)
    for i in range(cfg.n_layers):
        st = MambaState(states.h[i], states.conv[i])
        x, new = mamba_block_decode(layer_params(params["blocks"], i), x, st,
                                    cfg)
        slotted.write_slots(st, new, commit)
    logits = nn.unembed(params["emb"], nn.rms_norm(x, params["ln_f"]), cfg)
    return logits, states


def mamba_slot_states(cfg: nn.ModelConfig, n_slots: int,
                      device="cuda") -> MambaState:
    """Stacked per-layer slot states (leaves [L, S, ...])."""
    return mamba_init_decode_states(cfg, n_slots, 0, device)


def conv_tail(padded, n_valid):
    """The last _CONV_K - 1 raw inputs at each row's last valid token
    (n_valid == 0 reads straight back the old history)."""
    idx = n_valid.long()[:, None] + torch.arange(
        _CONV_K - 1, device=padded.device)[None, :]
    return torch.gather(padded, 1, idx[..., None].expand(
        idx.shape + (padded.shape[-1],)))


def _mamba_block_prefill(p: Params, x, st: MambaState, valid, n_valid,
                         cfg: nn.ModelConfig):
    """One layer over a [S, nc] chunk: norm, projection, conv, gates and
    output path in bulk; the recurrence per token, with the decode step's
    arithmetic, masked by validity.  Writes the layer's state in place."""
    bsz, nc, _ = x.shape
    xn = nn.rms_norm(x, p["ln"], cfg.norm_eps)
    z, xbc, dt, (d_in, hdim, heads, s) = _mamba_proj(p, xn, cfg)
    padded = torch.cat([st.conv, xbc.float()], dim=1)
    xbc = _conv_silu(padded, p["conv"], nc)
    xs = xbc[..., :d_in].reshape(bsz, nc, heads, hdim)
    b = xbc[..., d_in:d_in + s]
    c = xbc[..., d_in + s:]
    da = torch.exp(dt * (-torch.exp(p["a_log"].float()))[None, None, :])
    h = st.h
    ys = []
    for j in range(nc):
        h_new = _ssm_update(h, da[:, j], dt[:, j], xs[:, j], b[:, j])
        ys.append(_ssm_read(h_new, c[:, j]))
        h = torch.where(valid[:, j, None, None, None], h_new, h)
    y = torch.stack(ys, dim=1) \
        + xs * p["d_skip"].float()[None, None, :, None]
    out = _gate_out(p, x, y.reshape(bsz, nc, d_in), z, cfg)
    st.h.copy_(h)
    st.conv.copy_(conv_tail(padded, n_valid))
    return out


def mamba_prefill_chunk(params: Params, states: MambaState, tokens, t0,
                        n_valid, cfg: nn.ModelConfig):
    """Prefill one fixed-shape chunk into a row-packed subset of slots.

    tokens: [S, nc] int32; t0: [S] (unused: the recurrence is
    position-free; kept for the hybrid's signature); n_valid: [S] valid
    tokens per row (0 leaves the row's state untouched).  Returns
    (logits [S, V] at each row's last valid position, states), the states
    updated in place."""
    del t0
    nc = tokens.shape[1]
    x = nn.embed(params["emb"], tokens, cfg)
    valid = torch.arange(nc, device=x.device)[None, :] \
        < n_valid.long()[:, None]
    for i in range(cfg.n_layers):
        x = _mamba_block_prefill(layer_params(params["blocks"], i), x,
                                 MambaState(states.h[i], states.conv[i]),
                                 valid, n_valid, cfg)
    return nn.last_logits(params, x, n_valid, cfg), states


def mamba_prefill_chunk_seq(params: Params, states: MambaState, tokens, t0,
                            n_valid, cfg: nn.ModelConfig):
    """Token-sequential reference of `mamba_prefill_chunk`: the decode
    step's block update scanned over the chunk, masked per token."""
    del t0
    nc = tokens.shape[1]
    x = nn.embed(params["emb"], tokens, cfg)
    valid = torch.arange(nc, device=x.device)[None, :] \
        < n_valid.long()[:, None]
    for i in range(cfg.n_layers):
        bp = layer_params(params["blocks"], i)
        st = MambaState(states.h[i], states.conv[i])
        ys = []
        for j in range(nc):
            y, new = mamba_block_decode(bp, x[:, j], st, cfg)
            slotted.write_slots(st, new, valid[:, j])
            ys.append(y)
        x = torch.stack(ys, dim=1)
    return nn.last_logits(params, x, n_valid, cfg), states
