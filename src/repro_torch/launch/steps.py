"""Per-family model functions, the train step and the cells of every
(arch x shape) pair (port of ``repro.launch.steps``).

`family_fns(arch)` gives each family's ``init`` (from a
``torch.Generator``), ``loss`` and, where the reference has them in batch
form, ``prefill`` / ``decode`` / ``init_states``.  `train_step` is the
reference's ``build_cell(..., kind="train").fn`` on one process: the
loss's gradients (accumulated over microbatches in float32), then one
AdamW update.

`build_cell(arch, shape, mesh)` returns what a trainer, server or dry run
needs: the step function, its arguments as meta tensors (shapes and
dtypes, no memory) and the DTensor placements of its inputs and outputs
(`distributed.sharding`).  A train cell's function is
`sharded_train_step`: parameters and AdamW moments are DTensors sharded
as ``param_specs`` says; each rank gathers the full parameters once a
step, computes the gradients of its "data" share of the batch with the
model code as it is, and reduces them into the parameters' placement.
The "model" axis therefore partitions memory, not compute (ROADMAP C.16).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate

from repro_torch.configs.registry import ArchConfig, ShapeSpec
from repro_torch.distributed import sharding as shd
from repro_torch.models import mamba2 as mb
from repro_torch.models import rglru as rg
from repro_torch.models import transformer as tfm
from repro_torch.models import whisper as wh
from repro_torch.optim.adamw import (AdamWState, OptConfig, adamw_init,
                                     adamw_update, tree_map)
from repro_torch.optim.grads import accumulate_grads, batch_share


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
        return dict(
            init=lambda gen, device="cuda": rg.rg_init(gen, cfg, device),
            loss=lambda p, b: rg.rg_loss(p, b, cfg),
            prefill=None,
            decode=lambda p, st, tok, pos: rg.rg_decode_step(p, st, tok,
                                                             pos, cfg),
            init_states=lambda b, cap, device="cuda":
                rg.rg_init_decode_states(cfg, b, cap, device),
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


def train_step(params, opt_state: AdamWState, batch: dict,
               loss_fn: Callable, opt_cfg: OptConfig, microbatch: int = 1):
    """One training step: (new params, new opt state, metrics {"loss",
    "lr", "grad_norm"}), each metric a float32 scalar on the device.
    Gradients as `accumulate_grads` gives them.  A loss that needs a
    backward the port lacks (the expert kernel, ``impl="pallas"``)
    raises."""
    loss, grads = accumulate_grads(params, batch, loss_fn, microbatch)
    new_p, new_opt, metrics = adamw_update(grads, opt_state, params, opt_cfg)
    metrics["loss"] = loss
    return new_p, new_opt, metrics


# ---------------------------------------------------------- sharded step ---

def data_index(mesh) -> int:
    """This rank's index along the mesh's batch axes ("pod" major)."""
    coord = mesh.get_coordinate()
    sizes = shd.axis_sizes(mesh)
    idx = 0
    for name in shd.batch_axes(mesh):
        idx = idx * sizes[name] + coord[mesh.mesh_dim_names.index(name)]
    return idx


def data_rows(batch: dict, mesh) -> dict:
    """This rank's share of the global batch, as ``batch_spec`` shards a
    batch whose size the data axes divide."""
    return batch_share(batch, shd.data_size(mesh), data_index(mesh))


def _per_data_rank(x: torch.Tensor, mesh) -> DTensor:
    """``x`` as one term of a sum over the data ranks (replicated over the
    other axes)."""
    pl = [Partial() if n in shd.batch_axes(mesh) else Replicate()
          for n in mesh.mesh_dim_names]
    return DTensor.from_local(x, mesh, pl, run_check=False)


def sharded_train_step(params, opt_state: AdamWState, batch: dict,
                       loss_fn: Callable, opt_cfg: OptConfig, mesh,
                       microbatch: int = 1):
    """One training step on ``mesh``: the result of `train_step` on the
    whole batch with one microbatch per data rank (``microbatch`` x the
    data ranks in all), each rank holding only its shard of every
    parameter and moment.

    ``params`` and ``opt_state`` are DTensors on ``mesh`` (a train cell's
    ``in_shardings``); ``batch`` is the global batch, the same on every
    rank.  Each rank gathers the full parameters, takes its data share of
    the batch (`data_rows`), computes the loss and gradients with
    `accumulate_grads` (split into ``microbatch`` slices), and turns every
    gradient into its parameter's placement: a sum over the data ranks,
    divided by their count.  Where the batch has a "loss_mask", each
    rank's loss and gradients are first weighted by its share of the
    counted labels, so that the result is the whole batch's masked mean
    (a whole batch with none counts one, as `cross_entropy` does: loss
    and gradients 0, as in `train_step`).  AdamW then runs on the DTensors (its global norm sums over shards)."""
    full = tree_map(lambda t: t.full_tensor(), params)
    local = data_rows(batch, mesh)
    loss, grads = accumulate_grads(full, local, loss_fn, microbatch)
    del full
    dev = loss.device
    dp = torch.tensor(float(shd.data_size(mesh)), dtype=torch.float32,
                      device=dev)
    if "loss_mask" in local:
        count = torch.as_tensor(local["loss_mask"], device=dev).float().sum()
        total = _per_data_rank(count, mesh).full_tensor()
        w = count * dp / torch.clamp(total, min=1.0)
        loss = loss * w
        grads = tree_map(lambda g: g * w, grads)
    grads = tree_map(lambda g, p: _per_data_rank(g, mesh).redistribute(
        mesh, p.placements) / dp, grads, params)
    new_p, new_opt, metrics = adamw_update(grads, opt_state, params, opt_cfg)
    metrics = {k: v.full_tensor() if isinstance(v, DTensor) else v
               for k, v in metrics.items()}
    metrics["loss"] = _per_data_rank(loss, mesh).full_tensor() / dp
    return new_p, new_opt, metrics


# ------------------------------------------------------------------ cells ---

@dataclasses.dataclass
class Cell:
    name: str
    fn: Callable              # the step function
    args: tuple               # meta tensors: shapes and dtypes only
    in_shardings: tuple       # DTensor placement trees of the arguments
    out_shardings: Any        # placement trees of the outputs (None: free)
    donate_argnums: tuple = ()


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def abstract_params(arch: ArchConfig):
    """The parameter tree of ``arch`` as meta tensors: the shapes and
    dtypes of `family_fns`' init, no weights in memory."""
    return family_fns(arch)["init"](torch.Generator(), "meta")


def _train_batch_shapes(arch: ArchConfig, shape: ShapeSpec) -> dict:
    cfg = arch.model
    b, s = shape.batch, shape.seq
    i32 = torch.int32
    if arch.family == "encdec":
        # audio frames (stub frontend) + the native decoder length
        return {"audio_embeds": _meta((b, arch.t_enc, cfg.d_model),
                                      cfg.compute_dtype),
                "tokens": _meta((b, arch.dec_len), i32),
                "labels": _meta((b, arch.dec_len), i32)}
    batch = {"tokens": _meta((b, s), i32), "labels": _meta((b, s), i32)}
    if arch.family == "vlm":
        batch["image_embeds"] = _meta((b, arch.n_img_tokens, cfg.d_model),
                                      cfg.compute_dtype)
    return batch


def _batch_shardings(batch: dict, mesh, b: int) -> dict:
    return {k: shd.placements(shd.batch_spec(mesh, b, rank=v.dim()), mesh)
            for k, v in batch.items()}


def build_cell(arch: ArchConfig, shape: ShapeSpec, mesh,
               opt_cfg: Optional[OptConfig] = None,
               state_policy: str = "seq", microbatch: int = 1) -> Cell:
    """The cell of ``arch`` at ``shape`` on ``mesh``: train (params,
    AdamW state, batch) -> (params, state, metrics); prefill (params,
    batch) -> (last logits, decode states), for the ssm and hybrid
    families the last position's logits of a forward, for the encdec
    family the encoder's output; decode (params, states, token [B], pos)
    -> (logits, states), whisper at its native decoder length."""
    fns = family_fns(arch)
    cfg = arch.model
    params = abstract_params(arch)
    psh = shd.tree_shardings(shd.param_specs(params, mesh), mesh)
    replicated = [Replicate()] * mesh.ndim
    name = f"{arch.arch_id}:{shape.name}"

    if shape.kind == "train":
        opt_cfg = opt_cfg or OptConfig()
        opt_sh = AdamWState(mu=psh, nu=psh, step=replicated)
        batch = _train_batch_shapes(arch, shape)
        loss_fn = fns["loss"]

        def step(p, opt, b):
            return sharded_train_step(p, opt, b, loss_fn, opt_cfg, mesh,
                                      microbatch)

        return Cell(name=name, fn=step,
                    args=(params, adamw_init(params), batch),
                    in_shardings=(psh, opt_sh,
                                  _batch_shardings(batch, mesh, shape.batch)),
                    out_shardings=(psh, opt_sh, None),
                    donate_argnums=(0, 1))

    if shape.kind == "prefill":
        if arch.family == "encdec":
            # encoder prefill over the (stub) audio memory
            audio = _meta((shape.batch, arch.t_enc, cfg.d_model),
                          cfg.compute_dtype)
            ash = shd.placements(shd.batch_spec(mesh, shape.batch, 3), mesh)
            return Cell(name=name,
                        fn=lambda p, a: wh.whisper_encode(p, a, cfg),
                        args=(params, audio), in_shardings=(psh, ash),
                        out_shardings=None)
        if fns["prefill"] is None:
            # ssm / hybrid prefill == a forward pass at that length
            batch = {"tokens": _meta((shape.batch, shape.seq), torch.int32)}
            forward = (mb.mamba_forward if arch.family == "ssm"
                       else rg.rg_forward)
            return Cell(name=name,
                        fn=lambda p, b: forward(p, b["tokens"], cfg)[0][:, -1],
                        args=(params, batch),
                        in_shardings=(psh, _batch_shardings(batch, mesh,
                                                            shape.batch)),
                        out_shardings=None)
        batch = _train_batch_shapes(arch, dataclasses.replace(shape,
                                                              kind="train"))
        batch.pop("labels")
        prefill = fns["prefill"]
        return Cell(name=name,
                    fn=lambda p, b: prefill(p, b, shape.seq),
                    args=(params, batch),
                    in_shardings=(psh, _batch_shardings(batch, mesh,
                                                        shape.batch)),
                    out_shardings=None)

    # ---- decode ----
    b = shape.batch
    cap = shape.seq
    if arch.family == "encdec":
        cap = arch.dec_len     # the native decoder capacity
        states = wh.whisper_init_serve(
            params, _meta((b, arch.t_enc, cfg.d_model), cfg.compute_dtype),
            cfg, cap)
    else:
        states = fns["init_states"](b, cap, "meta")
    st_sh = shd.tree_shardings(
        shd.state_specs(states, mesh, b, policy=state_policy), mesh)
    tok_sh = shd.placements(shd.batch_spec(mesh, b, rank=1,
                                           shard_seq_if_small=False), mesh)
    return Cell(name=name, fn=fns["decode"],
                args=(params, states, _meta((b,), torch.int32),
                      _meta((), torch.int32)),
                in_shardings=(psh, st_sh, tok_sh, replicated),
                out_shardings=(None, st_sh), donate_argnums=(1,))
