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
(`distributed.sharding`).  Each rank takes its "data" share of the batch
and computes in one of two ways (ROADMAP C.16):

* Tensor- and expert-parallel: the train and prefill cells of the
  transformer LM families (``dense``, ``moe`` and the ``vlm``'s LM) and
  of the ``hybrid`` family on a mesh whose "model" axis has M > 1 ranks
  (`distributed.tensor_parallel`).  Each rank runs the model code on its
  own parameter shards with a local config (heads, the dense FFN's width
  and, where the specs split it, the vocabulary divided by M) and never
  gathers a whole weight over "model": one all-reduce a block after
  ``attn/wo`` and one after the FFN each pass, a vocabulary-parallel
  embedding and loss, and the KV-group rule where M exceeds ``n_kv`` (a
  group's columns of wq, wk and wv gathered among the ranks that share
  it).  An MoE layer routes every token over all experts and computes
  only the rank's E / M experts (and its part of the shared expert)
  before its one all-reduce; the VLM's image embeddings are the rank's
  data rows.  A hybrid RG-LRU block computes the rank's channels of the
  recurrent width: one all-gather of its conv output (which the gate
  products take whole) and one all-reduce after ``w_out`` each pass; its
  attention and FFNs are the dense plan's.  Its gradients are already the
  rank's shards; they are summed over the data ranks (and over "model"
  for the replicated ``q_norm``, ``k_norm`` and router).  The prefill
  cell assembles its logits (split over the vocabulary) and decode
  states (split over KV heads) into their placements with one all-to-all
  a leaf; the hybrid's prefill (a forward) its last logits.
* Gather-once, every other cell: the decode cells, the ``ssm`` and
  ``encdec`` families, any cell at M = 1 and a split that
  ``tensor_parallel.model_split`` does not plan.  Each rank gathers the
  full parameters once a call (and the decode states over the other
  axes), runs the model code as it is, and places what it returns;
  there "model" partitions memory, not compute.

A train cell's function is `sharded_train_step`, which reduces the
gradients into the parameters' placement and updates the parameters and
moments it is given in place (the cell donates them, ``donate_argnums``,
as the reference's does); a prefill or decode cell's outputs are local
slices of what the rank computed (or assembled).  Given plain tensors
instead of DTensors, a prefill or decode cell is the plain function.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.configs.registry import ArchConfig, ShapeSpec
from repro_torch.distributed import sharding as shd
from repro_torch.distributed import tensor_parallel as tpar
from repro_torch.models import mamba2 as mb
from repro_torch.models import rglru as rg
from repro_torch.models import transformer as tfm
from repro_torch.models import whisper as wh
from repro_torch.optim.adamw import (AdamWState, OptConfig, adamw_init,
                                     adamw_update_, tree_leaves, tree_map)
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
    """One training step: (params, opt state, metrics {"loss", "lr",
    "grad_norm"}), each metric a float32 scalar on the device.
    ``params`` and ``opt_state`` are donated, as the reference's train
    cell donates them: AdamW updates them in place (`adamw_update_`) and
    they are returned; a caller that reads them after the step passes
    clones.  Gradients as `accumulate_grads` gives them.  A loss that
    needs a backward the port lacks (the expert kernel,
    ``impl="pallas"``) raises."""
    loss, grads = accumulate_grads(params, batch, loss_fn, microbatch)
    params, opt_state, metrics = adamw_update_(grads, opt_state, params,
                                               opt_cfg)
    metrics["loss"] = loss
    return params, opt_state, metrics


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
    batch whose size the data axes divide: a slice of a plain entry (the
    same on every rank), the local rows of a DTensor one."""
    out = batch_share({k: v for k, v in batch.items()
                       if not isinstance(v, DTensor)},
                      shd.data_size(mesh), data_index(mesh))
    for k, v in batch.items():
        if isinstance(v, DTensor):
            if v.shape[0] % shd.data_size(mesh):
                raise ValueError(f"batch {k!r} of {v.shape[0]} rows does "
                                 f"not split into {shd.data_size(mesh)} "
                                 "shares")
            out[k] = rank_rows(v, mesh, 0, True)
    return {k: out[k] for k in batch}


def rank_rows(x, mesh, dim: int, by_rows: bool) -> torch.Tensor:
    """A DTensor as this rank's plain tensor: gathered over every mesh
    axis but, with ``by_rows``, the batch axes, whose shards of dimension
    ``dim`` (the rows) it keeps.  A plain tensor comes back as it is."""
    if not isinstance(x, DTensor):
        return x
    return x.redistribute(mesh, rows_placements(mesh, dim, by_rows)) \
        .to_local()


def place_rows(x: torch.Tensor, mesh, placements, dim: int, by_rows: bool,
               shape, model_part: Optional[Callable] = None) -> DTensor:
    """The inverse of `rank_rows`: ``x`` is this rank's part of a tensor
    of global ``shape``, its data rows of dimension ``dim`` (``by_rows``)
    or all of it, every other dimension whole.  Returns the DTensor of
    ``placements``; every shard is a local slice (no collective).  With
    ``model_part``, ``x`` is instead split over the "model" ranks, and
    ``model_part(x, placement)`` gives this rank's part under its
    placement on that axis (`tensor_parallel.ModelSplit.assemble`)."""
    coord = mesh.get_coordinate()
    for i, (n, pl) in enumerate(zip(mesh.mesh_dim_names, placements)):
        if model_part is not None and n == "model":
            x = model_part(x, pl)
            continue
        if not isinstance(pl, Shard):
            continue
        if by_rows and n in shd.batch_axes(mesh) and pl.dim == dim:
            continue                      # x holds only this rank's rows
        x = x.chunk(mesh.size(i), dim=pl.dim)[coord[i]]
    return DTensor.from_local(x.contiguous(), mesh, placements,
                              run_check=False, shape=torch.Size(shape),
                              stride=contiguous_stride(shape))


def contiguous_stride(shape) -> tuple:
    """The strides of a contiguous tensor of ``shape``, as ``torch.empty(
    shape).stride()`` gives them, without making one: inside a dry run's
    fake mode an empty tensor of a global shape counts as live memory."""
    stride, acc = [], 1
    for n in reversed(tuple(shape)):
        stride.append(acc)
        acc *= max(n, 1)
    return tuple(reversed(stride))


def rows_placements(mesh, dim: int, by_rows: bool) -> list:
    """Placements of a tensor whose dimension ``dim`` is the batch: split
    over the batch axes (``by_rows``), replicated elsewhere."""
    return [Shard(dim) if by_rows and n in shd.batch_axes(mesh)
            else Replicate() for n in mesh.mesh_dim_names]


def zip_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` leaf by leaf over trees of ``tree``'s structure (dicts,
    NamedTuples, lists and tuples: decode states; a placement list of a
    `distributed.sharding.tree_shardings` tree is one leaf)."""
    if isinstance(tree, dict):
        return {k: zip_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(zip_map(fn, getattr(tree, f),
                                    *(getattr(r, f) for r in rest))
                            for f in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(zip_map(fn, x, *(r[i] for r in rest))
                          for i, x in enumerate(tree))
    return fn(tree, *rest)


def _is_sharded(params) -> bool:
    return any(isinstance(x, DTensor) for x in tree_leaves(params))


def _full(params):
    return tree_map(lambda t: t.full_tensor(), params)


def _state_rows(x) -> bool:
    """Whether a decode-state leaf has the batch at dimension 1 (every
    leaf of rank 3 or more; ``state_specs`` replicates the rest)."""
    return x.dim() >= 3


def _per_data_rank(x: torch.Tensor, mesh) -> DTensor:
    """``x`` as one term of a sum over the data ranks (replicated over the
    other axes)."""
    pl = [Partial() if n in shd.batch_axes(mesh) else Replicate()
          for n in mesh.mesh_dim_names]
    return DTensor.from_local(x, mesh, pl, run_check=False)


def _split_grad(g: torch.Tensor, p: DTensor, mesh,
                split: tpar.ModelSplit, over_model: bool) -> DTensor:
    """A tensor-parallel rank's gradient of its shard of ``p`` as one
    term of a sum over the data ranks, first summed over "model" where
    ``over_model`` (a replicated leaf of the split region)."""
    if over_model:
        g = split.sum(g)
    pl = [Partial() if n in shd.batch_axes(mesh) else pp
          for n, pp in zip(mesh.mesh_dim_names, p.placements)]
    return DTensor.from_local(g, mesh, pl, run_check=False, shape=p.shape,
                              stride=p.stride())


def sharded_train_step(params, opt_state: AdamWState, batch: dict,
                       loss_fn: Callable, opt_cfg: OptConfig, mesh,
                       microbatch: int = 1,
                       split: Optional[tpar.ModelSplit] = None):
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
    divided by their count.  With ``split`` (a transformer LM family
    with the "model" axis split, `tensor_parallel.model_split`), it gathers
    nothing: ``loss_fn`` runs on the rank's local shards, whose gradients
    are already its shards' (summed over "model" too for the leaves
    ``split.sum_over_model`` marks).  Where the batch has a "loss_mask",
    each rank's loss and gradients are first weighted by its share of the
    counted labels, so that the result is the whole batch's masked mean
    (a whole batch with none counts one, as `cross_entropy` does: loss
    and gradients 0, as in `train_step`).  The gradients are placed leaf
    by leaf (`_placed_grads`), so one copy of them lives at a time.  AdamW
    then runs on the DTensors' local shards (its global norm sums over
    shards).  ``params`` and ``opt_state`` are donated, as in
    `train_step`: updated in place and returned."""
    local = data_rows(batch, mesh)
    if split is None:
        full = _full(params)
        loss, grads = accumulate_grads(full, local, loss_fn, microbatch)
        del full
    else:
        loss, grads = accumulate_grads(
            tree_map(lambda t: t.to_local(), params), local, loss_fn,
            microbatch)
    dev = loss.device
    dp = torch.tensor(float(shd.data_size(mesh)), dtype=torch.float32,
                      device=dev)
    if "loss_mask" in local:
        count = torch.as_tensor(local["loss_mask"], device=dev).float().sum()
        total = _per_data_rank(count, mesh).full_tensor()
        w = count * dp / torch.clamp(total, min=1.0)
        loss = loss * w
        for g in tree_leaves(grads):
            g.mul_(w)
    grads = _placed_grads(grads, params, mesh, split, dp,
                          None if split is None else split.sum_over_model)
    params, opt_state, metrics = adamw_update_(grads, opt_state, params,
                                               opt_cfg)
    metrics = {k: v.full_tensor() if isinstance(v, DTensor) else v
               for k, v in metrics.items()}
    metrics["loss"] = _per_data_rank(loss, mesh).full_tensor() / dp
    return params, opt_state, metrics


def _placed_grads(grads: dict, params: dict, mesh, split, dp, over) -> dict:
    """This rank's local gradients (a tree, emptied as it goes) as
    DTensors in their parameters' placements, each a sum over the data
    ranks divided by ``dp`` in place; placed leaf by leaf, each local
    gradient dropped once placed, so that one copy of the gradients lives
    at a time.  ``over``: `ModelSplit.sum_over_model` (None: no
    split)."""
    out = {}
    for k in list(grads):
        g = grads.pop(k)
        sub = None if over is None else over[k]
        if isinstance(g, dict):
            out[k] = _placed_grads(g, params[k], mesh, split, dp, sub)
            continue
        p = params[k]
        g = _per_data_rank(g, mesh) if split is None \
            else _split_grad(g, p, mesh, split, sub)
        out[k] = g.redistribute(mesh, p.placements)
        del g
        with torch.no_grad():
            out[k].to_local().div_(dp)
    return out


# ------------------------------------------------------------------ cells ---

def _by_vocab(split: tpar.ModelSplit) -> Optional[Callable]:
    """`place_rows`' ``model_part`` for logits whose classes are split over
    "model" (None where the vocabulary is whole on every rank)."""
    if split.vocab is None:
        return None
    return lambda x, pl: split.assemble(x, -1, pl)

@dataclasses.dataclass
class Cell:
    name: str
    fn: Callable              # the step function
    args: tuple               # meta tensors: shapes and dtypes only
    in_shardings: tuple       # DTensor placement trees of the arguments
    out_shardings: Any        # placement trees of the outputs (None: free)
    donate_argnums: tuple = ()


def split_loss(arch: ArchConfig, split: tpar.ModelSplit) -> Callable:
    """The family's loss on a rank's shards under ``split``."""
    if arch.family == "hybrid":
        return lambda p, b: rg.rg_loss(p, b, split.cfg, tp=split)
    return lambda p, b: tfm.lm_loss(p, b, split.cfg, tp=split)


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
    -> (logits, states), whisper at its native decoder length.  A prefill
    or decode cell's outputs split the batch over the data axes where it
    divides (its logits' and encoder output's rows; decode states as
    ``state_specs`` places them)."""
    fns = family_fns(arch)
    cfg = arch.model
    params = abstract_params(arch)
    psh = shd.tree_shardings(shd.param_specs(params, mesh), mesh)
    replicated = [Replicate()] * mesh.ndim
    name = f"{arch.arch_id}:{shape.name}"
    split = tpar.model_split(arch.family, cfg, mesh, psh) \
        if shape.kind in ("train", "prefill") else None

    if shape.kind == "train":
        opt_cfg = opt_cfg or OptConfig()
        opt_sh = AdamWState(mu=psh, nu=psh, step=replicated)
        batch = _train_batch_shapes(arch, shape)
        loss_fn = fns["loss"] if split is None else split_loss(arch, split)

        def step(p, opt, b):
            return sharded_train_step(p, opt, b, loss_fn, opt_cfg, mesh,
                                      microbatch, split)

        return Cell(name=name, fn=step,
                    args=(params, adamw_init(params), batch),
                    in_shardings=(psh, opt_sh,
                                  _batch_shardings(batch, mesh, shape.batch)),
                    out_shardings=(psh, opt_sh, None),
                    donate_argnums=(0, 1))

    b = shape.batch
    by_rows = b % shd.data_size(mesh) == 0     # the batch splits over data
    rows_sh = rows_placements(mesh, 0, by_rows)

    def rows(x):
        return rank_rows(x, mesh, 0, by_rows)

    def placed(x, shape_):
        return place_rows(x, mesh, rows_sh, 0, by_rows, shape_)

    def placed_states(new, pls, like):
        """``new`` (this rank's rows of decode states shaped as ``like``,
        global meta or DTensor leaves) placed as ``pls``."""
        return zip_map(lambda x, pl, g: place_rows(
            x, mesh, pl, 1, by_rows and _state_rows(x), g.shape),
            new, pls, like)

    if shape.kind == "prefill":
        if arch.family == "encdec":
            # encoder prefill over the (stub) audio memory
            audio = _meta((b, arch.t_enc, cfg.d_model), cfg.compute_dtype)
            ash = shd.placements(shd.batch_spec(mesh, b, 3), mesh)

            def encode(p, a):
                if not _is_sharded(p):
                    return wh.whisper_encode(p, a, cfg)
                return placed(wh.whisper_encode(_full(p), rows(a), cfg),
                              audio.shape)

            return Cell(name=name, fn=encode, args=(params, audio),
                        in_shardings=(psh, ash), out_shardings=rows_sh)
        if fns["prefill"] is None:
            # ssm / hybrid prefill == a forward pass at that length
            batch = {"tokens": _meta((b, shape.seq), torch.int32)}
            forward = (mb.mamba_forward if arch.family == "ssm"
                       else rg.rg_forward)

            def last_logits(p, bt):
                if not _is_sharded(p):
                    return forward(p, bt["tokens"], cfg)[0][:, -1]
                if split is not None:
                    # hybrid: the forward on this rank's shards, its
                    # classes of the logits where the vocabulary is split
                    out = rg.rg_forward(
                        tree_map(lambda t: t.to_local(), p),
                        rows(bt["tokens"]), split.cfg, tp=split)[0][:, -1]
                    return place_rows(out, mesh, rows_sh, 0, by_rows,
                                      (b, cfg.vocab), _by_vocab(split))
                out = forward(_full(p), rows(bt["tokens"]), cfg)[0][:, -1]
                return placed(out, (b, cfg.vocab))

            return Cell(name=name, fn=last_logits, args=(params, batch),
                        in_shardings=(psh, _batch_shardings(batch, mesh, b)),
                        out_shardings=rows_sh)
        batch = _train_batch_shapes(arch, dataclasses.replace(shape,
                                                              kind="train"))
        batch.pop("labels")
        prefill = fns["prefill"]
        states = fns["init_states"](b, shape.seq, "meta")
        st_sh = shd.tree_shardings(
            shd.state_specs(states, mesh, b, policy=state_policy), mesh)

        def prefill_fn(p, bt):
            if not _is_sharded(p):
                return prefill(p, bt, shape.seq)
            if split is not None:
                return split_prefill(p, bt)
            logits, st = prefill(_full(p), {k: rows(v) for k, v in
                                            bt.items()}, shape.seq)
            return (placed(logits, (b, cfg.vocab)),
                    placed_states(st, st_sh, states))

        def split_prefill(p, bt):
            """The prefill on this rank's shards; its logits (the
            rank's classes where the vocabulary is split) and states (its
            KV heads, dimension 2 of every leaf but the counters)
            assembled into the cell's placements."""
            extra = bt.get("image_embeds")
            logits, st = tfm.lm_prefill(
                tree_map(lambda t: t.to_local(), p), rows(bt["tokens"]),
                split.cfg, shape.seq,
                extra_embeds=None if extra is None else rows(extra),
                tp=split)
            by_vocab = _by_vocab(split)

            def heads(x, pl):
                return split.assemble(x, 2, pl, dup=split.share)

            return (place_rows(logits, mesh, rows_sh, 0, by_rows,
                               (b, cfg.vocab), by_vocab),
                    zip_map(lambda x, pl, g: place_rows(
                        x, mesh, pl, 1, by_rows and _state_rows(x), g.shape,
                        heads if _state_rows(x) else None),
                        st, st_sh, states))

        return Cell(name=name, fn=prefill_fn, args=(params, batch),
                    in_shardings=(psh, _batch_shardings(batch, mesh, b)),
                    out_shardings=(rows_sh, st_sh))

    # ---- decode ----
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
    decode = fns["decode"]

    def decode_fn(p, st, tok, pos):
        if not _is_sharded(p):
            return decode(p, st, tok, pos)
        local = zip_map(lambda x: rank_rows(x, mesh, 1, by_rows
                                            and _state_rows(x)), st)
        pos = pos.to_local() if isinstance(pos, DTensor) else pos
        logits, new = decode(_full(p), local, rows(tok), pos)
        return (placed(logits, (b, logits.shape[-1])),
                placed_states(new, st_sh, st))

    return Cell(name=name, fn=decode_fn,
                args=(params, states, _meta((b,), torch.int32),
                      _meta((), torch.int32)),
                in_shardings=(psh, st_sh, tok_sh, replicated),
                out_shardings=(rows_sh, st_sh), donate_argnums=(1,))
