"""The multi-rank checks of `test_torch_tensor_parallel.py`: the train
and prefill cells of the dense family, the moe family (expert-parallel),
the vlm's LM and the hybrid family, split over "model"
(`distributed.tensor_parallel`), and the MoE layer and the RG-LRU block
alone under the split, on ``gloo`` worlds of spawned CPU ranks (`_torch_dist_checks.spawn`).  Every rank runs the same checks;
rank 0 writes what they found to ``<out>/<world>.pt``.  This module
imports torch and the port only (no JAX): the weights come converted
from the reference's init in a file the test process wrote.
"""

from __future__ import annotations

import dataclasses
import math
import os

import numpy as np
import torch
import torch.distributed as dist
import _torch_cell_checks as cells
import _torch_dist_checks as chk
from repro_torch.configs.registry import ShapeSpec, get_arch
from repro_torch.data import DataConfig
from repro_torch.distributed import tensor_parallel as tpar
from repro_torch.launch import dryrun as dr
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.steps import (build_cell, family_fns, train_step,
                                      zip_map)
from repro_torch.launch.train import train_batch
from repro_torch.models import modules as nn
from repro_torch.models import moe
from repro_torch.optim import adamw_init
from repro_torch.optim.adamw import AdamWState, tree_leaves, tree_map

SEQ, BATCH = 64, 4
VOCABS = (251, 256)   # the smoke vocabulary (replicated) and a split one
WORLDS = {"1x2": (1, 2), "2x2": (2, 2), "1x4": (1, 4)}
# the smoke moe and vlm configs: deepseek-moe-16b (8 experts top-2, one
# shared, 4 KV heads), dbrx-132b (no shared expert, 2 KV heads: the
# KV-group rule and the expert split together at 1 x 4) and internvl2-76b
# (16 image-embedding rows)
EP_ARCHS = ("deepseek-moe-16b", "dbrx-132b", "internvl2-76b")
# the smoke recurrentgemma-9b (2 super-blocks, d 128, 4 heads, MQA: the
# KV-group rule runs with r = M) at its vocabulary 251 (replicated) and
# at 256 (split over "model")
HY_CASES = ("recurrentgemma-9b", "recurrentgemma-9b:256")


def smoke_arch(vocab: int):
    arch = get_arch("qwen3-0.6b", smoke=True)
    return dataclasses.replace(arch, model=dataclasses.replace(
        arch.model, vocab=vocab))


def case_arch(case):
    """The smoke config of a case: a vocabulary of the smoke qwen3, an
    arch id, or ``"<arch id>:<vocabulary>"``."""
    if isinstance(case, int):
        return smoke_arch(case)
    arch_id, _, vocab = case.partition(":")
    arch = get_arch(arch_id, smoke=True)
    if vocab:
        arch = dataclasses.replace(arch, model=dataclasses.replace(
            arch.model, vocab=int(vocab)))
    return arch


def _record(fn, *args):
    """``fn(*args)`` and the collectives it issued (the dry run's counter
    over real tensors): kind, group size, result shape, source line."""
    counts = dr.Counts()
    with dr._Counter(counts):
        out = fn(*args)
    return out, [{k: c[k] for k in ("kind", "group", "shape", "op_name")}
                 for c in counts.collectives]


def batch_at(arch, step: int) -> dict:
    """The train batch at ``step``: `train_batch`'s, with normal image
    embeddings from ``default_rng(100 + step)`` for a vlm (the training CLI's
    are zeros)."""
    batch = train_batch(arch, DataConfig(vocab=arch.model.vocab,
                                         seq_len=SEQ, global_batch=BATCH),
                        step)
    if arch.family == "vlm":
        batch["image_embeds"] = np.random.default_rng(100 + step) \
            .standard_normal(batch["image_embeds"].shape).astype(np.float32)
    return batch


def prefill_batch(arch) -> dict:
    """The prefill cell's batch: tokens from ``default_rng(1)``, and for a
    vlm normal image embeddings from ``default_rng(2)``."""
    batch = {"tokens": torch.from_numpy(np.random.default_rng(1).integers(
        0, arch.model.vocab, (BATCH, SEQ)).astype(np.int32))}
    if arch.family == "vlm":
        batch["image_embeds"] = torch.from_numpy(
            np.random.default_rng(2).standard_normal(
                (BATCH, arch.n_img_tokens, arch.model.d_model))
            .astype(np.float32))
    return batch


def join_shares(parts: list):
    """Prefill outputs (last logits, decode states) of consecutive data
    shares as one batch's: logits joined on rows, state leaves on their
    batch dimension 1 (the counters, of rank < 3, are the same)."""
    return (torch.cat([p[0] for p in parts]),
            zip_map(lambda *xs: torch.cat(xs, dim=1) if xs[0].dim() >= 3
                    else xs[0], *[p[1] for p in parts]))


def _experts_local(p) -> dict:
    """The expert count of this rank's shard of each stacked expert leaf."""
    moe_p = p.get("blocks", {}).get("moe")
    return {} if moe_p is None else {
        k: tuple(v.to_local().shape)[1] for k, v in moe_p.items()
        if k in ("wi", "wg", "wo")}


def check_train(arch, mesh, params) -> dict:
    """Two train-cell steps against `train_step` in one process with one
    microbatch per data rank; the first step's collectives and loss."""
    fns = family_fns(arch)
    cell = build_cell(arch, ShapeSpec("t", "train", SEQ, BATCH), mesh,
                      opt_cfg=chk.OPT)
    psh, osh, _ = cell.in_shardings
    o0 = adamw_init(params)
    # both steps update their inputs in place, and a placed leaf may
    # share its storage with the tensor it was placed from: the cell and
    # the reference each get a copy (the prefill check reuses ``params``)
    p = chk._place(chk.clone(params), mesh, psh)
    o = AdamWState(mu=chk._place(o0.mu, mesh, osh.mu),
                   nu=chk._place(o0.nu, mesh, osh.nu),
                   step=chk._place(o0.step, mesh, osh.step))
    rp, ro = chk.clone(params), chk.clone(o0)
    out = {"loss_rel": 0.0, "experts_local": _experts_local(p)}
    for step in range(chk.STEPS):
        batch = batch_at(arch, step)
        if step == 0:
            (p, o, met), out["collectives"] = _record(cell.fn, p, o, batch)
            out["loss0"] = float(met["loss"])
        else:
            p, o, met = cell.fn(p, o, batch)
        rp, ro, rmet = train_step(rp, ro, batch, fns["loss"], chk.OPT,
                                  microbatch=mesh.size(0))
        out["loss_rel"] = max(out["loss_rel"], chk._rel(
            met["loss"].reshape(1), rmet["loss"].reshape(1)))
        if step == 0:
            out["grad_rel"] = max(chk._rel(a, b) for a, b in
                                  zip(chk._full(o.mu), tree_leaves(ro.mu)))
    out["param_abs"] = max(float((a - b).abs().max()) for a, b in
                           zip(chk._full(p), tree_leaves(rp)))
    out["shard_shapes_bad"] = chk._shard_shapes_bad(p, mesh)
    return out


def check_prefill(arch, mesh, params) -> dict:
    """The prefill cell against the plain function on the whole batch
    (float leaves within 1e-5 of each leaf's max, integer leaves exact),
    placed as its ``out_shardings``; its collectives and gathered
    output."""
    cell = build_cell(arch, ShapeSpec("p", "prefill", SEQ, BATCH), mesh)
    psh, bsh = cell.in_shardings
    batch = prefill_batch(arch)
    out, coll = _record(cell.fn, cells._place(params, mesh, psh),
                        cells._place(batch, mesh, bsh))
    got = cells._gather(out)
    ref = cell.fn(params, batch)
    d = mesh.size(0)
    if arch.model.n_experts and d > 1:
        # the MoE's capacity groups are a call's, and each data rank's
        # rows are one call: the plain function on each share, joined
        ref = join_shares([cell.fn(params, {k: v.chunk(d)[i] for k, v in
                                           batch.items()})
                           for i in range(d)])
    logits, states = got if isinstance(got, tuple) else (got, None)
    return {"placed": cells._placed_as(out, cell.out_shardings),
            "close": cells._close(got, ref), "collectives": coll,
            "tokens": batch["tokens"], "logits": logits, "states": states}


def check_nll(mesh) -> dict:
    """The vocabulary-parallel cross-entropy on its own against
    `cross_entropy` over the whole vocabulary: a batch whose labels fall
    in every rank's classes, plain and masked; the loss and its gradient
    with respect to the rank's logits."""
    m = mesh.size(1)
    vocab, me = 256, mesh.get_coordinate()[1]
    n = vocab // m
    split = tpar.ModelSplit(cfg=None, group=mesh.get_group("model"),
                            size=m, index=me, vocab=(me * n, n))
    rng = np.random.default_rng(7)
    logits = torch.from_numpy(rng.standard_normal((4, 16, vocab))
                              .astype(np.float32) * 3)
    labels = torch.from_numpy(np.arange(64).reshape(4, 16) * 4 % vocab)
    mask = torch.from_numpy((rng.random((4, 16)) > 0.3).astype(np.float32))
    res = {"ranges_hit": sorted({int(x) // n for x in labels.flatten()})}
    for name, mk in (("plain", None), ("masked", mask)):
        whole = logits.clone().requires_grad_()
        want = nn.cross_entropy(whole, labels, mk)
        (dw,) = torch.autograd.grad(want, whole)
        mine = logits[..., me * n:(me + 1) * n].clone().requires_grad_()
        got = nn.cross_entropy(mine, labels, mk, tp=split)
        (dm,) = torch.autograd.grad(got, mine)
        res[name] = {"loss_rel": chk._rel(got.reshape(1), want.reshape(1)),
                     "grad_rel": chk._rel(dm, dw[..., me * n:(me + 1) * n])}
    return res


def check_moe_layer(mesh) -> dict:
    """`moe_apply` under the split on this rank (its experts' shards, its
    columns / rows of the shared expert) against the whole layer on the
    same input, the smoke deepseek-moe-16b layer at capacity factor 0.5,
    so that queues overflow and drop.  Two losses, ``out.sum()`` and the aux
    loss alone: the output and aux values, and the gradients of the
    input, the router (summed over "model", as the train cell sums it),
    the rank's expert shards and its shared-expert shards, each relative
    to the whole layer's largest magnitude."""
    m, me = mesh.size(1), mesh.get_coordinate()[1]
    cfg = dataclasses.replace(get_arch("deepseek-moe-16b", smoke=True).model,
                              moe_capacity_factor=0.5)
    el = cfg.n_experts // m
    fs = cfg.n_shared_experts * cfg.d_ff // m
    params = moe.moe_init(torch.Generator().manual_seed(3), cfg, "cpu")
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (2, 256, cfg.d_model)).astype(np.float32))
    split = tpar.ModelSplit(cfg=cfg, group=mesh.get_group("model"), size=m,
                            index=me, experts=(me * el, el))
    ex, cols = slice(me * el, (me + 1) * el), slice(me * fs, (me + 1) * fs)

    def mine(tree):
        sh = tree["shared"]
        return {"router": tree["router"], "wi": tree["wi"][ex],
                "wg": tree["wg"][ex], "wo": tree["wo"][ex],
                "shared": {"wi": sh["wi"][:, cols], "wg": sh["wg"][:, cols],
                           "wo": sh["wo"][cols]}}

    def leaves(tree):
        return [tree["router"], tree["wi"], tree["wg"], tree["wo"],
                tree["shared"]["wi"], tree["shared"]["wg"],
                tree["shared"]["wo"]]

    g = math.gcd(x.shape[0] * x.shape[1], moe.MOE_GROUPS)
    r = moe.route(params, x.reshape(g, -1, cfg.d_model), cfg)
    res = {"dropped": int((r.slot >= r.cap).sum())}
    names = ("x", "router", "wi", "wg", "wo", "shared/wi", "shared/wg",
             "shared/wo")
    for loss_name in ("out", "aux"):
        whole = tree_map(lambda t: t.clone().requires_grad_(), params)
        xw = x.clone().requires_grad_()
        ow, aw = moe.moe_apply(whole, xw, cfg)
        lw = ow.sum() if loss_name == "out" else aw
        gw = torch.autograd.grad(lw, [xw] + leaves(whole),
                                 materialize_grads=True)
        loc = tree_map(lambda t: t.clone().requires_grad_(), mine(params))
        xl = x.clone().requires_grad_()
        ol, al = moe.moe_apply(loc, xl, cfg, tp=split)
        ll = ol.sum() if loss_name == "out" else al
        gl = list(torch.autograd.grad(ll, [xl] + leaves(loc),
                                       materialize_grads=True))
        gl[1] = split.sum(gl[1])              # the router, over "model"
        want = [gw[0], gw[1], gw[2][ex], gw[3][ex], gw[4][ex],
                gw[5][:, cols], gw[6][:, cols], gw[7][cols]]
        res[loss_name] = {
            "out_rel": chk._rel(ol.detach(), ow.detach()),
            "aux_rel": chk._rel(al.detach().reshape(1),
                                aw.detach().reshape(1)),
            "grad_rel": {n: chk._rel(a, b) for n, a, b in
                         zip(names, gl, want)}}
    return res


def check_rglru_block(mesh) -> dict:
    """`rglru.rglru_block_apply` under the split on this rank (its
    channels of the recurrent width) against the whole block on the same
    input: the smoke recurrentgemma-9b block with random gate biases and
    decays, ``(out * w).sum()`` for random ``w``.  The output, and the
    gradients of the input and of every leaf (the rank's slice of a split
    one, all of ``ln``), each relative to the whole block's largest
    magnitude."""
    from repro_torch.models import rglru
    m, me = mesh.size(1), mesh.get_coordinate()[1]
    cfg = get_arch("recurrentgemma-9b", smoke=True).model
    dr = cfg.d_model
    gen = torch.Generator().manual_seed(4)
    params = rglru.rglru_block_init(gen, cfg, "cpu")
    for k in ("ln", "b_a", "b_x", "lam"):
        params[k] = torch.randn(params[k].shape, generator=gen) * 0.5
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.standard_normal((2, 32, dr))
                         .astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((2, 32, dr))
                         .astype(np.float32))
    split = tpar.ModelSplit(cfg=cfg, group=mesh.get_group("model"), size=m,
                            index=me)
    ch = slice(me * dr // m, (me + 1) * dr // m)
    cols = ("w_in", "w_gate", "w_a", "w_x", "conv")
    rows = ("w_out",)
    vecs = ("b_a", "b_x", "lam")

    def mine(k, t):
        if k in cols:
            return t[:, ch]
        if k in rows or k in vecs:
            return t[ch]
        return t

    names = ["x"] + sorted(params)
    whole = {k: v.clone().requires_grad_() for k, v in params.items()}
    xw = x.clone().requires_grad_()
    ow = rglru.rglru_block_apply(whole, xw, cfg)
    gw = torch.autograd.grad((ow * w).sum(),
                             [xw] + [whole[k] for k in names[1:]])
    loc = {k: mine(k, v).clone().requires_grad_() for k, v in params.items()}
    xl = x.clone().requires_grad_()
    ol = rglru.rglru_block_apply(loc, xl, cfg, tp=split)
    gl = torch.autograd.grad((ol * w).sum(),
                             [xl] + [loc[k] for k in names[1:]])
    return {"out_rel": chk._rel(ol.detach(), ow.detach()),
            "grad_rel": {n: chk._rel(a, b if n == "x" else mine(n, b))
                         for n, a, b in zip(names, gl, gw)}}


def world_tp(rank, name, params_path, out_dir):
    d, m = WORLDS[name]
    mesh = make_host_mesh(d, m, device_type="cpu")
    weights = torch.load(params_path, weights_only=False)
    res = {"nll": check_nll(mesh), "moe_layer": check_moe_layer(mesh),
           "rglru_block": check_rglru_block(mesh)}
    for vocab in VOCABS:
        arch = smoke_arch(vocab)
        res[vocab] = {"train": check_train(arch, mesh, weights[vocab]),
                      "prefill": check_prefill(arch, mesh, weights[vocab])}
    for case in EP_ARCHS + HY_CASES:
        arch = case_arch(case)
        res[case] = {"train": check_train(arch, mesh, weights[case]),
                     "prefill": check_prefill(arch, mesh, weights[case])}
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, {
        v: {"train": {k: x for k, x in res[v]["train"].items()
                      if k != "collectives"},
            "prefill": {k: res[v]["prefill"][k] for k in
                        ("placed", "close")},
            "nll": res["nll"], "moe_layer": res["moe_layer"],
            "rglru_block": res["rglru_block"]}
        for v in VOCABS + EP_ARCHS + HY_CASES})
    if rank == 0:
        res["ranks"] = every
        torch.save(res, os.path.join(out_dir, f"{name}.pt"))


__all__ = ["SEQ", "BATCH", "VOCABS", "WORLDS", "EP_ARCHS", "HY_CASES",
           "smoke_arch", "case_arch", "batch_at", "prefill_batch",
           "join_shares", "world_tp"]
