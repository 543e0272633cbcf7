"""The multi-rank checks of `test_torch_tensor_parallel.py`: the dense
family's train and prefill cells, tensor-parallel over "model"
(`distributed.tensor_parallel`), on ``gloo`` worlds of spawned CPU ranks
(`_torch_dist_checks.spawn`).  Every rank runs the same checks; rank 0
writes what they found to ``<out>/<world>.pt``.  This module imports
torch and the port only (no JAX): the weights come converted from the
reference's init in a file the test process wrote.
"""

from __future__ import annotations

import dataclasses
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
from repro_torch.launch.steps import build_cell, family_fns, train_step
from repro_torch.launch.train import train_batch
from repro_torch.models import modules as nn
from repro_torch.optim import adamw_init
from repro_torch.optim.adamw import AdamWState, tree_leaves

SEQ, BATCH = 64, 4
VOCABS = (251, 256)   # the smoke vocabulary (replicated) and a split one
WORLDS = {"1x2": (1, 2), "2x2": (2, 2), "1x4": (1, 4)}


def smoke_arch(vocab: int):
    arch = get_arch("qwen3-0.6b", smoke=True)
    return dataclasses.replace(arch, model=dataclasses.replace(
        arch.model, vocab=vocab))


def _record(fn, *args):
    """``fn(*args)`` and the collectives it issued (the dry run's counter
    over real tensors): kind, group size, result shape, source line."""
    counts = dr.Counts()
    with dr._Counter(counts):
        out = fn(*args)
    return out, [{k: c[k] for k in ("kind", "group", "shape", "op_name")}
                 for c in counts.collectives]


def check_train(arch, mesh, params) -> dict:
    """Two train-cell steps against `train_step` in one process with one
    microbatch per data rank; the first step's collectives and loss."""
    fns = family_fns(arch)
    cell = build_cell(arch, ShapeSpec("t", "train", SEQ, BATCH), mesh,
                      opt_cfg=chk.OPT)
    psh, osh, _ = cell.in_shardings
    o0 = adamw_init(params)
    p = chk._place(params, mesh, psh)
    o = AdamWState(mu=chk._place(o0.mu, mesh, osh.mu),
                   nu=chk._place(o0.nu, mesh, osh.nu),
                   step=chk._place(o0.step, mesh, osh.step))
    rp, ro = params, o0
    dcfg = DataConfig(vocab=arch.model.vocab, seq_len=SEQ,
                      global_batch=BATCH)
    out = {"loss_rel": 0.0}
    for step in range(chk.STEPS):
        batch = train_batch(arch, dcfg, step)
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
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, arch.model.vocab, (BATCH, SEQ)).astype(np.int32))
    batch = {"tokens": tokens}
    out, coll = _record(cell.fn, cells._place(params, mesh, psh),
                        cells._place(batch, mesh, bsh))
    got = cells._gather(out)
    ref = cell.fn(params, batch)
    return {"placed": cells._placed_as(out, cell.out_shardings),
            "close": cells._close(got, ref), "collectives": coll,
            "tokens": tokens, "logits": got[0], "states": got[1]}


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


def world_tp(rank, name, params_path, out_dir):
    d, m = WORLDS[name]
    mesh = make_host_mesh(d, m, device_type="cpu")
    weights = torch.load(params_path, weights_only=False)
    res = {"nll": check_nll(mesh)}
    for vocab in VOCABS:
        arch = smoke_arch(vocab)
        res[vocab] = {"train": check_train(arch, mesh, weights[vocab]),
                      "prefill": check_prefill(arch, mesh, weights[vocab])}
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, {
        v: {"train": {k: x for k, x in res[v]["train"].items()
                      if k != "collectives"},
            "prefill": {k: res[v]["prefill"][k] for k in
                        ("placed", "close")},
            "nll": res["nll"]} for v in VOCABS})
    if rank == 0:
        res["ranks"] = every
        torch.save(res, os.path.join(out_dir, f"{name}.pt"))


__all__ = ["SEQ", "BATCH", "VOCABS", "WORLDS", "smoke_arch", "world_tp"]
