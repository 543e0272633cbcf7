"""The multi-rank checks of `test_torch_distributed.py`: one function a
world, run in every rank of a ``gloo`` group of spawned CPU processes.
This module imports torch and the port only (no JAX), so spawning a rank
stays cheap.  Rank 0 writes what the checks found to ``<out>/<world>.pt``
(a dict); the test process asserts on it.
"""

from __future__ import annotations

import math
import os
import socket

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.checkpoint import CheckpointManager
from repro_torch.checkpoint import manager as ckpt_manager
from repro_torch.configs.registry import ShapeSpec, get_arch
from repro_torch.data import DataConfig
from repro_torch.distributed import elastic_retarget
from repro_torch.distributed import sharding as shd
from repro_torch.distributed import tensor_parallel as tpar
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch import steps
from repro_torch.launch.steps import (build_cell, family_fns, train_step,
                                      zip_map)
from repro_torch.launch.train import train_batch
from repro_torch.models.modules import AttnConfig, ModelConfig
from repro_torch.models.transformer import lm_init, lm_loss
from repro_torch.optim import OptConfig, adamw_init, adamw_update
from repro_torch.optim import compression as comp
from repro_torch.optim.adamw import AdamWState, tree_leaves, tree_map
from repro_torch.optim.grads import accumulate_grads

ARCHS = ("qwen3-0.6b", "deepseek-moe-16b", "mamba2-370m",
         "recurrentgemma-9b")
OPT = OptConfig(lr=1e-3, warmup_steps=2, total_steps=10)
SEQ, BATCH, STEPS = 64, 4, 2
CKPT_STEP = 2
# per-rank gradients of the compressed reduction: an odd size (padding)
GRAD_SHAPES = {"w": (37, 16), "b": (259,)}


def spawn(fn, world: int, *args) -> None:
    """Run ``fn(rank, world, port, *args)`` in ``world`` spawned ranks."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    mp.start_processes(_enter, args=(world, port, fn, args), nprocs=world,
                       start_method="spawn")


def _enter(rank, world, port, fn, args):
    torch.set_num_threads(1)
    os.environ.pop("WORLD_SIZE", None)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)
    try:
        fn(rank, *args)
    finally:
        dist.destroy_process_group()


def clone(tree):
    """A copy of a tree of tensors (dicts, an `AdamWState`) for a caller
    that reads it after a train step, which donates its inputs."""
    return zip_map(torch.clone, tree)


def _place(tree, mesh, shardings):
    from torch.distributed.tensor import distribute_tensor
    return tree_map(lambda t, pl: distribute_tensor(t, mesh, pl,
                                                    src_data_rank=None),
                    tree, shardings)


def _full(tree):
    return [x.full_tensor() for x in tree_leaves(tree)]


def _rel(a, b) -> float:
    return float((a.double() - b.double()).abs().max()
                 / b.double().abs().max().clamp_min(1e-30))


def _shard_shapes_bad(tree, mesh) -> list:
    """Leaves whose local shape on this rank is not their ``param_specs``
    shard: (path, local shape, expected shape)."""
    sizes = shd.axis_sizes(mesh)
    bad = []

    def check(path, x):
        spec = shd.spec_for_param(path, x.dim(), tuple(x.shape),
                                  sizes.get("model", 1))
        want = tuple(n // math.prod(sizes[a] for a in
                                    (ax if isinstance(ax, tuple) else (ax,))
                                    if a is not None)
                     for n, ax in zip(x.shape, spec))
        if tuple(x.to_local().shape) != want:
            bad.append((path, tuple(x.to_local().shape), want))

    shd.map_with_path(check, tree)
    return bad


def sharded_vs_single(arch_id, mesh, microbatch=1, mask=False) -> dict:
    """Two sharded train steps on ``mesh`` against `train_step` in one
    process with (data ranks x ``microbatch``) microbatches (one, for a
    masked batch: the masked mean of the whole batch).  Every rank runs
    the reference too (it is cheap at the smoke size); rank 0 reports."""
    arch = get_arch(arch_id, smoke=True)
    fns = family_fns(arch)
    p0 = fns["init"](torch.Generator().manual_seed(0), "cpu")
    cell = build_cell(arch, ShapeSpec("t", "train", SEQ, BATCH), mesh,
                      opt_cfg=OPT, microbatch=microbatch)
    psh, osh, _ = cell.in_shardings
    o0 = adamw_init(p0)
    p = _place(p0, mesh, psh)
    o = AdamWState(mu=_place(o0.mu, mesh, osh.mu),
                   nu=_place(o0.nu, mesh, osh.nu),
                   step=_place(o0.step, mesh, osh.step))
    ref_mb = 1 if mask else shd.data_size(mesh) * microbatch
    # the steps update in place, and a placed leaf may share its storage
    # with the tree it was placed from
    rp, ro = clone(p0), clone(o0)
    dcfg = DataConfig(vocab=arch.model.vocab, seq_len=SEQ, global_batch=BATCH)
    out = {"loss_rel": 0.0, "grad_rel": 0.0, "param_rel": 0.0,
           "shard_shapes_bad": _shard_shapes_bad(p, mesh)}
    for step in range(STEPS):
        batch = train_batch(arch, dcfg, step)
        if mask:
            m = np.ones_like(batch["labels"], dtype=np.float32)
            m[: BATCH // 2, SEQ // 3:] = 0.0     # ranks count differently
            batch["loss_mask"] = m
        p, o, met = cell.fn(p, o, batch)
        rp, ro, rmet = train_step(rp, ro, batch, fns["loss"], OPT,
                                  microbatch=ref_mb)
        out["loss_rel"] = max(out["loss_rel"],
                              _rel(met["loss"].reshape(1),
                                   rmet["loss"].reshape(1)))
        if step == 0:
            # mu after one step from zero: (1 - b1) x the clipped gradient
            out["grad_rel"] = max(_rel(a, b) for a, b in
                                  zip(_full(o.mu), tree_leaves(ro.mu)))
    out["param_rel"] = max(_rel(a, b) for a, b in
                           zip(_full(p), tree_leaves(rp)))
    out["param_abs"] = max(float((a - b).abs().max()) for a, b in
                           zip(_full(p), tree_leaves(rp)))
    out["params_bit_equal"] = all(torch.equal(a, b) for a, b in
                                  zip(_full(p), tree_leaves(rp)))
    out["p"], out["o"] = p, o
    return out


def _report(rank, out_dir, world_name, res, bad_shapes):
    gathered = [None] * dist.get_world_size()
    dist.all_gather_object(gathered, bad_shapes)
    if rank == 0:
        res["shard_shapes_bad"] = gathered
        torch.save(res, os.path.join(out_dir, f"{world_name}.pt"))


def _strip(res):
    return {k: {kk: vv for kk, vv in v.items() if kk not in ("p", "o")}
            for k, v in res.items()}


# ------------------------------------------------------------------ 2 x 2 --

def _grads_of(rank):
    rng = np.random.default_rng(100 + rank)
    return {k: torch.from_numpy(rng.standard_normal(s).astype(np.float32)
                                * (rank + 1)) for k, s in GRAD_SHAPES.items()}


def _err_of(rank):
    rng = np.random.default_rng(200 + rank)
    return {k: torch.from_numpy((rng.standard_normal(s) * 1e-3)
                                .astype(np.float32))
            for k, s in GRAD_SHAPES.items()}


def world_2x2(rank, out_dir):
    mesh = make_host_mesh(2, 2, device_type="cpu")
    res = {a: sharded_vs_single(a, mesh, microbatch=1) for a in ARCHS}
    bad = {a: r["shard_shapes_bad"] for a, r in res.items()}
    p, o = res["qwen3-0.6b"]["p"], res["qwen3-0.6b"]["o"]
    full = _full(p)

    # elastic re-placement: 2 x 2 -> 1 x 2 (ranks 0 and 1) -> one process
    sub = DeviceMesh("cpu", torch.tensor([[0, 1]]),
                     mesh_dim_names=("data", "model"))
    retarget = {}
    q = elastic_retarget(p, sub)
    if sub.get_coordinate() is not None:
        sub_shapes = _shard_shapes_bad(q, sub)
        back = _full(q)            # the single-process values
        retarget = {"bit_equal": all(torch.equal(a, b)
                                     for a, b in zip(back, full)),
                    "shard_shapes_bad": sub_shapes,
                    "any_sharded": any(x.to_local().shape != x.shape
                                       for x in tree_leaves(q))}
    # a checkpoint written on 2 x 2 (every rank gathers, rank 0 copies
    # to host memory and writes): count the host copies each rank makes
    ck = CheckpointManager(os.path.join(out_dir, "ckpt"))
    copies = []
    real_copy = ckpt_manager._host_copy

    def host_copy(leaf):
        copies.append(tuple(leaf.shape))
        return real_copy(leaf)

    ckpt_manager._host_copy = host_copy
    try:
        ck.save(CKPT_STEP, (p, o))
    finally:
        ckpt_manager._host_copy = real_copy
    writer_thread = ck._pending is not None
    ck.wait()
    saved = {"host_copies": len(copies),
             "leaves": len(list(ckpt_manager._leaves_with_path((p, o)))),
             "writer_thread": writer_thread}

    # the compressed reduction on 4 ranks, payloads recorded
    wire = []
    real_a2a = dist.all_to_all_single
    real_ag = dist.all_gather_into_tensor

    def a2a(out, inp, *a, **k):
        wire.append(("all_to_all_single", inp.dtype, inp.numel()))
        if inp.dtype == torch.int8:
            payload.append(inp.clone())
        return real_a2a(out, inp, *a, **k)

    def ag(out, inp, *a, **k):
        wire.append(("all_gather_into_tensor", inp.dtype, inp.numel()))
        if inp.dtype == torch.int8:
            payload.append(inp.clone())
        return real_ag(out, inp, *a, **k)

    payload: list = []
    dist.all_to_all_single, dist.all_gather_into_tensor = a2a, ag
    try:
        reduced, new_err = comp.compressed_grad_mean(_grads_of(rank), None,
                                                     _err_of(rank))
    finally:
        dist.all_to_all_single, dist.all_gather_into_tensor = real_a2a, real_ag
    mine = {"reduced": reduced, "err": new_err, "payload": payload,
            "wire": wire, "retarget": retarget, "saved": saved}
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, mine)
    out = {"train": _strip(res), "ranks": every, "params_full": full}
    _report(rank, out_dir, "2x2", out, bad)


# ------------------------------------------------------------------ 1 x 2 --

def world_1x2(rank, out_dir):
    mesh = make_host_mesh(1, 2, device_type="cpu")
    res = {a: sharded_vs_single(a, mesh) for a in ARCHS}
    bad = {a: r["shard_shapes_bad"] for a, r in res.items()}
    # restore the 2 x 2 checkpoint onto this mesh
    p, o = res["qwen3-0.6b"]["p"], res["qwen3-0.6b"]["o"]
    step, (rp, ro) = CheckpointManager(os.path.join(out_dir, "ckpt")) \
        .restore((p, o))
    restored = {"step": step, "params_full": _full(rp),
                "mu_full": _full(ro.mu), "opt_step": int(ro.step.full_tensor()),
                "shard_shapes_bad": _shard_shapes_bad(rp, mesh)}
    _report(rank, out_dir, "1x2", {"train": _strip(res),
                                   "restored": restored}, bad)


# ------------------------------------------------------------------ 2 x 1 --

def world_2x1(rank, out_dir):
    mesh = make_host_mesh(2, 1, device_type="cpu")
    res = {a: sharded_vs_single(a, mesh) for a in ARCHS}
    res["qwen3-0.6b microbatch 2"] = sharded_vs_single("qwen3-0.6b", mesh,
                                                       microbatch=2)
    res["qwen3-0.6b masked"] = sharded_vs_single("qwen3-0.6b", mesh,
                                                 mask=True)
    bad = {a: r["shard_shapes_bad"] for a, r in res.items()}

    # dp_compressed_train_step: 20 steps on the 2 data ranks
    cfg = ModelConfig(n_layers=2, d_model=64, n_heads=4, n_kv=2, d_ff=128,
                      vocab=128, attn=AttnConfig(window=16, k=16))
    ocfg = OptConfig(lr=2e-3, warmup_steps=2, total_steps=20)
    params = lm_init(torch.Generator().manual_seed(0), cfg, "cpu")
    opt = adamw_init(params)
    err = comp.init_error_feedback(params)
    step = comp.dp_compressed_train_step(
        lambda p, b: lm_loss(p, b, cfg),
        lambda g, o, p: adamw_update(g, o, p, ocfg), mesh)
    from repro_torch.data import synthetic_batch
    data = DataConfig(vocab=128, seq_len=64, global_batch=8)
    losses = []
    for i in range(20):
        b = synthetic_batch(data, i)
        params, opt, err, m = step(params, opt, err,
                                   {k: b[k] for k in ("tokens", "labels")})
        losses.append(float(m["loss"]))
    same = [None] * dist.get_world_size()
    dist.all_gather_object(same, [x.sum().item() for x in
                                  tree_leaves(params)])
    _report(rank, out_dir, "2x1", {"train": _strip(res),
                                   "dp_losses": losses,
                                   "dp_params_agree": same[0] == same[1]},
            bad)


# ------------------------------------------------- in place vs functional --

IN_PLACE_ARCHS = ("qwen3-0.6b", "mamba2-370m", "recurrentgemma-9b")


def functional_sharded_step(params, opt, batch, loss_fn, cfg, mesh,
                            split=None):
    """`steps.sharded_train_step` in its functional form (as it was before
    it updated in place): every gradient placed as a whole tree, then
    `adamw_update` on the DTensors, new trees returned."""
    local = steps.data_rows(batch, mesh)
    if split is None:
        loss, grads = accumulate_grads(steps._full(params), local, loss_fn)
    else:
        loss, grads = accumulate_grads(
            tree_map(lambda t: t.to_local(), params), local, loss_fn)
    dp = torch.tensor(float(shd.data_size(mesh)), dtype=torch.float32)
    if "loss_mask" in local:
        count = torch.as_tensor(local["loss_mask"]).float().sum()
        total = steps._per_data_rank(count, mesh).full_tensor()
        w = count * dp / torch.clamp(total, min=1.0)
        loss = loss * w
        grads = tree_map(lambda g: g * w, grads)
    if split is None:
        grads = tree_map(lambda g, p: steps._per_data_rank(g, mesh)
                         .redistribute(mesh, p.placements) / dp, grads,
                         params)
    else:
        grads = tree_map(lambda g, p, s: steps._split_grad(
            g, p, mesh, split, s).redistribute(mesh, p.placements) / dp,
            grads, params, split.sum_over_model)
    new_p, new_o, met = adamw_update(grads, opt, params, cfg)
    met = {k: v.full_tensor() for k, v in met.items()}
    met["loss"] = steps._per_data_rank(loss, mesh).full_tensor() / dp
    return new_p, new_o, met


def in_place_vs_functional(arch_id, mesh) -> dict:
    """Two train-cell steps (the second on a masked batch) against
    `functional_sharded_step` on clones of the same placed inputs: every
    local shard of the parameters and moments, the step and the metrics
    bit-equal, and the cell's outputs the tensors it was given."""
    arch = get_arch(arch_id, smoke=True)
    fns = family_fns(arch)
    p0 = fns["init"](torch.Generator().manual_seed(0), "cpu")
    cell = build_cell(arch, ShapeSpec("t", "train", SEQ, BATCH), mesh,
                      opt_cfg=OPT)
    psh, osh, _ = cell.in_shardings
    split = tpar.model_split(arch.family, arch.model, mesh, psh)
    loss_fn = steps.split_loss(arch, split) if split else fns["loss"]
    o0 = adamw_init(p0)
    p = _place(clone(p0), mesh, psh)
    o = AdamWState(mu=_place(o0.mu, mesh, osh.mu),
                   nu=_place(o0.nu, mesh, osh.nu),
                   step=_place(o0.step, mesh, osh.step))
    rp, ro = clone(p), clone(o)
    ptrs = [x.to_local().data_ptr() for x in tree_leaves({"p": p, "mu": o.mu, "nu": o.nu})]
    dcfg = DataConfig(vocab=arch.model.vocab, seq_len=SEQ, global_batch=BATCH)
    same_met = True
    for step in range(STEPS):
        batch = train_batch(arch, dcfg, step)
        if step == 1:
            m = np.ones_like(batch["labels"], dtype=np.float32)
            m[: BATCH // 2, SEQ // 3:] = 0.0
            batch["loss_mask"] = m
        p, o, met = cell.fn(p, o, batch)
        rp, ro, rmet = functional_sharded_step(rp, ro, batch, loss_fn, OPT,
                                               mesh, split)
        same_met &= all(torch.equal(met[k], rmet[k]) for k in rmet)

    def equal(a, b):
        return all(torch.equal(x.to_local(), y.to_local())
                   for x, y in zip(tree_leaves(a), tree_leaves(b)))

    return {"params": equal(p, rp), "mu": equal(o.mu, ro.mu),
            "nu": equal(o.nu, ro.nu), "step": equal(o.step, ro.step),
            "metrics": same_met,
            "in_place": [x.to_local().data_ptr() for x in
                         tree_leaves({"p": p, "mu": o.mu, "nu": o.nu})] == ptrs}


def world_in_place(rank, d, m, out_dir):
    mesh = make_host_mesh(d, m, device_type="cpu")
    res = {a: in_place_vs_functional(a, mesh) for a in IN_PLACE_ARCHS}
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, res)
    if rank == 0:
        torch.save(every, os.path.join(out_dir, f"inplace_{d}x{m}.pt"))
