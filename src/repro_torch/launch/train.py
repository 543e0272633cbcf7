"""Training driver: data pipeline -> train step -> checkpoints (port of
``repro.launch.train``).

Same flags, defaults, schedule, batches and log line as the reference,
plus ``--device`` (``cuda`` unless asked otherwise) and ``--n-layers``.
``--simulate-failure N`` raises at step N to exercise restart-from-
checkpoint (``--resume``).

The run goes through a D x M mesh over the process group, D and M from
``--data-parallel`` / ``--model-parallel`` (1 and 1 by default, as in the
reference) or ``--production-mesh`` (16 x 16): `launch.steps.
build_cell`'s train cell, parameters and AdamW moments held as DTensors
sharded by ``param_specs``, each rank stepping on its data share of the
batch (`launch.steps.sharded_train_step`).  Started by ``torchrun`` it
joins the group that ``RANK`` / ``WORLD_SIZE`` / ``LOCAL_RANK`` describe
(``nccl`` on cuda, one card a rank; ``gloo`` on the CPU); started alone
it makes its own one-rank group; a world of another size than D x M
raises.  Only rank 0 logs and writes checkpoints (every rank gathers
them).  The group it made is taken down when it returns or raises.

  PYTHONPATH=src python -m torch.distributed.run --nproc-per-node 2 \
      -m repro_torch.launch.train --smoke --device cpu \
      --data-parallel 1 --model-parallel 2 --steps 3 --batch 4 --seq 64

The driver is deterministic: it turns on
``torch.use_deterministic_algorithms`` (the backward of an embedding,
cross-entropy or top-k gather would otherwise add with float atomics, on
the card and, for the embedding, on the CPU too) and, before it first
touches the card, sets ``CUBLAS_WORKSPACE_CONFIG=:4096:8``, so a resumed
run replays an uninterrupted one bit for bit.  It does so itself (see
`deterministic`), not at package import: serving keeps its own settings.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \\
      --smoke --device cpu --steps 50 --batch 8 --seq 256 --ckpt-dir ck

After the log rank 0 prints one line ``summary {json}``: the mesh's
shape, every step's loss,
lr, grad norm and seconds, tokens per step, the seconds spent drawing
the parameters, restoring, in `CheckpointManager.save` (the copy to host
memory, and waiting for the previous write), waiting for the last write
and in all of the run after parsing its flags, on the card the peak of
``torch.cuda.max_memory_allocated``, and the port's kernel launch counts
(training runs none of them).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import distribute_tensor

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs.registry import ArchConfig, ShapeSpec, get_arch
from repro_torch.data import DataConfig, synthetic_batch
from repro_torch.device import resolve_device
from repro_torch.distributed.fault_tolerance import StepTimer
from repro_torch.kernels import ops
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
from repro_torch.launch.steps import build_cell, family_fns
from repro_torch.optim import OptConfig, adamw_init
from repro_torch.optim.adamw import AdamWState, tree_map

CUBLAS_WORKSPACE = ":4096:8"


@contextlib.contextmanager
def deterministic(device: torch.device):
    """Deterministic algorithms (restored on exit) and, on CUDA, the cuBLAS
    workspace setting (kept in the environment; it counts only if set
    before cuBLAS starts in the process).  The CPU needs them too: without
    them the embedding's backward adds with parallel float atomics there
    as well (``index_put_`` with ``accumulate``)."""
    if device.type == "cuda":
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", CUBLAS_WORKSPACE)
    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(prev)


def train_batch(arch: ArchConfig, dcfg: DataConfig, step: int) -> dict:
    """The driver's batch at ``step`` (numpy): tokens and labels; zero
    image embeddings for a vlm; for the encdec family normal audio frames
    from ``default_rng(step)`` and the first ``dec_len`` tokens."""
    cfg = arch.model
    host = synthetic_batch(dcfg, step)
    batch = {"tokens": host["tokens"], "labels": host["labels"]}
    b = dcfg.global_batch
    if arch.family == "vlm":
        batch["image_embeds"] = np.zeros((b, arch.n_img_tokens, cfg.d_model),
                                         np.float32)
    if arch.family == "encdec":
        batch = {
            "audio_embeds": np.random.default_rng(step).standard_normal(
                (b, arch.t_enc, cfg.d_model)).astype(np.float32),
            "tokens": host["tokens"][:, : arch.dec_len],
            "labels": host["labels"][:, : arch.dec_len],
        }
    return batch


def schedule(steps: int, lr: float) -> OptConfig:
    """The optimizer of a ``steps``-step run: the reference's warmup and
    cosine length for it."""
    return OptConfig(lr=lr, total_steps=max(steps, 10),
                     warmup_steps=max(2, steps // 20))


@contextlib.contextmanager
def _clock(secs: dict, key: str):
    """Adds the seconds spent in the block to ``secs[key]``."""
    t0 = time.perf_counter()
    yield
    secs[key] += time.perf_counter() - t0


def _train(args, arch: ArchConfig, mesh, device: torch.device,
           secs: dict):
    """The run on ``mesh``: (first step, log of every step, tokens a
    step)."""
    fns = family_fns(arch)
    opt_cfg = schedule(args.steps, args.lr)
    rank0 = dist.get_rank() == 0
    with _clock(secs, "init"):
        gen = torch.Generator(device=device).manual_seed(0)
        params = fns["init"](gen, device)
        opt_state = adamw_init(params)
        cell = build_cell(arch, ShapeSpec("cli", "train", args.seq,
                                          args.batch), mesh, opt_cfg=opt_cfg)
        psh, osh, _ = cell.in_shardings

        def place(t, pl):
            return distribute_tensor(t, mesh, pl, src_data_rank=None)

        params = tree_map(place, params, psh)
        opt_state = AdamWState(mu=tree_map(place, opt_state.mu, osh.mu),
                               nu=tree_map(place, opt_state.nu, osh.nu),
                               step=place(opt_state.step, osh.step))

    dcfg = DataConfig(vocab=arch.model.vocab, seq_len=args.seq,
                      global_batch=args.batch)
    start = 0
    ckpt = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    if ckpt and args.resume and ckpt.latest_step() is not None:
        with _clock(secs, "restore"):
            start, (params, opt_state) = ckpt.restore((params, opt_state))
        if rank0:
            print(f"resumed from step {start}")

    timer = StepTimer()
    log = {"loss": [], "lr": [], "grad_norm": [], "dt": []}
    tokens = 0
    try:
        for step in range(start, args.steps):
            batch = train_batch(arch, dcfg, step)
            tokens = batch["tokens"].size
            if step == args.simulate_failure:
                raise RuntimeError("simulated node failure")
            with timer:
                params, opt_state, metrics = cell.fn(params, opt_state, batch)
                loss = float(metrics["loss"])
            for k, v in (("loss", loss), ("lr", float(metrics["lr"])),
                         ("grad_norm", float(metrics["grad_norm"])),
                         ("dt", timer.last)):
                log[k].append(v)
            if rank0 and (step % args.log_every == 0
                          or step == args.steps - 1):
                print(f"step {step:5d} loss {loss:.4f} "
                      f"lr {log['lr'][-1]:.2e} "
                      f"gnorm {log['grad_norm'][-1]:.2f} "
                      f"dt {timer.last:.3f}s"
                      + (" [straggling]" if timer.is_straggling else ""),
                      flush=True)
            if ckpt and (step + 1) % args.ckpt_every == 0:
                with _clock(secs, "ckpt_save"):
                    ckpt.save(step + 1, (params, opt_state))
        # the final state, unless the loop has just saved it
        if ckpt and not (start < args.steps
                         and args.steps % args.ckpt_every == 0):
            with _clock(secs, "ckpt_save"):
                ckpt.save(args.steps, (params, opt_state))
    finally:
        # a step that raises still lets the checkpoint already copied
        # to host memory reach the disk
        if ckpt:
            with _clock(secs, "ckpt_wait"):
                ckpt.wait()
    return start, log, tokens


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--production-mesh", action="store_true")
    ap.add_argument("--data-parallel", type=int, default=1)
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--simulate-failure", type=int, default=-1)
    ap.add_argument("--log-every", type=int, default=5)
    ap.add_argument("--n-layers", type=int, default=0,
                    help="cut the depth to this many layers (0: the "
                         "config's)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    arch = get_arch(args.arch, smoke=args.smoke)
    if args.n_layers:
        arch = dataclasses.replace(arch, model=dataclasses.replace(
            arch.model, n_layers=args.n_layers))

    t_main = time.perf_counter()
    secs = {"init": 0.0, "restore": 0.0, "ckpt_save": 0.0, "ckpt_wait": 0.0}
    own_group = not dist.is_initialized()
    try:
        with deterministic(device):
            mesh = (make_production_mesh(device_type=device.type)
                    if args.production_mesh else
                    make_host_mesh(args.data_parallel, args.model_parallel,
                                   device.type))
            rank0 = dist.get_rank() == 0
            start, log, tokens = _train(args, arch, mesh, device, secs)
    finally:
        if own_group and dist.is_initialized():
            dist.destroy_process_group()
    secs["main"] = time.perf_counter() - t_main
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else None)
    if rank0:
        print("summary " + json.dumps({
            "arch": arch.arch_id, "device": str(device),
            "n_layers": arch.model.n_layers, "start": start,
            "tokens_per_step": tokens,
            "mesh": dict(zip(mesh.mesh_dim_names, tuple(mesh.shape))),
            **log, "seconds": secs, "peak_memory_bytes": peak,
            "kernel_launches": ops.launch_counts()}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
