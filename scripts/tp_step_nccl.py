"""The train cell on several cards over NCCL, one mesh after another, against
the plain step on one card (ROADMAP C.16):

    python3 scripts/tp_step_nccl.py [--cards 4] [--steps 3] \\
        [--batch 4] [--seq 4096] [--out build/tp_step_nccl.json]

qwen3-0.6b at full width and depth in the production dtypes (float32
parameters, bfloat16 compute, remat).  First `train_step` on plain tensors
on card 0 in this process, then ``--cards`` spawned ranks (one card each,
``nccl``) run `launch.steps.build_cell`'s train cell on every D x M mesh
of that many ranks: 4 x 1 (data-parallel, the gather-once step), 2 x 2
and 1 x 4 (the "model" axis split, `distributed.tensor_parallel`).  Each
mesh takes ``--steps`` steps of the same global batches from the same
seed; the first is a warm-up.  Prints one JSON line a run: the losses,
the steady step ms (the slowest rank's mean after the warm-up), tokens a
second and each rank's peak memory, after a line with the cards' names
and power limits.  Needs the cards: it fails without them.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

ARCH = "qwen3-0.6b"


def _setup(args):
    import repro_torch  # noqa: F401  (TF32 off)
    from repro_torch.configs.registry import get_arch
    from repro_torch.data import DataConfig
    from repro_torch.launch.steps import family_fns
    arch = get_arch(ARCH)
    return arch, family_fns(arch), DataConfig(
        vocab=arch.model.vocab, seq_len=args.seq, global_batch=args.batch)


def plain(args) -> dict:
    """`train_step` on plain tensors on card 0."""
    from repro_torch.launch.steps import train_step
    from repro_torch.launch.train import train_batch
    from repro_torch.optim import OptConfig, adamw_init
    arch, fns, dcfg = _setup(args)
    torch.cuda.set_device(0)
    params = fns["init"](torch.Generator(device="cuda").manual_seed(0),
                         "cuda")
    opt = adamw_init(params)
    torch.cuda.reset_peak_memory_stats()
    losses, secs = [], []
    for step in range(args.steps):
        batch = train_batch(arch, dcfg, step)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, m = train_step(params, opt, batch, fns["loss"],
                                    OptConfig())
        losses.append(float(m["loss"]))
        secs.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated() / 2**30
    del params, opt
    torch.cuda.empty_cache()
    return {"mesh": "plain 1 card", "losses": losses,
            "step_ms": 1e3 * sum(secs[1:]) / max(len(secs) - 1, 1),
            "peak_gib": [peak]}


def _rank(rank: int, port: int, args, out: str) -> None:
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.configs.registry import ShapeSpec
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import build_cell
    from repro_torch.launch.train import train_batch
    from repro_torch.optim import OptConfig, adamw_init
    from repro_torch.optim.adamw import AdamWState, tree_map
    torch.cuda.set_device(rank)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=args.cards,
                            device_id=torch.device("cuda", rank))
    try:
        arch, fns, dcfg = _setup(args)
        runs = []
        meshes = [(d, args.cards // d) for d in (args.cards, 2, 1)
                  if args.cards % d == 0]
        for d, m in dict.fromkeys(meshes):
            mesh = make_host_mesh(d, m, device_type="cuda")
            cell = build_cell(arch, ShapeSpec("t", "train", args.seq,
                                              args.batch), mesh,
                              opt_cfg=OptConfig())
            psh, osh, _ = cell.in_shardings

            def placed(tree, sh):
                return tree_map(lambda t, pl: distribute_tensor(
                    t, mesh, pl, src_data_rank=None), tree, sh)

            params = fns["init"](torch.Generator(device="cuda")
                                 .manual_seed(0), "cuda")
            opt = adamw_init(params)
            p = placed(params, psh)
            o = AdamWState(mu=placed(opt.mu, osh.mu),
                           nu=placed(opt.nu, osh.nu),
                           step=placed(opt.step, osh.step))
            del params, opt
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            losses, secs = [], []
            for step in range(args.steps):
                batch = train_batch(arch, dcfg, step)
                dist.barrier()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                p, o, met = cell.fn(p, o, batch)
                losses.append(float(met["loss"]))
                secs.append(time.perf_counter() - t0)
            peak = torch.cuda.max_memory_allocated() / 2**30
            slowest = torch.tensor(secs, device="cuda")
            dist.all_reduce(slowest, op=dist.ReduceOp.MAX)
            peaks = [None] * dist.get_world_size()
            dist.all_gather_object(peaks, peak)
            steady = slowest[1:].mean().item() if args.steps > 1 \
                else slowest[0].item()
            runs.append({"mesh": f"{d}x{m}", "losses": losses,
                         "step_ms": 1e3 * steady, "peak_gib": peaks})
            del p, o, met
            torch.cuda.empty_cache()
        if rank == 0:
            with open(out, "w") as f:
                json.dump(runs, f)
    finally:
        dist.destroy_process_group()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cards", type=int, default=4)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=4096)
    ap.add_argument("--out", default="build/tp_step_nccl.json")
    args = ap.parse_args(argv)
    if torch.cuda.device_count() < args.cards:
        print(f"needs {args.cards} cards, found "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()
    print(json.dumps({"card": torch.cuda.get_device_name(0),
                      "count": torch.cuda.device_count(),
                      "nvidia_smi": smi}), flush=True)
    print(json.dumps(plain(args)), flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    mp.start_processes(_rank, args=(port, args, args.out),
                       nprocs=args.cards, start_method="spawn")
    with open(args.out) as f:
        for run in json.load(f):
            run["tokens_per_s"] = args.batch * args.seq / (
                run["step_ms"] / 1e3)
            print(json.dumps(run), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
