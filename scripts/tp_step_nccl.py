"""The train cell on several cards over NCCL, one mesh after another, against
the plain step on one card (ROADMAP C.16):

    python3 scripts/tp_step_nccl.py [--arch qwen3-0.6b] [--cards 4] \\
        [--meshes 1,4x1,2x2,1x4] [--steps 3] [--batch 4] [--seq 4096] \\
        [--out build/tp_step_nccl.json]

``--arch`` at full width and depth in the production dtypes (float32
parameters, bfloat16 compute, remat).  Each entry of ``--meshes`` is one
run: ``1`` is `train_step` on plain tensors on card 0 in this process; D x
M (D * M = ``--cards``) is `launch.steps.build_cell`'s train cell on that
mesh, on ``--cards`` ranks spawned for it (one card each, ``nccl``): 4 x 1
data-parallel (the gather-once step), 2 x 2 and 1 x 4 with the "model"
axis split (`distributed.tensor_parallel`; expert-parallel for the moe
family).  Every run takes ``--steps`` steps of the same global batches on
the same weights; the first is a warm-up.  The weights are drawn leaf by
leaf (`draw`), each leaf whole on the card from its own seed and then cut
to the rank's shard, so that no card holds the whole model at once
(deepseek-moe-16b's 62.9 GiB of float32 weights): the init's scales
(N(0, 1) / sqrt(fan-in), 0.02 for the token table, zeros for the norms),
not its draws.  Prints one JSON line a run: the losses, the steady step
ms (the slowest rank's mean after the warm-up), tokens a second and each
rank's peak memory, or where a run ran out of card memory
(``out_of_memory``), after a line with the cards' names and power
limits.  Needs the cards: it fails without them.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import socket
import subprocess
import sys
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))


def _setup(args):
    import repro_torch  # noqa: F401  (TF32 off)
    from repro_torch.configs.registry import get_arch
    from repro_torch.data import DataConfig
    from repro_torch.launch.steps import family_fns
    arch = get_arch(args.arch)
    return arch, family_fns(arch), DataConfig(
        vocab=arch.model.vocab, seq_len=args.seq, global_batch=args.batch)


def draw(arch, place=lambda t, path: t):
    """``arch``'s parameters, each leaf drawn whole on the card from seed
    ``1000 + its index`` and passed through ``place(leaf, path)`` (a
    rank's shard) before the next is drawn."""
    from repro_torch.distributed.sharding import map_with_path
    from repro_torch.launch.steps import abstract_params
    count = [0]

    def leaf(path, meta):
        gen = torch.Generator(device="cuda").manual_seed(1000 + count[0])
        count[0] += 1
        name = path.rsplit("/", 1)[-1]
        if name.startswith("ln") or name.endswith("norm"):
            t = torch.zeros(meta.shape, dtype=meta.dtype, device="cuda")
        else:
            scale = 0.02 if path == "emb/tok" else \
                1.0 / math.sqrt(meta.shape[-2])
            t = (torch.randn(meta.shape, generator=gen, device="cuda")
                 * scale).to(meta.dtype)
        return place(t, path)

    return map_with_path(leaf, abstract_params(arch))


def plain(args) -> dict:
    """`train_step` on plain tensors on card 0."""
    from repro_torch.launch.steps import train_step
    from repro_torch.launch.train import train_batch
    from repro_torch.optim import OptConfig, adamw_init
    arch, fns, dcfg = _setup(args)
    torch.cuda.set_device(0)
    params = draw(arch)
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


def _rank(rank: int, port: int, args, d: int, m: int, out: str) -> None:
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.configs.registry import ShapeSpec
    from repro_torch.distributed.sharding import map_with_path
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import build_cell
    from repro_torch.launch.train import train_batch
    from repro_torch.optim import OptConfig
    from repro_torch.optim.adamw import AdamWState
    torch.cuda.set_device(rank)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=args.cards,
                            device_id=torch.device("cuda", rank))
    try:
        arch, fns, dcfg = _setup(args)
        mesh = make_host_mesh(d, m, device_type="cuda")
        cell = build_cell(arch, ShapeSpec("t", "train", args.seq,
                                          args.batch), mesh,
                          opt_cfg=OptConfig())
        psh, osh, _ = cell.in_shardings

        def shard(t, path):
            pl = psh
            for key in path.split("/"):
                pl = pl[key]
            return distribute_tensor(t, mesh, pl, src_data_rank=None)

        def zeros(path, meta):
            return shard(torch.zeros(meta.shape, dtype=torch.float32,
                                     device="cuda"), path)

        p = draw(arch, shard)
        o = AdamWState(mu=map_with_path(zeros, cell.args[0]),
                       nu=map_with_path(zeros, cell.args[0]),
                       step=distribute_tensor(
                           torch.zeros((), dtype=torch.int32, device="cuda"),
                           mesh, osh.step, src_data_rank=None))
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
        if rank == 0:
            with open(out, "w") as f:
                json.dump({"mesh": f"{d}x{m}", "losses": losses,
                           "step_ms": 1e3 * steady, "peak_gib": peaks}, f)
    finally:
        dist.destroy_process_group()


def on_mesh(args, d: int, m: int) -> dict:
    """The train cell on a D x M mesh of freshly spawned ranks; a rank
    that runs out of card memory ends the run, recorded with the frame
    that raised."""
    out = f"{args.out}.{d}x{m}"
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    try:
        mp.start_processes(_rank, args=(port, args, d, m, out),
                           nprocs=args.cards, start_method="spawn")
    except mp.ProcessRaisedException as e:
        if "OutOfMemoryError" not in str(e):
            raise
        lines = [x.strip() for x in str(e).splitlines() if x.strip()]
        where = [x for x in lines if x.startswith("File ")][-3:]
        return {"mesh": f"{d}x{m}", "out_of_memory": where,
                "error": lines[-1][:300]}
    with open(out) as f:
        run = json.load(f)
    os.remove(out)
    run["tokens_per_s"] = args.batch * args.seq / (run["step_ms"] / 1e3)
    return run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--cards", type=int, default=4)
    ap.add_argument("--meshes", default="1,4x1,2x2,1x4",
                    help="runs in order: 1 (plain, one card) or DxM")
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=4096)
    ap.add_argument("--out", default="build/tp_step_nccl.json")
    args = ap.parse_args(argv)
    if torch.cuda.device_count() < args.cards:
        print(f"needs {args.cards} cards, found "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 2
    meshes = []
    for name in args.meshes.split(","):
        if name != "1":
            d, m = map(int, name.split("x"))
            if d * m != args.cards:
                ap.error(f"mesh {name} is not {args.cards} cards")
        meshes.append(name)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()
    print(json.dumps({"card": torch.cuda.get_device_name(0),
                      "count": torch.cuda.device_count(),
                      "arch": args.arch, "nvidia_smi": smi}), flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    runs = []
    for name in meshes:
        if name == "1":
            run = plain(args)
            run["tokens_per_s"] = args.batch * args.seq / (
                run["step_ms"] / 1e3)
        else:
            run = on_mesh(args, *map(int, name.split("x")))
        runs.append(run)
        print(json.dumps(run), flush=True)
    with open(args.out, "w") as f:
        json.dump(runs, f)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
