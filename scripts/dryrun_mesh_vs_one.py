"""What the "model" axis of the port's sharded step saves, counted by the
dry run (ROADMAP C.16):

    PYTHONPATH=src python3 scripts/dryrun_mesh_vs_one.py \\
        [--arch qwen3-0.6b] [--shape train_4k] [--multi-pod]

Traces the cell on the production mesh's fake ranks and again on one fake
rank with the batch cut to one data rank's share, and prints each one's
per-rank counts as a JSON line: matmul FLOPs, bytes moved, collective
bytes, argument bytes and peak live memory.  A host run: no card is
needed (fake ``cuda`` tensors where one is present, else fake ``cpu``).
"""

from __future__ import annotations

import argparse
import dataclasses
import json

import torch.distributed as dist

from repro_torch.analysis import roofline as rl
from repro_torch.configs.registry import SHAPES, get_arch
from repro_torch.distributed import sharding as shd
from repro_torch.launch import dryrun as dr
from repro_torch.launch.mesh import make_host_mesh


def _line(name: str, mesh, counts) -> dict:
    return {"mesh": name, "ranks": mesh.size(),
            "flops_per_rank": counts.flops, "bytes_per_rank": counts.bytes,
            "collective_bytes_per_rank": sum(
                rl.collective_bytes(counts.collectives).values()),
            "argument_gib": counts.argument_bytes / 2**30,
            "peak_gib": counts.peak_bytes / 2**30}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--multi-pod", action="store_true")
    args = ap.parse_args(argv)
    arch = get_arch(args.arch)
    shape = SHAPES[args.shape]
    try:
        mesh = dr.fake_mesh(args.multi_pod)
        share = shape.batch // shd.data_size(mesh)
        name = "x".join(map(str, mesh.shape))
        print(json.dumps(dict(_line(name, mesh, dr._measure(
            arch, shape, mesh)), batch=shape.batch)), flush=True)
        dr.join_fake_group(1)
        one = make_host_mesh(1, 1, device_type=dr.trace_device())
        cut = dataclasses.replace(shape, batch=share)
        print(json.dumps(dict(_line("1x1", one, dr._measure(
            arch, cut, one)), batch=share)), flush=True)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
