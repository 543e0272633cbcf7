"""Hillclimb profiler: trace one cell on the fake production mesh
(optionally at a reduced depth) and print its counts per rank, the
operators that move the most bytes, and its top collectives with the
port's source frames: the profile available without hardware (port of ``repro.analysis.profile_cell``).  Eager
tracing counts every layer, so ``--depth`` only shortens the model.

Usage:
  PYTHONPATH=src python -m repro_torch.analysis.profile_cell \\
      --arch qwen3-32b --shape train_4k [--depth 2] \\
      [--state-policy dh] [--attn impl=pallas]
"""

import argparse
import dataclasses

import torch.distributed as dist

from repro_torch.analysis import roofline as rl
from repro_torch.configs.registry import SHAPES, get_arch
from repro_torch.launch import dryrun


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--depth", type=int, default=0,
                    help="reduced depth (0 = the config's)")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--state-policy", default="seq")
    ap.add_argument("--attn", default="")
    ap.add_argument("--top", type=int, default=12)
    args = ap.parse_args(argv)

    arch = get_arch(args.arch)
    if args.attn:
        arch = dataclasses.replace(arch, model=dataclasses.replace(
            arch.model, attn=dataclasses.replace(
                arch.model.attn, **dryrun.parse_attn(args.attn))))
    if args.depth:
        arch = dataclasses.replace(arch, model=dataclasses.replace(
            arch.model, n_layers=args.depth))
    shape = SHAPES[args.shape]
    try:
        mesh = dryrun.fake_mesh(args.multi_pod)
        counts = dryrun._measure(arch, shape, mesh, args.state_policy)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()

    print(f"== {args.arch} {args.shape} depth={args.depth or 'full'} "
          f"policy={args.state_policy} attn=[{args.attn}] ==")
    print(f"flops/chip={counts.flops:.3e}  bytes/chip={counts.bytes:.3e}  "
          f"temp_mem={counts.temp_bytes/2**30:.2f}GiB")
    coll = rl.collective_bytes(counts.collectives)
    print("collective bytes by kind:",
          {k: f"{v:.3e}" for k, v in sorted(coll.items(),
                                            key=lambda kv: -kv[1])})
    print(f"\ntop {args.top} operators by bytes moved:")
    for name, n in sorted(counts.by_op.items(),
                          key=lambda kv: -kv[1])[:args.top]:
        print(f"  {n:.3e}B  {100 * n / counts.bytes:5.1f}%  {name}")
    print(f"\ntop {args.top} collectives (one line an issue of the step; "
          "each layer's are its own):")
    for c in rl.top_collectives(counts.collectives, args.top):
        print(f"  {c['bytes']:.3e}B  {c['kind']:18s} {c['shape']:34s} "
              f"g={c['groups']:4d}  {c['op_name']}")


if __name__ == "__main__":
    main()
