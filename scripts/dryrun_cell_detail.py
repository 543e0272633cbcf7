"""One cell of the dry run in detail: what a rank computes, moves and
holds, and where its collective traffic comes from:

    PYTHONPATH=src python3 scripts/dryrun_cell_detail.py \\
        [--arch qwen3-0.6b] [--shape train_4k] [--multi-pod] [--layers N] \\
        [--gather-once]

Traces the cell once on the production mesh's fake ranks
(`launch.dryrun`) and prints one JSON line: per-rank matmul FLOPs, bytes,
argument and peak memory (GiB), the three roofline time terms against
one H100, and the collectives by kind (issues, payload bytes, ring-costed
bytes, group sizes) and by source line (``op_name``: the port's frame
that issued them, e.g. a gathered parameter in ``launch/steps.py _full``
or a gathered decode state in ``rank_rows``), and the trace's host
seconds (``trace_s``).  A host run: no card is needed (fake ``cuda``
tensors where one is present, else fake ``cpu``).  ``--layers N`` cuts
the config's depth to N layers (the record's ``layers``): a per-rank
FLOPs ratio between two plans does not depend on depth, and a deep
config traces in proportion to its layers.  ``--gather-once`` traces the
cell without its split over "model" (every rank gathers the parameters
once, `launch.steps`): the baseline a split cell is held to.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
from collections import defaultdict

import torch.distributed as dist

from repro_torch.analysis import roofline as rl
from repro_torch.configs.registry import SHAPES, get_arch
from repro_torch.launch import dryrun as dr
from repro_torch.launch import steps


def detail(arch_id: str, shape_name: str, multi_pod: bool,
           layers: int | None = None, gather_once: bool = False) -> dict:
    arch, shape = get_arch(arch_id), SHAPES[shape_name]
    if layers:
        arch = dataclasses.replace(arch, model=dataclasses.replace(
            arch.model, n_layers=layers))
    mesh = dr.fake_mesh(multi_pod)
    name = "x".join(map(str, mesh.shape))
    plan = steps.tpar.model_split
    if gather_once:
        steps.tpar.model_split = lambda *a, **k: None
    t0 = time.perf_counter()
    try:
        counts = dr._measure(arch, shape, mesh)
    finally:
        steps.tpar.model_split = plan
    trace_s = time.perf_counter() - t0
    roof = rl.from_counts(f"{arch_id}:{shape_name}", name, mesh.size(),
                          counts, model_flops=rl.model_flops_for(arch, shape))
    kinds: dict = defaultdict(lambda: {"issues": 0, "payload_bytes": 0,
                                       "ring_bytes": 0.0, "groups": set()})
    sources: dict = defaultdict(float)
    for c in counts.collectives:
        k = kinds[c["kind"]]
        k["issues"] += 1
        k["payload_bytes"] += c["bytes"]
        k["groups"].add(c["group"])
        if c["group"] > 1:
            ring = rl.ring_bytes(c["kind"], c["bytes"], c["group"])
            k["ring_bytes"] += ring
            sources[f"{c['kind']} {c['op_name']}"] += ring
    return {"arch": arch_id, "shape": shape_name, "mesh": name,
            "layers": arch.model.n_layers, "gather_once": gather_once,
            "flops_per_rank": counts.flops, "bytes_per_rank": counts.bytes,
            "argument_gib": counts.argument_bytes / 2**30,
            "peak_gib": counts.peak_bytes / 2**30,
            "t_compute": roof.t_compute, "t_memory": roof.t_memory,
            "t_collective": roof.t_collective,
            "bottleneck": roof.bottleneck,
            "useful_flops_fraction": roof.useful_flops_fraction,
            "collective_bytes_per_rank": roof.coll_bytes_per_chip,
            "by_kind": {k: dict(v, groups=sorted(v["groups"]))
                        for k, v in kinds.items()},
            "by_source": dict(sorted(sources.items(),
                                     key=lambda kv: -kv[1])),
            "trace_s": trace_s}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the config to this many layers")
    ap.add_argument("--gather-once", action="store_true",
                    help="trace without the split over \"model\"")
    args = ap.parse_args(argv)
    try:
        print(json.dumps(detail(args.arch, args.shape, args.multi_pod,
                                args.layers, args.gather_once)),
              flush=True)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
