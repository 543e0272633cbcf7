"""Dry run: trace every (arch x shape x mesh) cell once on fake tensors, on
a fake process group of 256 ranks (16 x 16) or 512 (2 x 16 x 16) (port of
``repro.launch.dryrun``).

Proves that the distribution config is coherent without hardware: a
placement the step cannot take, a shape that does not split, or an
operator whose output shape depends on data fails the cell.  Writes one
JSON record a cell (memory, counts, collectives, roofline terms) to
``results/dryrun_torch/<arch>_<shape>_<mesh>.json``; a sweep resumes
where it stopped.

The trace is rank 0's: the process joins a ``fake`` process group of the
mesh's size (collectives return at once, their results uninitialised),
places `launch.steps.build_cell`'s arguments as DTensors of fake tensors
by the cell's ``in_shardings`` (shapes and dtypes, no memory),
and runs the cell's function once, eagerly, under four counters:

* FLOPs: matrix products, 2·M·N·K (``FlopCounterMode``);
* bytes: the tensor bytes read and written by every operator that is not
  a view, summed.  The eager step runs unfused, one operator after
  another, so this is its traffic; it is not XLA's ``bytes accessed`` of
  a fused program, which the reference's memory term reads;
* collectives: every ``_c10d_functional`` operator (and DTensor's
  ``shard_dim_alltoall``), with its kind, the bytes of its result, its
  group size and the innermost frame of the port that issued it
  (``op_name``);
* memory: the bytes of live tensor storages, each rounded up to the CUDA
  caching allocator's 512-byte blocks, at their peak.

The trace runs on the device the port's entry points run on: fake
``cuda`` tensors over a ``cuda`` mesh where a card is present, so that
the model takes the card's code paths (``optim/grads.py`` skips its
CPU-only log warm-up), else fake ``cpu`` tensors over a ``cpu`` mesh.
PyTorch built without CUDA cannot trace fake ``cuda`` tensors: Python
indexing and autograd's gradient accumulators of a ``cuda`` tensor need
its device guard, which such a build lacks (the process aborts).  The
``cpu`` trace differs from the card's in two places: the warm-up's two
one-element logs, and DTensor's shard-to-shard redistribution, which a
``cpu`` mesh runs as an all-gather and a local chunk, not an all-to-all
(no cell of this port redistributes that way).  A cell that reaches a
port kernel (``--attn impl=pallas``) records ``failed`` on either device:
the kernels have no fake implementation and nothing falls back to the
plain version (`kernels.ops`).

Eager counting counts every layer, so no depth fit is needed: the
reference compiled two unrolled depths and extrapolated because XLA's
``cost_analysis`` counts a scan body once.  `calibrated_roofline` traces
the full depth; ``tests/test_torch_dryrun.py`` shows the counts are
exactly linear in depth (the fit would give the same number), and the
reference's ``roofline_raw_body_once`` record has no counterpart.

Usage:
  python -m repro_torch.launch.dryrun --all
  python -m repro_torch.launch.dryrun --arch qwen3-0.6b --shape train_4k
  python -m repro_torch.launch.dryrun --arch qwen3-0.6b --shape train_4k \\
      --multi-pod
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
import traceback
import weakref

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch.analysis import roofline as rl
from repro_torch.configs.registry import ARCHS, SHAPES, get_arch
from repro_torch.distributed import sharding as shd
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.steps import build_cell, zip_map

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "results", "dryrun_torch")
ALLOC_BLOCK = 512          # the CUDA caching allocator's rounding

_KINDS = {"all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
          "all_gather_into_tensor": "all-gather",
          "all_gather_into_tensor_coalesced": "all-gather",
          "reduce_scatter_tensor": "reduce-scatter",
          "reduce_scatter_tensor_coalesced": "reduce-scatter",
          "all_to_all_single": "all-to-all",
          "shard_dim_alltoall": "all-to-all"}


# ------------------------------------------------------------ the group ---

def join_fake_group(world: int) -> None:
    """Make this process rank 0 of a ``fake`` default process group of
    ``world`` ranks, leaving one of another kind or size first."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_backend() == "fake" and dist.get_world_size() == world:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def trace_device() -> str:
    """``cuda`` where a card is present, else ``cpu`` (module docstring)."""
    return "cuda" if torch.cuda.is_available() else "cpu"


def fake_mesh(multi_pod: bool):
    """The production mesh (`launch.mesh.make_production_mesh`) over a
    fake group of its size, on `trace_device`."""
    join_fake_group(512 if multi_pod else 256)
    return make_production_mesh(multi_pod=multi_pod,
                                device_type=trace_device())


# ----------------------------------------------------------- the counts ---

@dataclasses.dataclass
class Counts:
    """What one traced call of a cell did on rank 0."""
    flops: float = 0.0
    bytes: float = 0.0
    collectives: list = dataclasses.field(default_factory=list)
    argument_bytes: int = 0
    output_bytes: int = 0
    alias_bytes: int = 0          # outputs that live in an argument
    peak_bytes: int = 0
    by_op: dict = dataclasses.field(default_factory=dict)  # op -> bytes

    @property
    def temp_bytes(self) -> int:
        return self.peak_bytes - (self.argument_bytes + self.output_bytes
                                  - self.alias_bytes)


def _local(t: torch.Tensor) -> torch.Tensor:
    return t._local_tensor if isinstance(t, DTensor) else t


def _nbytes(t: torch.Tensor) -> int:
    t = _local(t)
    return t.numel() * t.element_size()


def _storage_bytes(s) -> int:
    return -(-s.nbytes() // ALLOC_BLOCK) * ALLOC_BLOCK


def _source_frame() -> str:
    """``file:line function`` of the innermost frame of the port."""
    for fr in reversed(traceback.extract_stack()):
        if (f"{os.sep}repro_torch{os.sep}" in fr.filename
                and not fr.filename.endswith("dryrun.py")):
            path = fr.filename[fr.filename.rindex("repro_torch"):]
            return f"{path}:{fr.lineno} {fr.name}"
    return ""


def from_gather_once(op_name: str) -> bool:
    """Whether a collective's ``op_name`` (`_source_frame`'s ``file:line
    function``) lies in `launch.steps._full`, the path that gathers every
    parameter once."""
    import inspect
    from repro_torch.launch import steps
    lines, first = inspect.getsourcelines(steps._full)
    path, _, rest = op_name.partition(":")
    return (path == os.path.join("repro_torch", "launch", "steps.py")
            and first <= int(rest.split()[0]) < first + len(lines))


def _in_sharding_propagation() -> bool:
    """Whether DTensor's sharding propagation issued the operator: on the
    first call of an operator at given shapes it runs the operator on
    fake inputs of its own to learn the output's shape (later calls hit
    its cache).  That is not the step's work, so it is not counted."""
    frame = sys._getframe(2)
    for _ in range(_PROPAGATION_DEPTH):
        if frame is None:
            return False
        if frame.f_code.co_filename.endswith(_PROPAGATION_FILE):
            return True
        frame = frame.f_back
    return False


_PROPAGATION_FILE = os.path.join("distributed", "tensor", "_sharding_prop.py")
_PROPAGATION_DEPTH = 40


class _Counter(TorchDispatchMode):
    """Bytes, collectives and live storage bytes of every operator."""

    def __init__(self, counts: Counts):
        super().__init__()
        self.c = counts
        self.live = 0
        self.seen: weakref.WeakSet = weakref.WeakSet()

    def track(self, t: torch.Tensor) -> None:
        s = _local(t).untyped_storage()
        if s in self.seen:
            return
        self.seen.add(s)
        n = _storage_bytes(s)
        self.live += n
        self.c.peak_bytes = max(self.c.peak_bytes, self.live)
        weakref.finalize(s, self._free, n)

    def _free(self, n: int) -> None:
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            # let DTensor run first: this mode then sees its local
            # operators and the collectives it issues (as CommDebugMode)
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if _in_sharding_propagation():
            return out
        ins = [t for t in tree_leaves((args, kwargs))
               if isinstance(t, torch.Tensor)]
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        in_storage = {id(_local(t).untyped_storage()) for t in ins}
        aliased = all(id(_local(t).untyped_storage()) in in_storage
                      for t in outs)
        if func._schema.is_mutable or not aliased:
            moved = sum(map(_nbytes, ins)) + sum(map(_nbytes, outs))
            self.c.bytes += moved
            name = func._schema.name.split("::")[-1]
            self.c.by_op[name] = self.c.by_op.get(name, 0) + moved
        if func.namespace in ("_c10d_functional", "_dtensor"):
            self._collective(func, args, outs)
        for t in outs:
            self.track(t)
        return out

    def _collective(self, func, args, outs) -> None:
        name = func._schema.name.split("::")[-1].rstrip("_")
        if name == "wait_tensor" or not isinstance(args[-1], str):
            return      # a wait, or (real tensors) a result's wrapping
        group = args[-1]
        size = dist.distributed_c10d._resolve_process_group(group).size()
        where = _source_frame()
        for t in outs:
            self.c.collectives.append({
                "kind": _KINDS.get(name, name), "bytes": _nbytes(t),
                "group": size, "shape": list(_local(t).shape),
                "op_name": where})


def _fake_args(cell, mesh, fake_mode, position: int | None = None):
    """The cell's arguments as fake tensors on the mesh's device (call
    inside ``fake_mode``): DTensors of rank 0's shard by the cell's
    ``in_shardings``.  A decode cell (``position`` given) steps at that
    position: its ``pos`` and its states' replicated position counters
    (the leaves named ``t``, which ``state_specs`` never shards) are plain
    tensors whose value the trace knows, as the port's decode step reads
    the counter on the host (``int(state.t)``)."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset)

    def place(meta, pl):
        with unset_fake_temporarily():
            shape, _ = compute_local_shape_and_global_offset(
                meta.shape, mesh, pl)
        local = torch.empty(shape, dtype=meta.dtype,
                            device=mesh.device_type)
        stride = torch.empty(meta.shape, device="meta").stride()
        return DTensor.from_local(local, mesh, pl, run_check=False,
                                  shape=meta.shape, stride=stride)

    def known(meta):
        with unset_fake_temporarily():
            real = torch.full(meta.shape, position, dtype=meta.dtype,
                              device=mesh.device_type)
        return fake_mode.fake_tensor_converter.from_real_tensor(
            fake_mode, real, make_constant=True)

    args = [zip_map(place, a, sh)
            for a, sh in zip(cell.args, cell.in_shardings)]
    if position is not None:
        counter = shd.map_with_path(
            lambda path, _: path.split("/")[-1] == "t", cell.args[1])
        args[1] = zip_map(lambda x, meta, is_t: known(meta) if is_t else x,
                          args[1], cell.args[1], counter)
        args[3] = known(cell.args[3])
    return tuple(args)


def trace(fn, args_fn) -> Counts:
    """Counts of one call ``fn(*args_fn(fake_mode))``, ``args_fn`` making
    its fake arguments inside the fake mode."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode
    counts = Counts()
    fake_mode = FakeTensorMode(allow_non_fake_inputs=True)
    with fake_mode:
        args = args_fn(fake_mode)
        counter = _Counter(counts)
        for t in tree_leaves(args):
            if isinstance(t, torch.Tensor):
                counter.track(t)
        counts.argument_bytes = counter.live
        flops = FlopCounterMode(display=False)
        with flops, counter:
            out = fn(*args)
        arg_storage = {id(_local(t).untyped_storage())
                       for t in tree_leaves(args)
                       if isinstance(t, torch.Tensor)}
        seen = {}
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor):
                s = _local(t).untyped_storage()
                seen[id(s)] = (_storage_bytes(s), id(s) in arg_storage)
        counts.output_bytes = sum(n for n, _ in seen.values())
        counts.alias_bytes = sum(n for n, a in seen.values() if a)
        counts.flops = float(flops.get_total_flops())
    return counts


def _measure(arch, shape, mesh, state_policy: str = "seq",
             microbatch: int = 1) -> Counts:
    cell = build_cell(arch, shape, mesh, state_policy=state_policy,
                      microbatch=microbatch)
    position = decode_position(arch, shape) if shape.kind == "decode" \
        else None
    return trace(cell.fn, lambda fm: _fake_args(cell, mesh, fm, position))


def decode_position(arch, shape) -> int:
    """The position a decode cell steps at: the last row of its cache
    (the step that fills it and closes its last window, the most work and
    memory of any step)."""
    return (arch.dec_len if arch.family == "encdec" else shape.seq) - 1


def calibrated_roofline(arch, shape, mesh, mesh_name: str,
                        model_flops: float, state_policy: str = "seq",
                        microbatch: int = 1) -> rl.Roofline:
    """Roofline terms of the cell at its full depth, from one trace (no
    depth fit: see the module docstring)."""
    counts = _measure(arch, shape, mesh, state_policy, microbatch)
    return rl.from_counts(f"{arch.arch_id}:{shape.name}", mesh_name,
                          mesh.size(), counts, model_flops=model_flops)


def run_cell(arch_id: str, shape_name: str, multi_pod: bool,
             out_dir: str, force: bool = False,
             backend_override: str | None = None,
             tag: str = "", state_policy: str = "seq",
             attn_overrides: dict | None = None,
             microbatch: int = 1) -> dict:
    mesh_name = "2x16x16" if multi_pod else "16x16"
    fname = f"{arch_id}_{shape_name}_{mesh_name}{tag}.json"
    path = os.path.join(out_dir, fname)
    if os.path.exists(path) and not force:
        with open(path) as f:
            return json.load(f)

    arch = get_arch(arch_id, backend=backend_override)
    if attn_overrides:
        arch = dataclasses.replace(
            arch, model=dataclasses.replace(
                arch.model, attn=dataclasses.replace(
                    arch.model.attn, **attn_overrides)))
    shape = SHAPES[shape_name]
    ok, why = arch.shape_supported(shape)
    rec: dict = {"arch": arch_id, "shape": shape_name, "mesh": mesh_name,
                 "backend": backend_override or arch.model.attn.backend,
                 "state_policy": state_policy,
                 "attn_overrides": attn_overrides or {},
                 "microbatch": microbatch}
    if not ok:
        rec.update(status="skipped", reason=why)
        _write(path, rec)
        return rec
    if why:
        rec["note"] = why

    mesh = fake_mesh(multi_pod)
    t0 = time.time()
    try:
        counts = _measure(arch, shape, mesh, state_policy, microbatch)
        roof = rl.from_counts(f"{arch_id}:{shape_name}", mesh_name,
                              mesh.size(), counts,
                              model_flops=rl.model_flops_for(arch, shape))
        rec.update(
            status="ok",
            trace_s=round(time.time() - t0, 2),
            memory=dict(
                argument_bytes=counts.argument_bytes,
                output_bytes=counts.output_bytes,
                temp_bytes=counts.temp_bytes,
                alias_bytes=counts.alias_bytes,
                peak_per_device=counts.argument_bytes
                + counts.output_bytes + counts.temp_bytes
                - counts.alias_bytes,
            ),
            roofline=roof.to_dict(),
        )
    except Exception as e:  # noqa: BLE001 — record the failure
        rec.update(status="failed", error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-2000:],
                   trace_s=round(time.time() - t0, 2))
    _write(path, rec)
    return rec


def _write(path: str, rec: dict):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)


def parse_attn(spec: str) -> dict:
    """``key=value,...`` attention overrides (booleans, numbers, words)."""
    overrides = {}
    for kv in filter(None, spec.split(",")):
        key, val = kv.split("=")
        if val.lower() in ("true", "false"):
            overrides[key] = val.lower() == "true"
        elif val.replace(".", "").isdigit():
            overrides[key] = float(val) if "." in val else int(val)
        else:
            overrides[key] = val
    return overrides


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--backend", default=None,
                    help="attention backend override (e.g. full for the "
                         "paper-baseline comparison)")
    ap.add_argument("--tag", default="", help="suffix for result files")
    ap.add_argument("--state-policy", default="seq", choices=["seq", "dh"])
    ap.add_argument("--microbatch", type=int, default=1)
    ap.add_argument("--attn", default="",
                    help="attention overrides, e.g. impl=pallas,"
                         "route_per_group=true,block_q=512")
    ap.add_argument("--out", default=RESULTS_DIR)
    args = ap.parse_args(argv)

    overrides = parse_attn(args.attn)
    archs = ARCHS if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = [False, True] if (args.all or args.both_meshes) \
        else [args.multi_pod]

    n_fail = 0
    try:
        for arch_id in archs:
            for shape_name in shapes:
                for mp in meshes:
                    t0 = time.time()
                    rec = run_cell(arch_id, shape_name, mp, args.out,
                                   force=args.force,
                                   backend_override=args.backend,
                                   tag=args.tag,
                                   state_policy=args.state_policy,
                                   attn_overrides=overrides,
                                   microbatch=args.microbatch)
                    status = rec.get("status")
                    msg = f"[{time.strftime('%H:%M:%S')}] " \
                          f"{arch_id:20s} {shape_name:12s} " \
                          f"{'2x16x16' if mp else '16x16':8s} " \
                          f"{status:8s} ({time.time()-t0:6.1f}s)"
                    if status == "ok":
                        r = rec["roofline"]
                        t = max(r['t_compute'], r['t_memory'],
                                r['t_collective'])
                        msg += (f" bottleneck={r['bottleneck']:10s} "
                                f"t={t:.3e}s mem/dev="
                                f"{rec['memory']['peak_per_device']/2**30:.2f}"
                                "GiB")
                    elif status == "failed":
                        n_fail += 1
                        msg += " " + rec.get("error", "")[:120]
                    print(msg, flush=True)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    print(f"done; failures: {n_fail}")
    return 1 if n_fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
