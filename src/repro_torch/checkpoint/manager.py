"""Checkpointing: async, atomic, in the reference's on-disk format (port of
``repro.checkpoint.manager``).

  * **Format** -- ``<dir>/step_<n>/arrays.npz`` keyed by the ``/``-joined
    tree path of each leaf (a dict key, a sequence index or a NamedTuple
    field name, as the reference's ``_path_str`` gives them) and
    ``meta.json``.  bf16 is widened to float32 (numpy has no bf16);
    restore casts back to the target leaf's dtype.  A checkpoint written
    by either package restores in the other.
  * **Atomicity** -- writes go to ``step_<n>.tmp/`` then ``os.rename`` to
    ``step_<n>/``; a crash mid-write never corrupts the latest checkpoint.
  * **Async** -- `save` copies every leaf to host memory before it returns
    (on the CPU ``Tensor.numpy()`` would share the parameter's storage, and
    an in-place step would change the arrays under the writer), then
    hands the file I/O to a background thread, which does no CUDA work.
  * **Retention** -- `CheckpointManager(keep=k)` prunes old steps.
  * **Sharded trees** -- a DTensor leaf is gathered to its full value
    (every rank of its mesh takes part); only rank 0 of the process group
    copies it to host memory, writes and prunes.  Restore reads the full
    arrays on every rank, cuts each to the rank's part of its target
    leaf's placement on the host and moves only that part to the device
    (for a tree placed by ``param_specs``, the placement
    `distributed.fault_tolerance.elastic_retarget` gives), so a
    checkpoint written on one mesh restores on any other, or in one
    process.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor


def _leaves_with_path(tree, path=()):
    """(path, leaf) pairs of nested dicts, lists, tuples and NamedTuples,
    dict keys in sorted order (``jax.tree_util``'s order)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves_with_path(tree[k], path + (str(k),))
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for name in tree._fields:
            yield from _leaves_with_path(getattr(tree, name), path + (name,))
    elif isinstance(tree, (list, tuple)):
        for i, x in enumerate(tree):
            yield from _leaves_with_path(x, path + (str(i),))
    else:
        yield path, tree


def _unflatten(tree, leaves):
    """``tree``'s structure with its leaves taken in turn from ``leaves``
    (an iterator in `_leaves_with_path` order)."""
    if isinstance(tree, dict):
        new = {k: _unflatten(tree[k], leaves) for k in sorted(tree)}
        return {k: new[k] for k in tree}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_unflatten(getattr(tree, f), leaves)
                            for f in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_unflatten(x, leaves) for x in tree)
    return next(leaves)


def full_value(x):
    """A leaf's whole value as a plain tensor: a DTensor is gathered (a
    collective: every rank of its mesh calls it)."""
    return x.full_tensor() if isinstance(x, DTensor) else x


def _writer() -> bool:
    """Whether this process writes checkpoints: rank 0, or no group."""
    return not dist.is_initialized() or dist.get_rank() == 0


def _host_copy(leaf) -> np.ndarray:
    """A numpy copy that owns its memory; bf16 widened to float32."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)
        try:
            return t.numpy()
        except TypeError:       # bf16, fp8: numpy has no such dtype
            return t.float().numpy()
    arr = np.array(leaf, copy=True)
    if arr.dtype.kind not in "fiub":
        arr = arr.astype(np.float32)
    return arr


def _flatten(tree) -> Optional[dict[str, np.ndarray]]:
    """The writer's host copy of every leaf by path; None on the other
    ranks, which take part in each DTensor leaf's gather and copy
    nothing."""
    writer = _writer()
    flat = {}
    for path, leaf in _leaves_with_path(tree):
        leaf = full_value(leaf)
        if writer:
            flat["/".join(path)] = _host_copy(leaf)
    return flat if writer else None


def _local_part(full: torch.Tensor, like: DTensor) -> torch.Tensor:
    """This rank's part of ``full`` as ``like`` is placed: cut along each
    sharded mesh dim in turn, as ``distribute_tensor`` cuts
    (``torch.chunk``; a rank past the last chunk holds an empty one)."""
    mesh = like.device_mesh
    coord = mesh.get_coordinate()
    for i, pl in enumerate(like.placements):
        if pl.is_shard():
            chunks = torch.chunk(full, mesh.size(i), dim=pl.dim)
            full = (chunks[coord[i]] if coord[i] < len(chunks)
                    else full.narrow(pl.dim, 0, 0))
        elif not pl.is_replicate():
            raise ValueError(f"cannot restore into a {pl} placement")
    return full

def save_checkpoint(directory: str, step: int, tree: Any,
                    extra: Optional[dict] = None,
                    async_: bool = False) -> threading.Thread | None:
    """Save a tree of tensors.  Returns the writer thread if ``async_``;
    either way the tree has been copied to host memory when this
    returns.  Every rank calls it (DTensor leaves are gathered); only
    rank 0 writes."""
    flat = _flatten(tree)
    if flat is None:
        return None
    os.makedirs(directory, exist_ok=True)
    tmp = os.path.join(directory, f"step_{step}.tmp")
    final = os.path.join(directory, f"step_{step}")

    def write():
        os.makedirs(tmp, exist_ok=True)
        np.savez(os.path.join(tmp, "arrays.npz"), **flat)
        meta = {"step": step, "extra": extra or {}}
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump(meta, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)

    if async_:
        t = threading.Thread(target=write, daemon=True)
        t.start()
        return t
    write()
    return None


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(directory)
             if d.startswith("step_") and not d.endswith(".tmp")]
    return max(steps) if steps else None


def restore_checkpoint(directory: str, target_tree: Any,
                       step: Optional[int] = None) -> tuple[int, Any]:
    """Restore into the structure of ``target_tree``: each leaf takes the
    target leaf's dtype, device and (for a DTensor) placement."""
    step = step if step is not None else latest_step(directory)
    if step is None:
        raise FileNotFoundError(f"no checkpoint in {directory}")
    path = os.path.join(directory, f"step_{step}")
    new_leaves = []
    with np.load(os.path.join(path, "arrays.npz")) as data:
        for kpath, leaf in _leaves_with_path(target_tree):
            key = "/".join(kpath)
            arr = data[key]
            if arr.shape != tuple(leaf.shape):
                raise ValueError(f"shape mismatch for {key}: "
                                 f"{arr.shape} vs {tuple(leaf.shape)}")
            t = torch.from_numpy(arr)
            if isinstance(leaf, DTensor):
                # only this rank's part leaves the host
                t = DTensor.from_local(
                    _local_part(t, leaf).to(device=leaf.device,
                                            dtype=leaf.dtype, copy=True),
                    leaf.device_mesh, leaf.placements, run_check=False,
                    shape=leaf.shape, stride=leaf.stride())
            else:
                # a fresh torch allocation (copy=True): the loaded array's
                # alignment could change how CPU kernels block their sums
                t = t.to(device=leaf.device, dtype=leaf.dtype, copy=True)
            new_leaves.append(t)
    return step, _unflatten(target_tree, iter(new_leaves))


class CheckpointManager:
    """Keeps the last ``keep`` checkpoints; async save with join-on-exit."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        self._pending: Optional[threading.Thread] = None

    def save(self, step: int, tree: Any, extra: Optional[dict] = None):
        self.wait()
        # prune BEFORE the async write starts: keep (keep-1) existing steps,
        # the in-flight step becomes the keep-th.
        if _writer():
            self._prune(margin=1)
        self._pending = save_checkpoint(self.directory, step, tree,
                                        extra=extra, async_=True)

    def wait(self):
        if self._pending is not None:
            self._pending.join()
            self._pending = None

    def restore(self, target_tree, step=None):
        return restore_checkpoint(self.directory, target_tree, step=step)

    def latest_step(self):
        return latest_step(self.directory)

    def _prune(self, margin: int = 0):
        if not os.path.isdir(self.directory):
            return
        steps = sorted(int(d.split("_")[1]) for d in os.listdir(self.directory)
                       if d.startswith("step_") and not d.endswith(".tmp"))
        for s in steps[: max(0, len(steps) - (self.keep - margin))]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s}"),
                          ignore_errors=True)
