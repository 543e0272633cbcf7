"""Logical-axis sharding rules: parameter, batch and decode-state trees ->
partition specs -> DTensor placements (port of
``repro.distributed.sharding``).

Parallelism map, as in the reference:
  * DP  -- batch over ("pod", "data").
  * TP  -- attention heads / FFN hidden / vocab over "model" (column-
          parallel in-projections, row-parallel out-projections).
  * EP  -- MoE expert dim over "model".
  * SP  -- sequence over "data" (+"model" for decode caches) when the
          batch axis is too small to shard.

Rules match the ``/``-joined path of a leaf (dict keys, NamedTuple field
names and sequence indices, as `checkpoint.manager` joins them and as the
reference's ``_path_str`` gives dict keys).  A leaf under a stacked root
(``blocks``, ``supers``, ``enc``, ``dec``) gets ``None`` for its leading
layer axis.  A dimension that a rule shards but the mesh axis does not
divide replicates the whole leaf, and unmatched leaves replicate.

A spec is a `P`: a tuple of mesh-axis names, ``None`` and tuples of names,
one entry a tensor dimension, equal as a tuple to the reference's
``PartitionSpec``.  `tree_shardings` turns specs into DTensor placements.
A mesh is a ``torch.distributed.device_mesh.DeviceMesh``; the spec
functions read only its ``mesh_dim_names`` and ``shape``, so anything
with those two attributes (a mesh described, not built) serves them too.
In this port the "model" axis partitions the storage of parameters,
gradients and optimizer moments everywhere, and the compute of the
train and prefill cells of the dense and moe families and of the vlm's
LM (`distributed.tensor_parallel`); the other cells gather the
parameters (`launch.steps`, ROADMAP C.16).
"""

from __future__ import annotations

import math
import re
from typing import Any, Callable

from torch.distributed.tensor import Replicate, Shard


class P(tuple):
    """A partition spec: ``P("model", None)``; entries are axis names,
    ``None`` or tuples of names (a dimension split over several axes).  As
    in JAX, a tuple of one name is that name and an empty tuple is
    ``None``."""

    def __new__(cls, *entries):
        def canon(e):
            if isinstance(e, tuple) and len(e) <= 1:
                return e[0] if e else None
            return e
        return super().__new__(cls, map(canon, entries))

    def __repr__(self):
        return "P(" + ", ".join(map(repr, self)) + ")"


# (path regex, spec WITHOUT the stacked layer dim)
PARAM_RULES: list[tuple[str, P]] = [
    # attention projections (also whisper xattn; rglru/mamba in/out)
    (r"(attn|xattn)/w[qkv]$", P(None, "model")),
    (r"(attn|xattn)/wo$", P("model", None)),
    # dense FFN: column-parallel in, row-parallel out
    (r"(ffn|ffn1|mlp|shared)/w[ig]$", P(None, "model")),
    (r"(ffn|ffn1|mlp|shared)/wo$", P("model", None)),
    (r"(mlp)/bi$", P("model")),
    # MoE experts: EP over "model"
    (r"moe/w[ig]$", P("model", None, None)),
    (r"moe/wo$", P("model", None, None)),
    (r"moe/router$", P(None, None)),
    # embeddings: vocab-sharded
    (r"emb/tok$", P("model", None)),
    (r"emb/head$", P(None, "model")),
    # recurrent blocks: recurrent width over "model"
    (r"(rec\d|.*)/(w_in|w_gate|w_a|w_x)$", P(None, "model")),
    (r"(rec\d|.*)/w_out$", P("model", None)),
    (r"conv$", P(None, "model")),
    (r"(b_a|b_x|lam)$", P("model")),
    (r"ln_y$", P("model")),
]

_STACKED_ROOTS = ("blocks", "supers", "enc", "dec")


def axis_sizes(mesh) -> dict[str, int]:
    """{axis name: size} of a mesh."""
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


def map_with_path(fn: Callable, tree: Any, path: tuple = ()) -> Any:
    """``fn(path_str, leaf)`` over nested dicts, NamedTuples, lists and
    tuples (a `P` is a leaf), keeping the structure.  The path joins dict
    keys, field names and indices with ``/``."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, path + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(map_with_path(fn, getattr(tree, f), path + (f,))
                            for f in tree._fields))
    if isinstance(tree, (list, tuple)) and not isinstance(tree, P):
        return type(tree)(map_with_path(fn, x, path + (str(i),))
                          for i, x in enumerate(tree))
    return fn("/".join(path), tree)


def spec_for_param(path_str: str, ndim: int, shape: tuple[int, ...],
                   model_size: int = 1) -> P:
    stacked = any(f"{r}/" in path_str or path_str.startswith(f"{r}/")
                  for r in _STACKED_ROOTS)
    base_ndim = ndim - 1 if stacked else ndim
    for pattern, spec in PARAM_RULES:
        if re.search(pattern, path_str):
            if len(spec) > base_ndim:
                continue
            padded = tuple(spec) + (None,) * (base_ndim - len(spec))
            # the sharded dims must divide; replicate otherwise
            dims = shape[1:] if stacked else shape
            if not all(ax is None or dims[i] % model_size == 0
                       for i, ax in enumerate(padded)):
                padded = (None,) * len(padded)
            return P(*(((None,) + padded) if stacked else padded))
    return P(*([None] * ndim))


def param_specs(params: Any, mesh) -> Any:
    """Spec tree for a parameter tree (tensors of any device, meta
    included)."""
    msize = axis_sizes(mesh).get("model", 1)
    return map_with_path(
        lambda p, x: spec_for_param(p, x.dim(), tuple(x.shape), msize),
        params)


def batch_axes(mesh) -> tuple[str, ...]:
    sizes = axis_sizes(mesh)
    return tuple(a for a in ("pod", "data") if a in sizes)


def data_size(mesh) -> int:
    sizes = axis_sizes(mesh)
    return math.prod(sizes[a] for a in batch_axes(mesh))


def batch_spec(mesh, batch: int, rank: int = 2,
               shard_seq_if_small: bool = True) -> P:
    """Spec for [B, S, ...] host batches.  If B can't be sharded (e.g.
    long-context batch 1) shard the sequence dim instead (SP)."""
    dp = batch_axes(mesh)
    if batch % data_size(mesh) == 0:
        return P(dp, *([None] * (rank - 1)))
    if shard_seq_if_small and rank >= 2:
        return P(None, dp, *([None] * (rank - 2)))
    return P(*([None] * rank))


def state_specs(state: Any, mesh, batch: int, policy: str = "seq") -> Any:
    """Specs for stacked decode-state trees [L, B, ...].

    policy="seq": KV caches ([L, B, Hkv, C, d]) shard B over the DP axes
    and the cache length C over "model" (and over DP too when B cannot
    shard); policy="dh": the trailing head/feature dim over "model"
    instead.  Leaves of rank <= 2 (step counters) and every leaf whose
    path ends in ``t`` replicate.
    """
    dp = batch_axes(mesh)
    dp_size = data_size(mesh)
    msize = axis_sizes(mesh).get("model", 1)
    b_ax = dp if batch % dp_size == 0 else None

    def spec(name, x):
        nd = x.dim()
        shape = tuple(x.shape)
        if nd <= 2:
            return P(*([None] * nd))
        axes: list = [None] * nd
        axes[1] = b_ax
        if policy == "dh":
            if shape[-1] % msize == 0 and shape[-1] >= msize:
                axes[-1] = "model"
            return P(*axes)
        seq_dim = 3 if nd >= 4 else nd - 1   # [L, B, H, C, (d)] -> C
        if nd >= 4 and shape[seq_dim] % msize == 0:
            if b_ax is None and shape[seq_dim] % (msize * dp_size) == 0:
                axes[seq_dim] = dp + ("model",)
            else:
                axes[seq_dim] = "model"
        if name.endswith("t"):
            return P(*([None] * nd))
        return P(*axes)

    return map_with_path(spec, state)


def placements(spec: P, mesh) -> list:
    """DTensor placements of one spec: for each mesh dim, ``Shard(i)``
    where tensor dim ``i`` names that axis (alone or in a tuple),
    ``Replicate()`` elsewhere.  Several mesh dims on one tensor dim shard
    it in mesh order, as a tuple entry does in the reference."""
    out = []
    for name in mesh.mesh_dim_names:
        dims = [i for i, ax in enumerate(spec)
                if ax == name or (isinstance(ax, tuple) and name in ax)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return out


def tree_shardings(spec_tree: Any, mesh) -> Any:
    """The placement list of every spec in a spec tree."""
    return map_with_path(lambda _, s: placements(s, mesh), spec_tree)


__all__ = ["P", "PARAM_RULES", "axis_sizes", "map_with_path",
           "spec_for_param", "param_specs", "batch_axes", "data_size",
           "batch_spec", "state_specs", "placements", "tree_shardings"]
