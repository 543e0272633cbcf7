"""Tensor- and expert-parallel compute on a mesh's "model" axis for the
train and prefill cells of the transformer LM families (dense, moe and
the vlm's LM) and of the hybrid family (ROADMAP C.16; port-only, the
reference leaves it to GSPMD).

`model_split` plans it, and the cell then runs the port's model code on
each rank's parameter shards (``DTensor.to_local``), as plain tensors,
with a *local* ``ModelConfig``: ``n_heads``, ``n_kv``, ``d_ff`` and, when
``param_specs`` splits it, the vocabulary divided as the specs placed
them.  The model code calls this module at a few explicit points
(``tp=`` arguments in `models.modules` and `models.transformer`); with
``tp=None`` none of them runs and the code is the plain model's.

* Megatron's pair of autograd functions: `ModelSplit.enter` (identity
  forward, all-reduce backward) before every column-parallel product,
  `ModelSplit.leave` (all-reduce forward, identity backward) after every
  row-parallel one.  A block makes one all-reduce a pass after
  ``attn/wo`` and one after its FFN (``ffn/wo``, or the whole MoE layer).
* Expert parallelism for the moe family.  ``param_specs`` shards the
  stacked ``moe/w[ig]`` and ``moe/wo`` over their expert dimension, so
  the rank at coordinate i holds experts [i·E/M, (i + 1)·E/M)
  (``experts``).  Its MoE layer (`models.moe.moe_apply`) routes every
  token of its data share with the whole (replicated) router, over all
  E experts, and computes only its own experts' slots; each token sums
  its kept assignments to those experts, the shared expert adds its
  column/row-parallel part, and one `leave` sums the ranks' parts.  The
  local config keeps ``n_experts`` and ``d_ff`` whole: the capacity and
  the expert width are the global ones.  The load-balance loss is whole
  on every rank; `ModelSplit.once` gives it 1 / M of its gradient on
  each, so that the sums over "model" (the ``enter`` before the layer,
  the router's ``sum_over_model``) count it once.
* The KV-group rule.  ``wq``'s columns are ordered (kv, group, dh), so
  when M divides ``n_kv`` a rank holds whole KV groups and everything it
  needs is local.  When M > ``n_kv`` (qwen3-0.6b's 8 KV heads on 16
  ranks), the r = M / ``n_kv`` ranks that share a group (the group's
  "share" ranks, consecutive on the axis) each gather the group's
  columns of ``wq``, ``wk`` and ``wv`` from one another
  (`gather_last`: an all-gather of 1 / ``n_kv`` of each weight
  forward, a reduce-scatter of its gradient backward).  Each then
  computes the whole group's query (the landmark query pools all of the
  group's heads when ``landmark_per_group``) and the group's K / V, which
  GSPMD also replicates, but attends and multiplies by ``wo`` only for
  its own heads, the ``wo`` rows it holds (``own``).  Other splits
  (M neither dividing nor a multiple of ``n_kv``, or a group of heads
  that r does not divide) are not planned: the cell gathers once.
* Replicated leaves inside the split region (``q_norm``, ``k_norm``,
  ``moe/router``) get a partial gradient on each rank; ``sum_over_model``
  marks them and the train cell sums them over "model" before placing
  them.  Leaves outside it (the norms on the residual stream, a
  replicated embedding) get the whole gradient on every rank.
* The hybrid family (`models.rglru`): its attention blocks and FFNs take
  the dense plan (recurrentgemma-9b is MQA, so on M ranks the KV-group
  rule has r = M: every rank gathers all of wq, wk and wv and computes
  the whole query).  An RG-LRU block splits the recurrent width into M
  contiguous blocks of channels, the same for every leaf (``_REC``):
  ``enter`` before ``w_gate`` / ``w_in``, the conv, gate biases, decay
  and scan on the rank's channels, ``leave`` after ``w_out``.  The gate
  products multiply the conv output by column shards of the whole
  ``w_a`` / ``w_x``, so they take every channel of it: one all-gather
  of ``xc`` over "model" a block forward (`ModelSplit.gather`), a
  reduce-scatter of its gradient backward; the gated input uses the
  rank's own channels.  The recurrence itself needs no communication.
* The VLM's image embeddings overwrite the first positions after the
  (vocabulary-parallel) lookup; they are the rank's data rows, the same
  on every "model" rank, so the plan is the dense family's.
* A vocabulary-parallel embedding, head and cross-entropy where
  ``emb/tok`` is ``P("model", None)`` (and ``emb/head`` ``P(None,
  "model")``): the lookup masks the ids outside the rank's rows and
  all-reduces; the loss all-reduces the max, then the sum of
  exponentials, then the target logit, so the [B·N, V] float32 logits
  are never formed whole.  A vocabulary the axis does not divide is
  replicated by the specs, and then embedding, head and loss are the
  plain ones on every rank.
* Prefill outputs (last logits split over the vocabulary, decode states
  split over KV heads) are assembled into the cell's placements with one
  all-to-all a leaf (`ModelSplit.assemble`).

Collectives are the functional ones (``_c10d_functional``), which the dry
run's counter records with this file's line as their source.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
import torch.distributed as dist
import torch.distributed._functional_collectives as funcol
from torch.distributed.tensor import Replicate, Shard

from repro_torch.distributed.sharding import axis_sizes

# the placement on "model" of the parameters a split cell computes on,
# by the path under a block: the attention, and the dense FFN or the MoE
# layer (experts over their stacked dimension, the shared expert as a
# dense FFN, a replicated router)
_ATTN = {"attn/wq": Shard(2), "attn/wk": Shard(2), "attn/wv": Shard(2),
         "attn/wo": Shard(1)}
_FFN = {"ffn/wi": Shard(2), "ffn/wg": Shard(2), "ffn/wo": Shard(1)}
_MOE = {"moe/wi": Shard(1), "moe/wg": Shard(1), "moe/wo": Shard(1),
        "moe/router": Replicate()}
_SHARED = {"moe/shared/wi": Shard(2), "moe/shared/wg": Shard(2),
           "moe/shared/wo": Shard(1)}
# the hybrid family's RG-LRU blocks: the recurrent width over "model", in
# the same contiguous blocks for every leaf (columns of the projections
# in and of the gate weights, channels of the conv and the gate
# vectors), the rows of w_out
_REC = {"w_in": Shard(2), "w_gate": Shard(2), "w_a": Shard(2),
        "w_x": Shard(2), "conv": Shard(2), "b_a": Shard(1), "b_x": Shard(1),
        "lam": Shard(1), "w_out": Shard(1)}


def _all_reduce(x: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    return funcol.wait_tensor(funcol.all_reduce(x.contiguous(), op, group))


class _Enter(torch.autograd.Function):
    """Identity forward, gradient summed over the group backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _Leave(torch.autograd.Function):
    """Sum over the group forward, identity backward (every rank's
    downstream loss is the same, so each gets the whole gradient)."""

    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Once(torch.autograd.Function):
    """Identity forward, gradient divided by the group's size backward."""

    @staticmethod
    def forward(ctx, x, size):
        ctx.size = size
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g / ctx.size, None


class _GatherLast(torch.autograd.Function):
    """All-gather of the last dimension over the group forward, the
    gradient reduce-scattered back backward: a weight's columns (the
    KV-group rule) or an activation's channels (the RG-LRU's gates)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        x = x.movedim(-1, 0).contiguous()
        n = group.size()
        if x.is_cuda and dist.get_backend(group) == "gloo":
            # gloo cannot all-gather cuda tensors (a segfault, PyTorch
            # 2.11): every rank sends x to every rank with one
            # all-to-all, the same bytes.  Its only user is chip_smoke.py's
            # 1 x 2 pair of processes on one card (NCCL runs no two ranks
            # on one device); remove it once that check runs elsewhere
            rows = [x.shape[0]] * n
            out = funcol.wait_tensor(funcol.all_to_all_single(
                x.repeat((n,) + (1,) * (x.dim() - 1)), rows, rows, group))
        else:
            c10d = torch.ops._c10d_functional
            out = c10d.wait_tensor(c10d.all_gather_into_tensor(
                x, n, group.group_name))
        return out.movedim(0, -1)

    @staticmethod
    def backward(ctx, g):
        c10d = torch.ops._c10d_functional
        out = c10d.wait_tensor(c10d.reduce_scatter_tensor(
            g.movedim(-1, 0).contiguous(), "sum", ctx.group.size(),
            ctx.group.group_name))
        return out.movedim(0, -1), None


def gather_last(x: torch.Tensor, group) -> torch.Tensor:
    """``x``'s last dimension gathered from the group's ranks in order (a
    differentiable all-gather): a KV group's columns of a weight from the
    ranks that share the group, or every channel of an activation split
    over "model"."""
    return _GatherLast.apply(x, group)


@dataclasses.dataclass
class ModelSplit:
    """How one rank computes a cell with the "model" axis split
    (`model_split` builds it)."""
    cfg: Any                       # the local ModelConfig
    group: Any                     # the "model" axis's process group
    size: int                      # M
    index: int                     # this rank's coordinate on the axis
    share: int = 1                 # r: ranks that share a KV group
    share_group: Any = None        # those r ranks (None when r == 1)
    own: Optional[slice] = None    # this rank's heads of its group (r > 1)
    vocab: Optional[tuple] = None  # (first id, count) of its classes
    experts: Optional[tuple] = None  # (first expert, count) of its experts
    sum_over_model: Any = None     # tree of bools like the parameters

    def enter(self, x: torch.Tensor) -> torch.Tensor:
        """Before a column-parallel product."""
        return _Enter.apply(x, self.group)

    def leave(self, x: torch.Tensor) -> torch.Tensor:
        """After a row-parallel product: the sum of the ranks' parts."""
        return _Leave.apply(x, self.group)

    def once(self, x: torch.Tensor) -> torch.Tensor:
        """A term every rank computes whole from replicated inputs (the
        MoE load-balance loss): the same value, 1 / M of its gradient on
        each rank, so that the gradient sums over "model" count it
        once."""
        return _Once.apply(x, self.size)

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` summed over the "model" ranks (no gradient)."""
        return _all_reduce(x, self.group)

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's channels of ``x`` (its last dimension split over
        "model" in order): an all-gather forward, the gradient
        reduce-scattered backward (`gather_last`)."""
        return gather_last(x, self.group)

    def group_weights(self, params: dict) -> dict:
        """The attention projections this rank computes with: its shards,
        or with r > 1 its KV group's columns of wq, wk and wv."""
        if self.share_group is None:
            return params
        out = dict(params)
        for k in ("wq", "wk", "wv"):
            out[k] = gather_last(params[k], self.share_group)
        return out

    # ---------------------------------------------- vocabulary parallel --

    def embed(self, tok: torch.Tensor, tokens: torch.Tensor,
              dtype) -> torch.Tensor:
        """Rows of ``tokens`` from ``tok``, this rank's classes only where
        the vocabulary is split (the others zero), summed over "model"."""
        ids = tokens.long()
        if self.vocab is None:
            return tok[ids].to(dtype)
        lo, n = self.vocab
        loc = ids - lo
        ok = (loc >= 0) & (loc < n)
        rows = tok[loc.clamp(0, n - 1)]
        return self.leave(torch.where(ok[..., None], rows,
                                      torch.zeros((), dtype=rows.dtype,
                                                  device=rows.device))
                          .to(dtype))

    def nll(self, logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        """Per-token negative log-likelihood from this rank's float32
        logits [..., V / M]: log-sum-exp over every rank's classes (max,
        then sum of exponentials, over "model") minus the target's
        logit, which one rank holds."""
        lo, n = self.vocab
        m = _all_reduce(logits.detach().amax(dim=-1), self.group, "max")
        s = self.leave(torch.exp(logits - m[..., None]).sum(dim=-1))
        loc = labels.long() - lo
        ok = (loc >= 0) & (loc < n)
        t = torch.gather(logits, -1, loc.clamp(0, n - 1)[..., None])[..., 0]
        t = self.leave(torch.where(ok, t, torch.zeros((), dtype=t.dtype,
                                                      device=t.device)))
        return torch.log(s) + m - t

    # ---------------------------------------------------- prefill outputs --

    def assemble(self, x: torch.Tensor, dim: int, placement,
                 dup: int = 1) -> torch.Tensor:
        """This rank's part, under ``placement`` on the "model" axis, of a
        tensor whose dimension ``dim`` is split over the axis's ranks in
        order, each part held by ``dup`` consecutive ranks (``x`` is this
        rank's part): the whole tensor for ``Replicate``, its chunk of
        another dimension ``d`` for ``Shard(d)``.  One all-to-all over
        "model": each rank receives every part once, already cut to its
        chunk."""
        size, me = self.size, self.index
        dim %= x.dim()
        d = placement.dim % x.dim() if isinstance(placement, Shard) else None
        if d == dim:
            raise ValueError(f"a placement split over dimension {dim}, "
                             "which the parts split")
        flags = x.dtype == torch.bool
        if flags:
            x = x.view(torch.uint8)

        def part(i):
            return x if d is None else x.chunk(size, dim=d)[i]

        mine = part(me)
        pieces = [part(i).reshape(-1) if i % dup == me % dup
                  else x.new_empty(0) for i in range(size)]
        recv_n = [mine.numel() if i % dup == me % dup else 0
                  for i in range(size)]
        got = funcol.wait_tensor(funcol.all_to_all_single(
            torch.cat(pieces), recv_n, [p.numel() for p in pieces],
            self.group))
        whole = torch.cat([p.reshape(mine.shape)
                           for p in got.split([n for n in recv_n if n])],
                          dim=dim)
        return whole.view(torch.bool) if flags else whole


def _model_placement(pls, mesh):
    return pls[mesh.mesh_dim_names.index("model")]


def _share_groups(mesh, share: int):
    """The process group of this rank's ``share`` consecutive ranks on
    the "model" axis.  Every rank makes every such group, in one order
    (``new_group`` is called by all ranks of the default group)."""
    ranks = mesh.mesh
    m_dim = mesh.mesh_dim_names.index("model")
    rows = torch.movedim(ranks, m_dim, -1).reshape(-1, ranks.shape[m_dim])
    me = dist.get_rank()
    mine = None
    for row in rows.tolist():
        for i in range(0, len(row), share):
            ids = row[i:i + share]
            g = dist.new_group(ids)
            if me in ids:
                mine = g
    return mine


def _at(tree, path: str):
    for key in path.split("/"):
        tree = tree[key]
    return tree


def model_split(family: str, cfg, mesh, param_placements) -> \
        Optional[ModelSplit]:
    """The plan of a dense, moe, vlm or hybrid cell on ``mesh`` whose
    "model" axis has M > 1 ranks, given the cell's parameter placements
    (`distributed.sharding.tree_shardings` of ``param_specs``), or None:
    another family, M = 1, or a split this module does not plan (the
    module docstring; for the moe family, experts or a shared expert
    that the specs replicate because M does not divide them; any leaf
    of a hybrid super-block placed otherwise), where the cell gathers
    the parameters once instead."""
    m = axis_sizes(mesh).get("model", 1)
    if family not in ("dense", "moe", "vlm", "hybrid") or m == 1:
        return None
    moe, hybrid = family == "moe", family == "hybrid"
    h, kv = cfg.n_heads, cfg.n_kv
    if h % m or (not moe and cfg.d_ff % m) or (hybrid and cfg.d_model % m):
        return None
    if kv % m == 0:
        share = 1
    elif m % kv == 0 and cfg.group % (m // kv) == 0:
        share = m // kv
    else:
        return None
    if hybrid:
        # (RG-LRU, RG-LRU, attention + FFN) and the FFN after the first
        # RG-LRU block, stacked under "supers"
        blocks = param_placements["supers"]
        want = {f"attn_blk/{k}": v for k, v in {**_ATTN, **_FFN}.items()}
        want.update({f"ffn1/{k[4:]}": v for k, v in _FFN.items()})
        want.update({f"{r}/{k}": v for r in ("rec1", "rec2")
                     for k, v in _REC.items()})
    else:
        blocks = param_placements["blocks"]
        want = dict(_ATTN)
        want.update(_MOE if moe else _FFN)
        if moe and "shared" in blocks["moe"]:
            want.update(_SHARED)
    for path, pl in want.items():
        if _model_placement(_at(blocks, path), mesh) != pl:
            return None
    emb = param_placements["emb"]
    tok = _model_placement(emb["tok"], mesh)
    head = _model_placement(emb["head"], mesh) if "head" in emb else None
    vocab_split = tok == Shard(0)
    if head is not None and vocab_split != (head == Shard(1)):
        return None
    index = mesh.get_coordinate()[mesh.mesh_dim_names.index("model")]
    vl = cfg.vocab // m if vocab_split else cfg.vocab
    hl = h // m
    local = dataclasses.replace(
        cfg, head_dim=cfg.dh, n_heads=hl if share == 1 else cfg.group,
        n_kv=kv // m if share == 1 else 1,
        d_ff=cfg.d_ff if moe else cfg.d_ff // m, vocab=vl)
    own = None
    if share > 1:
        s = index % share
        own = slice(s * hl, (s + 1) * hl)
    el = cfg.n_experts // m

    def summed(tree, path=""):
        # replicated leaves of the attention, FFN and MoE layer (q_norm,
        # k_norm, the router)
        if isinstance(tree, dict):
            return {k: summed(v, f"{path}/{k}") for k, v in tree.items()}
        return any(f"/{sub}/" in path for sub in ("attn", "ffn", "moe")) \
            and not isinstance(_model_placement(tree, mesh), Shard)

    return ModelSplit(
        cfg=local, group=mesh.get_group("model"), size=m, index=index,
        share=share, share_group=_share_groups(mesh, share) if share > 1
        else None, own=own, vocab=(index * vl, vl) if vocab_split else None,
        experts=(index * el, el) if moe else None,
        sum_over_model=summed(param_placements))


__all__ = ["ModelSplit", "model_split", "gather_last"]
