"""The prefill and decode cells of `launch.steps.build_cell` on a 2 x 2
``gloo`` group of spawned CPU ranks (`test_torch_dryrun.py`).  Each rank
places the same smoke-size parameters, batch and decode states by the
cell's ``in_shardings``, calls the cell, gathers what it returns, and
holds it bit for bit to the plain function (the cell called with plain
tensors) on the gathered inputs: on the whole batch, and on each data
rank's share of it (the rows that rank computed).  Some cases are held
to a tolerance instead: the prefill of the dense, moe, vlm and hybrid
families, which computes tensor- (for the moe family also expert-)
parallel over "model" (`distributed.tensor_parallel`), so its
row-parallel sums add in another order.  Its float leaves are held
within 1e-5 of each leaf's largest magnitude (float32), its integer and
boolean leaves exactly.  This module imports torch and the port only;
rank 0 writes ``<out>/cells.pt``.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, distribute_tensor

from repro_torch.configs.registry import ShapeSpec, get_arch
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.steps import build_cell, family_fns, zip_map
from repro_torch.models import whisper as wh

ARCHS = ("qwen3-0.6b", "deepseek-moe-16b", "internvl2-76b", "mamba2-370m",
         "recurrentgemma-9b", "whisper-tiny")
SEQ, BATCH, DECODE_STEPS = 32, 4, 3
HALF = BATCH // 2          # rows of one data rank


def _place(tree, mesh, shardings):
    return zip_map(lambda t, pl: distribute_tensor(t, mesh, pl,
                                                   src_data_rank=None),
                   tree, shardings)


def _gather(tree):
    return zip_map(lambda t: t.full_tensor(), tree)


def _leaves(tree) -> list:
    out = []
    zip_map(out.append, tree)
    return out


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(-1).view(torch.uint8) if x.dtype.is_floating_point \
        else x


def _equal(a, b) -> bool:
    la, lb = _leaves(a), _leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and x.shape == y.shape
        and torch.equal(_bits(x), _bits(y)) for x, y in zip(la, lb))


FLOAT_TOL = 1e-5     # of a leaf's largest magnitude: reordered sums


def _close(a, b) -> bool:
    """Float leaves within ``FLOAT_TOL`` of each leaf's largest magnitude,
    integer and boolean leaves equal."""
    la, lb = _leaves(a), _leaves(b)

    def near(x, y):
        if not x.dtype.is_floating_point:
            return torch.equal(x, y)
        err = (x.double() - y.double()).abs().max()
        return bool(err <= FLOAT_TOL * y.double().abs().max())

    return len(la) == len(lb) and all(
        x.dtype == y.dtype and x.shape == y.shape and near(x, y)
        for x, y in zip(la, lb))


def _placed_as(tree, shardings) -> bool:
    return all(_leaves(zip_map(lambda t, pl: list(t.placements) == list(pl),
                               tree, shardings)))


def _state_share(tree, i):
    """Data rank ``i``'s rows of a decode-state tree (batch at dim 1 of
    every leaf of rank 3 or more)."""
    return zip_map(lambda t: t[:, i * HALF:(i + 1) * HALF].clone()
                   if t.dim() >= 3 else t.clone(), tree)


def _inputs(arch):
    cfg = arch.model
    g = torch.Generator().manual_seed(0)
    params = family_fns(arch)["init"](g, "cpu")
    batch = {"tokens": torch.randint(0, cfg.vocab, (BATCH, SEQ),
                                     generator=g, dtype=torch.int32)}
    if arch.family == "vlm":
        batch["image_embeds"] = torch.randn(
            BATCH, arch.n_img_tokens, cfg.d_model, generator=g)
    audio = torch.randn(BATCH, arch.t_enc, cfg.d_model, generator=g)
    return params, batch, audio


def check_prefill(arch, mesh, params, batch, audio) -> dict:
    cell = build_cell(arch, ShapeSpec("p", "prefill", SEQ, BATCH), mesh)
    psh, bsh = cell.in_shardings
    x = audio if arch.family == "encdec" else batch
    out = cell.fn(_place(params, mesh, psh), _place(x, mesh, bsh))
    got = _gather(out)
    # split over "model": the transformer LM families and the hybrid (the
    # docstring)
    same = _close if arch.family in ("dense", "moe", "vlm", "hybrid") \
        and mesh.size(1) > 1 else _equal
    share = (lambda t, i: t[i * HALF:(i + 1) * HALF])
    per_share = True
    for i in range(2):
        xi = zip_map(lambda t: share(t, i), x)
        ref = cell.fn(params, xi)
        if isinstance(got, tuple):       # (last logits, decode states)
            per_share &= same(share(got[0], i), ref[0]) \
                and same(_state_share(got[1], i), ref[1])
        else:
            per_share &= same(share(got, i), ref)
    return {"out_placed": _placed_as(out, cell.out_shardings),
            "whole_batch": same(got, cell.fn(params, x)),
            "per_share": per_share}


def check_decode(arch, mesh, params, batch, audio) -> dict:
    cell = build_cell(arch, ShapeSpec("d", "decode", SEQ, BATCH), mesh)
    psh, ssh, tsh, _ = cell.in_shardings
    if arch.family == "encdec":
        st0 = wh.whisper_init_serve(params, audio, arch.model, arch.dec_len)
    else:
        st0 = family_fns(arch)["init_states"](BATCH, SEQ, "cpu")
    p = _place(params, mesh, psh)
    st = _place(zip_map(torch.clone, st0), mesh, ssh)
    ref = zip_map(torch.clone, st0)
    shares = [_state_share(st0, i) for i in range(2)]
    ok = {"out_placed": True, "whole_batch": True, "per_share": True}
    for pos in range(DECODE_STEPS):
        tok = batch["tokens"][:, pos].contiguous()
        logits, st = cell.fn(p, st, distribute_tensor(
            tok, mesh, tsh, src_data_rank=None), pos)
        ok["out_placed"] &= _placed_as((logits, st), cell.out_shardings)
        got_l, got = logits.full_tensor(), _gather(st)
        ref_l, ref = cell.fn(params, ref, tok, pos)
        ok["whole_batch"] &= _equal(got_l, ref_l) and _equal(got, ref)
        for i in range(2):
            sl, shares[i] = cell.fn(params, shares[i],
                                    tok[i * HALF:(i + 1) * HALF], pos)
            ok["per_share"] &= _equal(got_l[i * HALF:(i + 1) * HALF], sl) \
                and _equal(_state_share(got, i), shares[i])
    return ok


def world_cells(rank, out_dir):
    torch.manual_seed(0)
    mesh = make_host_mesh(2, 2, device_type="cpu")
    res = {}
    for arch_id in ARCHS:
        arch = get_arch(arch_id, smoke=True)
        inputs = _inputs(arch)
        res[arch_id] = {"prefill": check_prefill(arch, mesh, *inputs),
                        "decode": check_decode(arch, mesh, *inputs)}
    gathered = [None] * dist.get_world_size()
    dist.all_gather_object(gathered, res)
    if rank == 0:
        torch.save(gathered, os.path.join(out_dir, "cells.pt"))
