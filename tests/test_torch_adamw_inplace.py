"""AdamW in place (`optim.adamw.adamw_update_`) and the train steps that
donate their parameters and moments to it (ROADMAP C.21), on the CPU.

* `adamw_update_` is bit-equal to the functional `adamw_update` over
  several steps: float32 and bf16 parameters, a stacked leaf updated in
  slices of its leading dimension (a small ``UPDATE_CHUNK``), a scalar leaf,
  with clipping active and inactive; it writes the trees it is given
  and returns them.
* `train_step` (in place) is bit-equal to the functional step
  (`accumulate_grads` + `adamw_update` on cloned inputs) for a family of
  each kind, with one and with two microbatches.
* `sharded_train_step` on 1 x 1 and 2 x 2 ``gloo`` worlds is bit-equal to
  the functional form of the same step on cloned inputs
  (`_torch_dist_checks.functional_sharded_step`: the gradients placed
  as a whole tree, then `adamw_update` on the DTensors).
* A dry-run trace of a train cell whose weights dominate its memory (a
  smoke config with a large stacked FFN and a tiny batch) peaks at
  about four times the float32 parameter bytes (parameters, two
  moments, one gradient copy) plus a layer's slice and the
  activations, where the functional update held about eight.
"""

import dataclasses
import os
import sys

import pytest
import torch
import torch.distributed as dist

from repro_torch.configs.registry import ShapeSpec, get_arch
from repro_torch.data import DataConfig
from repro_torch.device import cpu_log_ready
from repro_torch.launch import dryrun as dr
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.steps import family_fns, train_step
from repro_torch.launch.train import train_batch
from repro_torch.optim import OptConfig, adamw_init, adamw_update
from repro_torch.optim import adamw as adamw_mod
from repro_torch.optim.adamw import adamw_update_, tree_leaves, tree_map
from repro_torch.optim.grads import accumulate_grads

sys.path.insert(0, os.path.dirname(__file__))
import _torch_dist_checks as chk  # noqa: E402

SEQ = 32


def _clone(tree):
    return tree_map(torch.clone, tree)


def _bits_equal(a, b) -> bool:
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and x.shape == y.shape and torch.equal(x, y)
        for x, y in zip(la, lb))


def _tree(dtype, seed: int):
    g = torch.Generator().manual_seed(seed)

    def r(*shape):
        return torch.randn(size=shape, generator=g).to(dtype)

    return {"blocks": {"w": r(5, 3, 7), "ln": r(5, 7)},
            "emb": {"tok": r(11, 7)}, "bias": r(7), "scale": r()}


@pytest.mark.parametrize("clip", ["inactive", "active"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_adamw_update_in_place_bit_equal(dtype, clip, monkeypatch):
    monkeypatch.setattr(adamw_mod, "UPDATE_CHUNK", 7)
    cfg = OptConfig(lr=1e-2, warmup_steps=2, total_steps=8,
                    clip_norm=1e6 if clip == "inactive" else 0.5)
    p_ref = _tree(dtype, 0)
    s_ref = adamw_init(p_ref)
    p, s = _clone(p_ref), adamw_init(p_ref)
    for step in range(4):
        grads = _tree(dtype, 10 + step)
        p_ref, s_ref, m_ref = adamw_update(grads, s_ref, p_ref, cfg)
        ids = [id(t) for t in tree_leaves({"p": p, "mu": s.mu, "nu": s.nu})]
        out_p, out_s, m = adamw_update_(_clone(grads), s, p, cfg)
        assert [id(t) for t in tree_leaves(
            {"p": out_p, "mu": out_s.mu, "nu": out_s.nu})] == ids
        assert _bits_equal(p, p_ref) and _bits_equal(s.mu, s_ref.mu)
        assert _bits_equal(s.nu, s_ref.nu)
        assert int(s.step) == int(s_ref.step) == step + 1
        assert torch.equal(m["lr"], m_ref["lr"])
        assert torch.equal(m["grad_norm"], m_ref["grad_norm"])
        scale = float(m["grad_norm"])
        assert (scale > cfg.clip_norm) == (clip == "active")


def test_adamw_update_in_place_clips_the_gradients_it_is_given():
    cfg = OptConfig(clip_norm=0.5)
    p = _tree(torch.float32, 0)
    g = _tree(torch.float32, 1)
    keep = _clone(g)
    _, _, m = adamw_update_(g, adamw_init(p), p, cfg)
    scale = adamw_mod._clip_scale(m["grad_norm"], cfg.clip_norm)
    assert float(scale) < 1
    assert _bits_equal(g, tree_map(lambda t: t * scale, keep))


def _functional_step(params, opt, batch, loss_fn, cfg, microbatch):
    loss, grads = accumulate_grads(params, batch, loss_fn, microbatch)
    p, o, met = adamw_update(grads, opt, params, cfg)
    met["loss"] = loss
    return p, o, met


@pytest.mark.parametrize("microbatch", [1, 2])
@pytest.mark.parametrize("arch_id", ["qwen3-0.6b", "deepseek-moe-16b",
                                     "mamba2-370m", "recurrentgemma-9b"])
def test_train_step_in_place_bit_equal(arch_id, microbatch):
    arch = get_arch(arch_id, smoke=True)
    fns = family_fns(arch)
    cfg = OptConfig(lr=1e-3, warmup_steps=2, total_steps=10)
    p_ref = fns["init"](torch.Generator().manual_seed(0), "cpu")
    o_ref = adamw_init(p_ref)
    p, o = _clone(p_ref), adamw_init(p_ref)
    dcfg = DataConfig(vocab=arch.model.vocab, seq_len=SEQ, global_batch=4)
    for step in range(2):
        batch = train_batch(arch, dcfg, step)
        p_ref, o_ref, m_ref = _functional_step(p_ref, o_ref, batch,
                                               fns["loss"], cfg, microbatch)
        p, o, m = train_step(p, o, batch, fns["loss"], cfg, microbatch)
        for k in ("loss", "lr", "grad_norm"):
            assert torch.equal(m[k], m_ref[k]), (step, k)
    assert _bits_equal(p, p_ref) and _bits_equal(o.mu, o_ref.mu)
    assert _bits_equal(o.nu, o_ref.nu) and torch.equal(o.step, o_ref.step)


@pytest.fixture(scope="module")
def sharded_worlds(tmp_path_factory):
    out = tmp_path_factory.mktemp("inplace")
    res = {}
    for name, (d, m) in (("1x1", (1, 1)), ("2x2", (2, 2))):
        chk.spawn(chk.world_in_place, d * m, d, m, str(out))
        res[name] = torch.load(out / f"inplace_{d}x{m}.pt",
                               weights_only=False)
    return res


@pytest.mark.parametrize("arch_id", chk.IN_PLACE_ARCHS)
@pytest.mark.parametrize("world", ["1x1", "2x2"])
def test_sharded_train_step_in_place_bit_equal(sharded_worlds, world,
                                               arch_id):
    for rank, r in enumerate(sharded_worlds[world]):
        assert r[arch_id] == {"params": True, "mu": True, "nu": True,
                              "step": True, "metrics": True,
                              "in_place": True}, rank


def _wide_arch():
    """A smoke qwen3 whose stacked FFN dominates its memory: 8 layers of
    d 64, d_ff 4096 (three [8, 64, 4096] leaves, 24 MiB of the ~24.4 MiB
    of float32 parameters), batch 1 x 16 (activations well under a
    layer's slice)."""
    arch = get_arch("qwen3-0.6b", smoke=True)
    return dataclasses.replace(arch, model=dataclasses.replace(
        arch.model, n_layers=8, d_model=64, n_heads=2, n_kv=1, head_dim=32,
        d_ff=4096, vocab=256, remat=True))


def test_traced_train_cell_holds_four_weights_not_eight(monkeypatch):
    """The update's slices are one layer of the FFN stack here (1 MiB), as
    ``UPDATE_CHUNK`` makes them a layer or less of a full-size model.  The
    bound: the parameters, two moments and one gradient copy (4x), plus
    what the backward holds beside them: the backward of each layer's
    view of a stacked leaf (`transformer.layer_params`) writes a zero
    tensor of the whole stack and adds it to the stack's gradient (two
    stack-sized temporaries, ROADMAP's dry-run limits), plus the update's
    temporaries (six slices).  The functional update held 9.3x."""
    arch = _wide_arch()
    layer = 64 * 4096
    monkeypatch.setattr(adamw_mod, "UPDATE_CHUNK", layer)
    cpu_log_ready()
    dr.join_fake_group(1)
    try:
        mesh = make_host_mesh(1, 1, device_type=dr.trace_device())
        counts = dr._measure(arch, ShapeSpec("t", "train", 16, 1), mesh)
    finally:
        dist.destroy_process_group()
    params = family_fns(arch)["init"](torch.Generator().manual_seed(0),
                                      "meta")
    weights = sum(4 * t.numel() for t in tree_leaves(params))
    stack = 4 * arch.model.n_layers * layer
    assert counts.argument_bytes >= 3 * weights
    assert 4 * weights <= counts.peak_bytes \
        <= 4 * weights + 2 * stack + 6 * 4 * layer, \
        counts.peak_bytes / weights
    assert counts.peak_bytes < 5 * weights
