"""The expert-parallel card check's account of a router that orders a
token's picks otherwise (``chip_smoke.py``: `ep_layers`,
`_aux_router_shift`), on the CPU at smoke size.

A token whose top-K set is the same but whose first pick differs leaves
the layer's output as it was (up to float order), but the load-balance
loss counts first picks (`models.moe`), so the router's gradient moves.
Here one token's first two picks at layer 1 are swapped by hand, the
train step run with and without the swap, and:

* `ep_layers` sees no parting, one differing first pick at that layer,
  and proves it no near tie (it was forced, not rounded);
* the first moment of the stacked router at that layer moves by what
  `_aux_router_shift` predicts, to 1e-5 of the leaf's max, where the
  move itself is above 1e-4 of it.
"""

import dataclasses
import inspect
import pathlib
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from repro_torch.configs.registry import get_arch  # noqa: E402
from repro_torch.data import DataConfig  # noqa: E402
from repro_torch.launch.steps import family_fns, train_step  # noqa: E402
from repro_torch.launch.train import train_batch  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.optim import OptConfig, adamw_init  # noqa: E402
from repro_torch.optim.adamw import tree_map  # noqa: E402

LAYERS, SWAP_LAYER, SWAP_AT = 4, 1, (0, 3)


def _step(arch, params, batch, swap: bool):
    """One train step on a copy of ``params``, the routing recorded (the
    inputs and picks of each layer); with ``swap``, layer ``SWAP_LAYER``'s
    token ``SWAP_AT`` takes its first two picks (and their gates) in the
    other order, its queues rebuilt."""
    fns = family_fns(arch)
    route, inputs, picks = moe.route, [], []

    def swapped(p, tokens, cfg):
        r = route(p, tokens, cfg)
        if swap and len(picks) == SWAP_LAYER:
            idx, w = r.gate_idx.clone(), r.gate_w.clone()
            idx[SWAP_AT + ([0, 1],)] = idx[SWAP_AT + ([1, 0],)]
            w[SWAP_AT + ([0, 1],)] = w[SWAP_AT + ([1, 0],)]
            r = moe.Routing(r.gates, w, idx, r.cap, *moe._queues(
                idx.reshape(idx.shape[0], -1), cfg.n_experts))
        inputs.append(tokens.detach().float().clone())
        picks.append(r.gate_idx.clone())
        return r

    moe.route = swapped
    try:
        p = tree_map(torch.clone, params)
        _, opt, met = train_step(p, adamw_init(p), batch, fns["loss"],
                                 OptConfig())
    finally:
        moe.route = route
    return opt, met, (inputs, picks)


def test_a_swapped_first_pick_moves_the_router_as_predicted():
    arch = get_arch("deepseek-moe-16b", smoke=True)
    arch = dataclasses.replace(arch, model=dataclasses.replace(
        arch.model, compute_dtype=torch.float32, n_layers=LAYERS,
        remat=False))
    params = family_fns(arch)["init"](torch.Generator().manual_seed(0),
                                      "cpu")
    batch = train_batch(arch, DataConfig(vocab=arch.model.vocab, seq_len=64,
                                         global_batch=2), 0)
    ref, met, ref_routes = _step(arch, params, batch, False)
    got, _, got_routes = _step(arch, params, batch, True)
    router = params["blocks"]["moe"]["router"]

    layers = cs.ep_layers(router, ref_routes, got_routes, top1=True)
    assert layers["first_parting"] is None
    assert [r["top1_differ"] for r in layers["rows"]] == [
        int(i == SWAP_LAYER) for i in range(LAYERS)]
    assert list(layers["swaps"]) == [SWAP_LAYER]
    assert layers["swaps"][SWAP_LAYER]["tokens"] == [list(SWAP_AT)]
    assert layers["top1_proofs"][SWAP_LAYER]["worst_gap_over_bound"] > 1.0

    opt = OptConfig()
    scale = (1 - opt.b1) * min(1.0, opt.clip_norm
                               / float(met["grad_norm"]))
    weight = inspect.signature(tfm.lm_loss).parameters[
        "aux_weight"].default / LAYERS
    pred = cs._aux_router_shift(router[SWAP_LAYER],
                                ref_routes[0][SWAP_LAYER],
                                layers["swaps"][SWAP_LAYER], scale, weight,
                                "cpu")
    a = ref.mu["blocks"]["moe"]["router"].double()
    b = got.mu["blocks"]["moe"]["router"].double()
    top = a.abs().max().item()
    moved = (b - a)[SWAP_LAYER]
    assert moved.abs().max().item() > 1e-4 * top
    assert (moved - pred).abs().max().item() <= 1e-5 * top
