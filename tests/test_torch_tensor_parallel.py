"""Tensor- and expert-parallel compute on the "model" axis for the
transformer LM families' train and prefill cells
(`distributed.tensor_parallel`, ROADMAP C.16), on ``gloo`` worlds of
spawned CPU ranks: 1 x 2, 2 x 2 and 1 x 4 (the 1 x 4 world has more
"model" ranks than the smoke qwen3's 2 KV heads, so the KV-group rule
gathers).  The smoke qwen3-0.6b (vocabulary 251, which ``param_specs``
replicates) and a vocabulary-256 variant (split over "model"), and the
smoke deepseek-moe-16b (8 experts top-2, one shared, 4 KV heads),
dbrx-132b (no shared expert, 2 KV heads: at 1 x 4 the KV-group rule and
the expert split together) and internvl2-76b (16 image-embedding rows),
with the reference's init converted (`repro_torch.convert`).  The moe and
vlm cases (``EP_CASES``) are held to the dense ones' checks and
tolerances, and besides: each rank's stacked expert leaves hold its E /
M experts, no collective comes from the gather-once path (``launch/
steps.py`` ``_full``), and the [..., d_model] all-reduces over "model"
are exactly one a block after the attention and one after the FFN (the
MoE layer's experts and shared expert together) each pass: 2 x layers a
pass, forward and backward in the train step.

* The train cell's two steps against `train_step` in one process with
  one microbatch per data rank: loss within 1e-6 relative, every
  gradient leaf within 1e-5 of its max, parameters within AdamW's bound
  for a rounding-level gradient difference, 2 lr a step (the
  row-parallel sums add in another order; `test_torch_distributed.py`
  gives the reason); each rank's local shapes its ``param_specs`` shards.
* The prefill cell against the plain function: float leaves within 1e-5
  of each leaf's max, integer leaves (expert rows, validity, counters)
  exact, placed as ``out_shardings``.
* The collective record of the first train step and of the prefill (the
  dry run's counter over the real run): no all-gather over "model" at
  all; the only all-gathers are the KV-group rule's, over the ranks that
  share a group, each of one group's columns of wq / wk / wv, issued by
  `tensor_parallel.gather_group_columns`; every collective issued by the
  port (``repro_torch/`` source lines).
* The vocabulary-parallel cross-entropy on its own against
  `cross_entropy` over the whole vocabulary, within 1e-6: a batch with a
  label in every rank's classes, plain and masked, loss and gradient.
* The MoE layer alone under the split (`models.moe.moe_apply` with
  ``tp``) against the whole layer on the same input, with drops, for the
  losses ``out.sum()`` and the aux loss alone: output and aux within
  1e-6, the gradients of the input, the router (summed over "model"),
  the rank's expert shards and its shared-expert shards within 1e-5 of
  their max.  The aux loss is whole on every rank; without
  `ModelSplit.once` its gradient would be counted M times.
* Placing a prefill or decode output makes no tensor of its global
  shape (the dry run counted one as memory before this slice), and
  `launch.steps.contiguous_stride` is a contiguous empty's stride.
* The slice as a whole against the JAX package on one device, on the
  same converted parameters: the train cell's first loss against
  ``repro.models.transformer.lm_loss`` (1e-5 relative) and the prefill
  cell's gathered logits and decode states against its ``lm_prefill``
  (float32: atol = rtol = 1e-5, as `test_torch_models.py`; integer
  leaves exact).  The reference's own multi-device step is not an oracle
  here (ROADMAP C.3: it fails on the CPU).
"""

import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_arch as jget_arch
from repro.models import rglru as jrg
from repro.models import transformer as jtfm
from repro_torch.configs.registry import get_arch
from repro_torch.convert import params_from_jax, to_numpy
from repro_torch.data import DataConfig
from repro_torch.launch import dryrun as dr
from repro_torch.launch import steps
from repro_torch.launch.train import train_batch

sys.path.insert(0, os.path.dirname(__file__))
import _torch_dist_checks as chk  # noqa: E402
import _torch_tp_checks as tpc  # noqa: E402

LOSS_TOL, GRAD_TOL = 1e-6, 1e-5
PARAM_ABS = 2 * chk.OPT.lr * chk.STEPS
JAX_TOL = dict(atol=1e-5, rtol=1e-5)


def _jax_cfg(vocab):
    """The reference's config of a case: a vocabulary of the smoke qwen3,
    a moe / vlm architecture's smoke config, or a hybrid case's (the
    smoke recurrentgemma-9b, at a vocabulary after its ``:``)."""
    if vocab in tpc.EP_ARCHS:
        return jget_arch(vocab, smoke=True).model
    if vocab in tpc.HY_CASES:
        arch_id, _, v = vocab.partition(":")
        jc = jget_arch(arch_id, smoke=True).model
        return dataclasses.replace(jc, vocab=int(v)) if v else jc
    jc = jget_arch("qwen3-0.6b", smoke=True).model
    return dataclasses.replace(jc, vocab=vocab)


def _arch(case):
    return tpc.case_arch(case)


@pytest.fixture(scope="module")
def reference():
    """The reference's weights of every case, as JAX trees and
    converted."""
    out = {}
    for case in tpc.VOCABS + tpc.EP_ARCHS + tpc.HY_CASES:
        init = jrg.rg_init if case in tpc.HY_CASES else jtfm.lm_init
        jp = init(jax.random.PRNGKey(0), _jax_cfg(case))
        out[case] = (jp, params_from_jax(jax.device_get(jp)))
    return out


@pytest.fixture(scope="module")
def worlds(tmp_path_factory, reference):
    out = tmp_path_factory.mktemp("tp")
    path = out / "params.pt"
    torch.save({v: reference[v][1] for v in reference}, path)
    res = {}
    for name, (d, m) in tpc.WORLDS.items():
        chk.spawn(tpc.world_tp, d * m, name, str(path), str(out))
        res[name] = torch.load(out / f"{name}.pt", weights_only=False)
    return res


CASES = [(w, v) for w in tpc.WORLDS for v in tpc.VOCABS]
EP_CASES = [(w, a) for w in tpc.WORLDS for a in tpc.EP_ARCHS]
HY_CASES = [(w, c) for w in tpc.WORLDS for c in tpc.HY_CASES]


@pytest.mark.parametrize("world,vocab", CASES)
def test_train_cell_matches_train_step(worlds, world, vocab):
    for rank, r in enumerate(worlds[world]["ranks"]):
        t = r[vocab]["train"]
        assert t["loss_rel"] <= LOSS_TOL, (rank, t)
        assert t["grad_rel"] <= GRAD_TOL, (rank, t)
        assert t["param_abs"] <= PARAM_ABS, (rank, t)
        assert t["shard_shapes_bad"] == [], (rank, t)


@pytest.mark.parametrize("world,vocab", CASES)
def test_prefill_cell_matches_plain(worlds, world, vocab):
    for rank, r in enumerate(worlds[world]["ranks"]):
        assert r[vocab]["prefill"] == {"placed": True, "close": True}, rank


def _weight_gathers_ok(record, world, cfg) -> list:
    """The all-gathers of ``record`` that break the KV-group rule."""
    d, m = tpc.WORLDS[world]
    share = max(m // cfg.n_kv, 1)
    group_cols = {cfg.group * cfg.dh, cfg.dh}    # wq's, wk's / wv's
    bad = []
    for c in record:
        if c["kind"] != "all-gather":
            continue
        ok = (share > 1 and c["group"] == share
              and "tensor_parallel.py" in c["op_name"]
              and "forward" in c["op_name"]
              and c["shape"] == [c["shape"][0], cfg.d_model]
              and c["shape"][0] in group_cols)
        if not ok:
            bad.append(c)
    return bad


@pytest.mark.parametrize("world,vocab", CASES)
def test_no_whole_weight_gathered_over_model(worlds, world, vocab):
    cfg = tpc.smoke_arch(vocab).model
    res = worlds[world][vocab]
    d, m = tpc.WORLDS[world]
    for what in ("train", "prefill"):
        record = res[what]["collectives"]
        assert record and all(c["op_name"].startswith("repro_torch/")
                              for c in record), what
        assert not [c for c in record if c["kind"] == "all-gather"
                    and c["group"] == m and m > 2], what
        assert _weight_gathers_ok(record, world, cfg) == [], what
        gathers = [c for c in record if c["kind"] == "all-gather"]
        if m > cfg.n_kv:
            assert gathers, what          # the KV-group rule ran
        else:
            assert not gathers, what
        # one all-reduce a block after attn/wo and after ffn/wo, each pass
        leaves = [c for c in record if c["kind"] == "all-reduce"
                  and c["group"] == m and "tensor_parallel.py" in
                  c["op_name"] and c["shape"][-1] == cfg.d_model]
        assert len(leaves) >= 2 * cfg.n_layers, what


@pytest.mark.parametrize("world", list(tpc.WORLDS))
def test_vocab_parallel_cross_entropy(worlds, world):
    d, m = tpc.WORLDS[world]
    for rank, r in enumerate(worlds[world]["ranks"]):
        nll = r[tpc.VOCABS[0]]["nll"]
        assert nll["ranges_hit"] == list(range(m)), rank
        for case in ("plain", "masked"):
            assert nll[case]["loss_rel"] <= 1e-6, (rank, case, nll)
            assert nll[case]["grad_rel"] <= 1e-6, (rank, case, nll)


@pytest.mark.parametrize("world,vocab", CASES)
def test_slice_matches_reference(worlds, reference, world, vocab):
    """The train cell's first loss and the gathered prefill against the
    JAX package on the same weights."""
    jp, _ = reference[vocab]
    jc = _jax_cfg(vocab)
    arch = tpc.smoke_arch(vocab)
    batch = train_batch(arch, DataConfig(vocab=vocab, seq_len=tpc.SEQ,
                                         global_batch=tpc.BATCH), 0)
    want = float(jtfm.lm_loss(jp, {k: jnp.asarray(v) for k, v in
                                   batch.items()}, jc))
    res = worlds[world][vocab]
    assert abs(res["train"]["loss0"] - want) <= 1e-5 * abs(want)
    pre = res["prefill"]
    jl, jst = jtfm.lm_prefill(jp, jnp.asarray(pre["tokens"].numpy()), jc,
                              tpc.SEQ)
    np.testing.assert_allclose(pre["logits"].numpy(), np.asarray(jl),
                               **JAX_TOL)
    for f, a in to_numpy(pre["states"])._asdict().items():
        b = np.asarray(getattr(jst, f))
        if a.dtype.kind in "biu":
            np.testing.assert_array_equal(a, b, err_msg=f)
        else:
            np.testing.assert_allclose(a, b, err_msg=f, **JAX_TOL)


def _check_train(worlds, world, case):
    for rank, r in enumerate(worlds[world]["ranks"]):
        t = r[case]["train"]
        assert t["loss_rel"] <= LOSS_TOL, (rank, t)
        assert t["grad_rel"] <= GRAD_TOL, (rank, t)
        assert t["param_abs"] <= PARAM_ABS, (rank, t)
        assert t["shard_shapes_bad"] == [], (rank, t)


def _check_collectives(worlds, world, case):
    """The dense cases' collective checks, and for every case but a
    replicated-vocabulary dense one, the exact count of [..., d_model]
    all-reduces over "model": one after the attention and one after the
    FFN a block each pass, no more (no all-reduce per expert, none for
    the shared expert apart)."""
    cfg = _arch(case).model
    res = worlds[world][case]
    d, m = tpc.WORLDS[world]
    for what, passes in (("train", 2), ("prefill", 1)):
        record = res[what]["collectives"]
        assert record and all(c["op_name"].startswith("repro_torch/")
                              for c in record), what
        assert not [c for c in record
                    if dr.from_gather_once(c["op_name"])], what
        assert not [c for c in record if c["kind"] == "all-gather"
                    and c["group"] == m and m > 2], what
        assert _weight_gathers_ok(record, world, cfg) == [], what
        gathers = [c for c in record if c["kind"] == "all-gather"]
        if m > cfg.n_kv:
            assert gathers, what          # the KV-group rule ran
        else:
            assert not gathers, what
        leaves = [c for c in record if c["kind"] == "all-reduce"
                  and c["group"] == m and "tensor_parallel.py" in
                  c["op_name"] and c["shape"][-1] == cfg.d_model]
        assert len(leaves) >= 2 * cfg.n_layers, what
        if case in tpc.EP_ARCHS:          # vocabulary replicated, no remat
            assert len(leaves) == 2 * cfg.n_layers * passes, what


def _check_reference(worlds, reference, world, case):
    """The train cell's first loss and the gathered prefill against the
    JAX package on the same weights, on each data rank's share of the
    batch (an MoE's capacity groups and aux loss are a call's): the
    shares' mean loss, their prefills joined."""
    jp, _ = reference[case]
    jc = _jax_cfg(case)
    arch = _arch(case)
    d = tpc.WORLDS[world][0]

    def shares(batch):
        return [{k: jnp.asarray(np.asarray(v)[i * len(v) // d:
                                              (i + 1) * len(v) // d])
                 for k, v in batch.items()} for i in range(d)]

    want = float(np.mean([jtfm.lm_loss(jp, b, jc)
                          for b in shares(tpc.batch_at(arch, 0))]))
    res = worlds[world][case]
    assert abs(res["train"]["loss0"] - want) <= 1e-5 * abs(want)
    pre = res["prefill"]
    parts = [jtfm.lm_prefill(jp, b["tokens"], jc, tpc.SEQ,
                             extra_embeds=b.get("image_embeds"))
             for b in shares(tpc.prefill_batch(arch))]
    jl = np.concatenate([np.asarray(p[0]) for p in parts])
    jst = type(parts[0][1])(*(
        np.concatenate([np.asarray(x) for x in xs], axis=1)
        if np.ndim(xs[0]) >= 3 else np.asarray(xs[0])
        for xs in zip(*(p[1] for p in parts))))
    np.testing.assert_array_equal(pre["tokens"].numpy(),
                                  tpc.prefill_batch(arch)["tokens"].numpy())
    np.testing.assert_allclose(pre["logits"].numpy(), jl, **JAX_TOL)
    for f, a in to_numpy(pre["states"])._asdict().items():
        b = getattr(jst, f)
        if a.dtype.kind in "biu":
            np.testing.assert_array_equal(a, b, err_msg=f)
        else:
            np.testing.assert_allclose(a, b, err_msg=f, **JAX_TOL)


@pytest.mark.parametrize("world,arch_id", EP_CASES)
def test_moe_vlm_train_cell_matches_train_step(worlds, world, arch_id):
    _check_train(worlds, world, arch_id)


@pytest.mark.parametrize("world,arch_id", EP_CASES)
def test_moe_vlm_prefill_cell_matches_plain(worlds, world, arch_id):
    for rank, r in enumerate(worlds[world]["ranks"]):
        assert r[arch_id]["prefill"] == {"placed": True, "close": True}, \
            rank


@pytest.mark.parametrize("world,arch_id", EP_CASES)
def test_moe_ranks_hold_their_experts(worlds, world, arch_id):
    """Each rank's shard of ``moe/wi``, ``moe/wg`` and ``moe/wo`` holds E /
    M experts (the vlm has none)."""
    cfg = _arch(arch_id).model
    d, m = tpc.WORLDS[world]
    want = {k: cfg.n_experts // m for k in ("wi", "wg", "wo")} \
        if cfg.n_experts else {}
    for rank, r in enumerate(worlds[world]["ranks"]):
        assert r[arch_id]["train"]["experts_local"] == want, rank


@pytest.mark.parametrize("world,arch_id", EP_CASES)
def test_moe_vlm_no_whole_weight_gathered_over_model(worlds, world,
                                                      arch_id):
    _check_collectives(worlds, world, arch_id)


@pytest.mark.parametrize("world,arch_id", EP_CASES)
def test_moe_vlm_slice_matches_reference(worlds, reference, world,
                                         arch_id):
    _check_reference(worlds, reference, world, arch_id)


@pytest.mark.parametrize("world", list(tpc.WORLDS))
@pytest.mark.parametrize("loss", ["out", "aux"])
def test_moe_layer_split_matches_whole(worlds, world, loss):
    """`moe_apply` under the split against the whole layer, for
    ``out.sum()`` and the aux loss alone (the aux-loss trap)."""
    for rank, r in enumerate(worlds[world]["ranks"]):
        layer = r[tpc.VOCABS[0]]["moe_layer"]
        assert layer["dropped"] > 0, rank
        got = layer[loss]
        assert got["out_rel"] <= 1e-6 and got["aux_rel"] <= 1e-6, \
            (rank, got)
        for name, err in got["grad_rel"].items():
            assert err <= 1e-5, (rank, name, got)


@pytest.mark.parametrize("shape", [(), (0,), (3,), (2, 0, 3), (4, 1, 5),
                                   (2, 32, 8, 64, 16)])
def test_contiguous_stride(shape):
    assert steps.contiguous_stride(shape) == torch.empty(shape).stride()


def test_place_rows_counts_no_global_tensor():
    """Placing a rank's part makes no tensor of the global shape: the dry
    run counted one, a float32 empty of every prefill and decode state
    leaf's global shape, as live memory (its placement's strides)."""
    from repro_torch.launch import dryrun as dr
    from repro_torch.launch.mesh import make_host_mesh
    from torch.distributed.tensor import Replicate, Shard
    glob = (4, 1024, 1024)                     # 16 MiB of float32
    dr.join_fake_group(2)
    try:
        mesh = make_host_mesh(1, 2, device_type=dr.trace_device())
        counts = dr.trace(
            lambda x: steps.place_rows(x, mesh, [Replicate(), Shard(1)], 0,
                                       True, glob),
            lambda fm: (torch.empty(glob),))
    finally:
        torch.distributed.destroy_process_group()
    # the argument (16 MiB) and its contiguous half (8 MiB), nothing more
    assert counts.peak_bytes == 24 * 2 ** 20


# ------------------------------------------------------- the hybrid family --

def _check_hybrid_collectives(worlds, world, case):
    """The hybrid cell's collective record: every collective issued by the
    port, none from the gather-once path; the only all-gathers are the
    KV-group rule's (MQA: r = M, a group's columns of wq / wk / wv) and
    one of the conv output ``xc`` ([d_model, rows, N], over "model") a
    RG-LRU block each forward (the smoke config does not remat); the
    [..., d_model] all-reduces over "model": one after each RG-LRU block,
    each FFN and the attention, each pass (exactly, where the vocabulary
    is replicated)."""
    cfg = _arch(case).model
    d, m = tpc.WORLDS[world]
    n_super = max(1, cfg.n_layers // 3)
    for what, passes in (("train", 2), ("prefill", 1)):
        record = worlds[world][case][what]["collectives"]
        assert record and all(c["op_name"].startswith("repro_torch/")
                              for c in record), what
        assert not [c for c in record
                    if dr.from_gather_once(c["op_name"])], what
        gathers = [c for c in record if c["kind"] == "all-gather"]
        xc = [c for c in gathers if len(c["shape"]) == 3]
        weights = [c for c in gathers if len(c["shape"]) != 3]
        assert xc and all(c["group"] == m and c["shape"][0] == cfg.d_model
                          and c["shape"][1:] == [tpc.BATCH // d, tpc.SEQ]
                          and "tensor_parallel.py" in c["op_name"]
                          for c in xc), (what, xc)
        assert len(xc) == 2 * n_super, (what, len(xc))
        assert weights and _weight_gathers_ok(weights, world, cfg) == [], \
            what
        leaves = [c for c in record if c["kind"] == "all-reduce"
                  and c["group"] == m and "tensor_parallel.py" in
                  c["op_name"] and c["shape"][-1] == cfg.d_model]
        assert len(leaves) >= 5 * n_super * passes, what
        if cfg.vocab % m:                 # vocabulary replicated
            assert len(leaves) == 5 * n_super * passes, what


@pytest.mark.parametrize("world,case", HY_CASES)
def test_hybrid_train_cell_matches_train_step(worlds, world, case):
    _check_train(worlds, world, case)


@pytest.mark.parametrize("world,case", HY_CASES)
def test_hybrid_prefill_cell_matches_plain(worlds, world, case):
    for rank, r in enumerate(worlds[world]["ranks"]):
        assert r[case]["prefill"] == {"placed": True, "close": True}, rank


@pytest.mark.parametrize("world,case", HY_CASES)
def test_hybrid_no_whole_weight_gathered_over_model(worlds, world, case):
    _check_hybrid_collectives(worlds, world, case)


@pytest.mark.parametrize("world,case", HY_CASES)
def test_hybrid_slice_matches_reference(worlds, reference, world, case):
    """The train cell's first loss against ``repro.models.rglru.rg_loss``
    (1e-5 relative) and the gathered prefill's last logits against its
    ``rg_forward`` (atol = rtol = 1e-5), on the same weights."""
    jp, _ = reference[case]
    jc = _jax_cfg(case)
    arch = _arch(case)
    batch = tpc.batch_at(arch, 0)
    want = float(jrg.rg_loss(jp, {k: jnp.asarray(v) for k, v in
                                  batch.items()}, jc))
    res = worlds[world][case]
    assert abs(res["train"]["loss0"] - want) <= 1e-5 * abs(want)
    pre = res["prefill"]
    jl = jrg.rg_forward(jp, jnp.asarray(pre["tokens"].numpy()), jc)[0]
    np.testing.assert_allclose(pre["logits"].numpy(),
                               np.asarray(jl)[:, -1], **JAX_TOL)


@pytest.mark.parametrize("world", list(tpc.WORLDS))
def test_rglru_block_split_matches_whole(worlds, world):
    """`rglru_block_apply` under the split against the whole block: the
    output within 1e-6, the gradients of the input and of every leaf
    (``w_a``, ``conv`` and ``lam`` included) within 1e-5 of their max.
    Without the gather of ``xc`` before the gate products it fails."""
    for rank, r in enumerate(worlds[world]["ranks"]):
        got = r[tpc.VOCABS[0]]["rglru_block"]
        assert got["out_rel"] <= 1e-6, (rank, got)
        assert set(got["grad_rel"]) == {
            "x", "ln", "w_in", "w_gate", "conv", "w_a", "b_a", "w_x", "b_x",
            "lam", "w_out"}
        for name, err in got["grad_rel"].items():
            assert err <= 1e-5, (rank, name, got)
