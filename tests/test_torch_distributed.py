"""The port's distribution across ranks (CPU, ``gloo``): three worlds of
spawned processes (2 x 2, 1 x 2 and 2 x 1), each running all of its
checks in one go (`_torch_dist_checks`), then the assertions here.

* The sharded train step (``build_cell``'s train function) on 2 x 1, 1 x 2
  and 2 x 2 for qwen3-0.6b, deepseek-moe-16b, mamba2-370m and
  recurrentgemma-9b at the smoke size, two steps, against `train_step`
  in one process with one microbatch per data rank (a data-parallel step
  is that step: the MoE's capacity groups and aux loss are a call's, as
  they are a microbatch's): loss within 1e-6 relative, every gradient
  leaf within 1e-5 of its max, parameters within 1e-6 of their leaf's
  max (most come out bit for bit); each rank's local shapes are its
  ``param_specs`` shards.  Eight cases sum their gradients in another
  order than the single process: ``microbatch=2`` on 2 x 1 (against four
  microbatches), a masked batch whose ranks count different labels
  (against the whole batch's masked mean), and qwen3-0.6b,
  deepseek-moe-16b and recurrentgemma-9b on 1 x 2 and 2 x 2, whose train
  cells compute tensor- and expert-parallel over "model" (the dense, moe
  and hybrid families, `distributed.tensor_parallel`): their
  row-parallel products, the MoE layer's per-rank expert sums and the
  vocabulary-parallel loss add the ranks' parts in another order.  They
  are held to the same loss and gradient tolerances, and their
  parameters to AdamW's bound for a rounding-level gradient difference,
  2 lr a step (where a gradient element is near 0, m / sqrt(v) is near
  +-1 whatever its size; as in `test_torch_train_parity.py`).
* Elastic re-placement 2 x 2 -> 1 x 2 -> one process keeps every leaf
  bit-equal.
* Checkpoints: one written on 2 x 2 restores on 1 x 2 and in one process
  bit for bit, and the reference's ``restore_checkpoint`` reads it; only
  rank 0 copies the tree to host memory.
* The compressed reduction on 4 ranks against the reference's under
  ``shard_map`` on 4 host devices (a JAX subprocess, as
  ``tests/test_compression.py`` runs it), on the same per-rank inputs:
  int8 payloads equal, results within 1e-7 relative, error feedback
  equal.  On the wire only int8 payloads and one float32 scale per rank.
  The quantization roundtrip bound of ``tests/test_compression.py``, and
  ``dp_compressed_train_step`` lowering the loss over 20 steps on 2 ranks.
* The training CLI under ``torch.distributed.run`` at 1 x 2: the losses of
  ``--data-parallel 1 --model-parallel 1``.
"""

import json
import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch
from _hypothesis_compat import given, settings, st

import _torch_dist_checks as chk
from repro.checkpoint import restore_checkpoint as jrestore
from repro.optim.adamw import AdamWState as JAdamWState
from repro_torch import prng
from repro_torch.checkpoint import restore_checkpoint
from repro_torch.configs.registry import get_arch
from repro_torch.launch.steps import family_fns
from repro_torch.optim import adamw_init
from repro_torch.optim.adamw import tree_leaves
from repro_torch.optim.compression import dequantize_int8, quantize_int8

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
LOSS_TOL, GRAD_TOL, PARAM_TOL = 1e-6, 1e-5, 1e-6


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Runs the three worlds (2 x 2 first: it writes the checkpoint that
    1 x 2 restores) and returns {world: what its rank 0 found}."""
    out = tmp_path_factory.mktemp("worlds")
    for name, fn, n in (("2x2", chk.world_2x2, 4), ("1x2", chk.world_1x2, 2),
                        ("2x1", chk.world_2x1, 2)):
        chk.spawn(fn, n, str(out))
    res = {w: torch.load(out / f"{w}.pt", weights_only=False)
           for w in ("2x2", "1x2", "2x1")}
    res["dir"] = out
    return res


@pytest.mark.parametrize("world", ["2x1", "1x2", "2x2"])
def test_sharded_train_step_matches_single_process(worlds, world):
    runs = worlds[world]["train"]
    assert set(chk.ARCHS) <= set(runs)
    split = world != "2x1"      # a "model" axis of 2 ranks
    for arch_id, r in runs.items():
        assert r["loss_rel"] <= LOSS_TOL, (arch_id, r)
        assert r["grad_rel"] <= GRAD_TOL, (arch_id, r)
        reordered = arch_id not in chk.ARCHS or (
            split and arch_id in ("qwen3-0.6b", "deepseek-moe-16b",
                                  "recurrentgemma-9b"))
        if reordered:
            assert r["param_abs"] <= 2 * chk.OPT.lr * chk.STEPS, (arch_id, r)
        else:
            assert r["param_rel"] <= PARAM_TOL, (arch_id, r)
    if world == "2x1":
        assert {"qwen3-0.6b microbatch 2", "qwen3-0.6b masked"} <= set(runs)


@pytest.mark.parametrize("world", ["2x1", "1x2", "2x2"])
def test_ranks_hold_their_param_specs_shards(worlds, world):
    per_rank = worlds[world]["shard_shapes_bad"]
    assert len(per_rank) == int(world[0]) * int(world[2])
    assert all(not bad for rank in per_rank for bad in rank.values()), \
        per_rank


def test_elastic_retarget_bit_equal(worlds):
    ranks = worlds["2x2"]["ranks"]
    for r in ranks[:2]:                 # the 1 x 2 sub-mesh's two ranks
        assert r["retarget"]["bit_equal"]
        assert r["retarget"]["shard_shapes_bad"] == []
        assert r["retarget"]["any_sharded"]
    assert ranks[2]["retarget"] == ranks[3]["retarget"] == {}


def test_checkpoint_host_copy_on_the_writer_only(worlds):
    """Every rank takes part in the gathers; rank 0 alone copies the tree
    to host memory and starts a writer, the others copy nothing."""
    ranks = worlds["2x2"]["ranks"]
    n = ranks[0]["saved"]["leaves"]
    assert ranks[0]["saved"] == {"host_copies": n, "leaves": n,
                                 "writer_thread": True}
    for r in ranks[1:]:
        assert r["saved"] == {"host_copies": 0, "leaves": n,
                              "writer_thread": False}


def test_checkpoint_restores_across_meshes(worlds):
    full = worlds["2x2"]["params_full"]
    got = worlds["1x2"]["restored"]
    assert got["step"] == chk.CKPT_STEP and got["opt_step"] == chk.STEPS
    assert got["shard_shapes_bad"] == []
    assert len(got["params_full"]) == len(full)
    assert all(torch.equal(a, b) for a, b in zip(got["params_full"], full))
    # in one process, into plain tensors
    arch = get_arch("qwen3-0.6b", smoke=True)
    p = family_fns(arch)["init"](torch.Generator().manual_seed(1), "cpu")
    step, (rp, ro) = restore_checkpoint(str(worlds["dir"] / "ckpt"),
                                        (p, adamw_init(p)))
    assert step == chk.CKPT_STEP
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(rp), full))
    assert all(torch.equal(a, b) for a, b in
               zip(tree_leaves(ro.mu), got["mu_full"]))
    # and in the reference package
    def zeros():
        return jax.tree.map(lambda t: np.zeros(tuple(t.shape), np.float32), p)

    jstep, (jrp, _) = jrestore(str(worlds["dir"] / "ckpt"), (
        zeros(), JAdamWState(mu=zeros(), nu=zeros(),
                             step=np.zeros((), np.int32))))
    assert jstep == chk.CKPT_STEP
    for a, b in zip(jax.tree.leaves(jrp), full):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


_JAX_REDUCE = """
    import functools, sys
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import PartitionSpec as P
    from jax.experimental.shard_map import shard_map
    from repro.optim.compression import compressed_grad_mean, quantize_int8

    io = dict(np.load(sys.argv[1]))
    keys = sorted(k[2:] for k in io if k.startswith("g/"))
    g = {k: jnp.asarray(io["g/" + k]) for k in keys}      # [4, ...]
    e = {k: jnp.asarray(io["e/" + k]) for k in keys}
    mesh = jax.make_mesh((4,), ("data",))

    @functools.partial(shard_map, mesh=mesh, in_specs=(P("data"), P("data")),
                       out_specs=(P("data"), P("data")), check_rep=False)
    def comp(gg, ee):
        gg = jax.tree.map(lambda x: x[0], gg)
        ee = jax.tree.map(lambda x: x[0], ee)
        out, err = compressed_grad_mean(gg, "data", 4, ee)
        return (jax.tree.map(lambda x: x[None], out),
                jax.tree.map(lambda x: x[None], err))

    with mesh:
        out, err = jax.jit(comp)(g, e)
    res = {}
    for k in keys:
        res["out/" + k] = np.asarray(out[k])
        res["err/" + k] = np.asarray(err[k])
        for r in range(4):
            flat = (g[k][r] + e[k][r]).reshape(-1)
            flat = jnp.pad(flat, (0, (-flat.shape[0]) % 4))
            res[f"q/{k}/{r}"] = np.asarray(quantize_int8(flat)[0])
    np.savez(sys.argv[2], **res)
"""


def test_compressed_grad_mean_matches_reference(worlds, tmp_path):
    ranks = worlds["2x2"]["ranks"]
    keys = sorted(chk.GRAD_SHAPES)
    io = {}
    for k in keys:
        io["g/" + k] = np.stack([chk._grads_of(r)[k].numpy()
                                 for r in range(4)])
        io["e/" + k] = np.stack([chk._err_of(r)[k].numpy()
                                 for r in range(4)])
    np.savez(tmp_path / "in.npz", **io)
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, "-c", textwrap.dedent(_JAX_REDUCE),
                           str(tmp_path / "in.npz"),
                           str(tmp_path / "out.npz")],
                          capture_output=True, text=True, env=env,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    ref = dict(np.load(tmp_path / "out.npz"))
    for r, got in enumerate(ranks):
        # payloads: this rank's quantized local gradient (all_to_all_single,
        # one a leaf in tree order) equals the reference's quantization
        first = [p for (name, dt, _), p in
                 zip([w for w in got["wire"] if w[1] == torch.int8],
                     got["payload"]) if name == "all_to_all_single"]
        for k, q in zip(chk.GRAD_SHAPES, first):     # the tree's order
            np.testing.assert_array_equal(q.numpy(), ref[f"q/{k}/{r}"])
        for k in keys:
            want = ref["out/" + k][r]
            rel = np.abs(got["reduced"][k].numpy() - want).max() \
                / np.abs(want).max()
            assert rel <= 1e-7, (k, r, rel)
            np.testing.assert_array_equal(got["err"][k].numpy(),
                                          ref["err/" + k][r])


def test_compressed_wire_is_int8(worlds):
    for got in worlds["2x2"]["ranks"]:
        wire = got["wire"]
        assert {dt for _, dt, _ in wire} == {torch.int8, torch.float32}
        # per leaf: an all_to_all of the padded int8 gradient, an
        # all_gather of the int8 reduced segments, and two all_gathers of
        # one float32 scale per rank
        assert all(n == 1 for _, dt, n in wire if dt == torch.float32)
        for k, shape in sorted(chk.GRAD_SHAPES.items()):
            size = int(np.prod(shape))
            padded = size + (-size) % 4
            assert ("all_to_all_single", torch.int8, padded) in wire
            assert ("all_gather_into_tensor", torch.int8, padded // 4) in wire
        assert len(wire) == 4 * len(chk.GRAD_SHAPES)


@settings(max_examples=25, deadline=None)
@given(st.integers(0, 2 ** 31 - 1), st.floats(1e-3, 1e3))
def test_quantize_roundtrip_bound(seed, scale):
    g = prng.normal(prng.PRNGKey(seed), (64,)) * scale
    q, s = quantize_int8(g)
    err = float((dequantize_int8(q, s) - g).abs().max())
    assert err <= float(s) * 0.5 + 1e-9   # half a step of the int8 grid


def test_dp_compressed_train_step_lowers_loss(worlds):
    losses = worlds["2x1"]["dp_losses"]
    assert len(losses) == 20 and np.isfinite(losses).all()
    assert losses[-1] < losses[0] - 0.2, losses[::4]
    assert worlds["2x1"]["dp_params_agree"]


def _cli(args, launcher):
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    env.pop("WORLD_SIZE", None)
    proc = subprocess.run(
        [sys.executable, "-m", *launcher, "-m", "repro_torch.launch.train",
         "--smoke", "--device", "cpu", "--steps", "3", "--batch", "4",
         "--seq", "64", *args] if launcher else
        [sys.executable, "-m", "repro_torch.launch.train", "--smoke",
         "--device", "cpu", "--steps", "3", "--batch", "4", "--seq", "64",
         *args], capture_output=True, text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    summ = [x for x in proc.stdout.splitlines() if x.startswith("summary ")]
    assert len(summ) == 1, proc.stdout      # rank 0 alone reports
    return json.loads(summ[0][len("summary "):])


def test_cli_torchrun_1x2_matches_1x1():
    one = _cli(["--data-parallel", "1", "--model-parallel", "1"], None)
    two = _cli(["--data-parallel", "1", "--model-parallel", "2"],
               ["torch.distributed.run", "--standalone",
                "--nproc-per-node", "2"])
    assert one["mesh"] == {"data": 1, "model": 1}
    assert two["mesh"] == {"data": 1, "model": 2}
    np.testing.assert_allclose(two["loss"], one["loss"], rtol=1e-6, atol=0)
