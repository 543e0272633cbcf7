"""The port's sharding rules, cells and batch-form hybrid decode against
the JAX reference (CPU, one process).

* ``spec_for_param`` / ``param_specs``: every leaf of every architecture
  in the reference's ``ARCHS`` at full size (abstract parameters, no
  weights: meta tensors here, ``eval_shape`` there), "model" axis sizes
  1, 2, 4 and 16; specs equal as tuples, leaf shapes and dtypes equal.
* ``batch_spec`` over ranks 1-3, divisible and indivisible batches, with
  and without a "pod" axis; ``state_specs`` under both policies on every
  family's decode states.  The reference's functions read only
  ``mesh.shape``, so both packages are given a described mesh.
* ``ShapeSpec`` / ``SHAPES`` / ``shape_supported`` equal.
* ``build_cell``: the arguments of every (arch x shape) cell the
  reference lowers equal its abstract arguments (path, shape, dtype); at
  1 x 1 (a one-rank gloo mesh) each family's train cell (on parameters
  and moments placed by its shardings), prefill and decode cell gives
  the direct call's result, bit for bit, at the smoke size.
* ``rg_decode_step``: 24 steps from the same weights and tokens, MiTA and
  full-attention states (a 16-row window cache, overrun), logits within
  1e-5, every state leaf within 1e-5.
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.tensor import distribute_tensor

import repro  # noqa: F401  (turns partitionable threefry on)
from repro.configs import registry as jreg
from repro.distributed import sharding as jshd
from repro.launch import mesh as jmesh
from repro.launch import steps as jsteps
from repro.models import rglru as jrg
from repro_torch.configs import registry as treg
from repro_torch.convert import params_from_jax, rg_state_from_jax, to_numpy
from repro_torch.data import DataConfig
from repro_torch.distributed import sharding as tshd
from repro_torch.launch import steps as tsteps
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.train import train_batch
from repro_torch.models import rglru as trg
from repro_torch.optim import OptConfig, adamw_init
from repro_torch.optim.adamw import AdamWState, tree_leaves, tree_map

MODEL_SIZES = (1, 2, 4, 16)
FAMILY_ARCHS = ("qwen3-0.6b", "deepseek-moe-16b", "internvl2-76b",
                "mamba2-370m", "recurrentgemma-9b", "whisper-tiny")
DTYPES = {jnp.dtype(jnp.float32): torch.float32,
          jnp.dtype(jnp.bfloat16): torch.bfloat16,
          jnp.dtype(jnp.int32): torch.int32,
          jnp.dtype(jnp.bool_): torch.bool}


def _clone(tree):
    return tsteps.zip_map(torch.clone, tree)


@pytest.fixture(autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _meshes(sizes: dict):
    """The same mesh described to both packages: the reference reads
    ``mesh.shape`` as a dict, the port ``mesh_dim_names`` and ``shape``."""
    return (types.SimpleNamespace(shape=dict(sizes)),
            types.SimpleNamespace(mesh_dim_names=tuple(sizes),
                                  shape=tuple(sizes.values()),
                                  ndim=len(sizes)))


def _jflat(tree) -> dict:
    """{path: leaf} of a JAX tree, NamedTuple field names without the
    leading dot ``_path_str`` keeps."""
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    return {"/".join(s.lstrip(".") for s in jshd._path_str(p).split("/")): x
            for p, x in flat}


def _tflat(tree) -> dict:
    out = {}
    tshd.map_with_path(lambda p, x: out.setdefault(p, x), tree)
    return out


def _same_specs(jspecs, tspecs):
    j, t = _jflat(jspecs), _tflat(tspecs)
    assert sorted(j) == sorted(t)
    bad = {p: (tuple(j[p]), tuple(t[p])) for p in j
           if tuple(j[p]) != tuple(t[p])}
    assert not bad, bad
    return len(j)


def _same_abstract(jtree, ttree):
    j, t = _jflat(jtree), _tflat(ttree)
    assert sorted(j) == sorted(t)
    for p in j:
        assert tuple(j[p].shape) == tuple(t[p].shape), p
        assert DTYPES[jnp.dtype(j[p].dtype)] == t[p].dtype, p


@pytest.mark.parametrize("arch_id", jreg.ARCHS)
def test_param_specs_match_reference(arch_id):
    jparams = jsteps.abstract_params(jreg.get_arch(arch_id))
    tparams = tsteps.abstract_params(treg.get_arch(arch_id))
    assert {x.device.type for x in tree_leaves(tparams)} == {"meta"}
    _same_abstract(jparams, tparams)
    flat = _tflat(tparams)
    for m in MODEL_SIZES:
        jm, tm = _meshes({"data": 2, "model": m})
        n = _same_specs(jshd.param_specs(jparams, jm),
                        tshd.param_specs(tparams, tm))
        assert n == len(flat)
        for path, x in flat.items():
            assert tuple(tshd.spec_for_param(path, x.dim(), tuple(x.shape),
                                             m)) == tuple(
                jshd.spec_for_param(path, x.dim(), tuple(x.shape), m))


@pytest.mark.parametrize("sizes", [{"data": 1, "model": 1},
                                   {"data": 4, "model": 2},
                                   {"pod": 2, "data": 4, "model": 4}])
def test_batch_spec_matches_reference(sizes):
    jm, tm = _meshes(sizes)
    assert tshd.batch_axes(tm) == jshd.batch_axes(jm)
    for rank in (1, 2, 3):
        for batch in (1, 3, 8, 12, 16):
            for small in (True, False):
                assert tuple(tshd.batch_spec(tm, batch, rank, small)) == \
                    tuple(jshd.batch_spec(jm, batch, rank, small))


def _states(arch_id, b, cap, backend=None):
    """One family's full-size decode states, abstract, in both packages."""
    ja, ta = jreg.get_arch(arch_id), treg.get_arch(arch_id)
    if backend:
        ja = jreg.get_arch(arch_id, backend=backend)
        ta = dataclasses.replace(ta, model=dataclasses.replace(
            ta.model, attn=dataclasses.replace(ta.model.attn,
                                               backend=backend)))
    if ja.family == "encdec":
        jp = jsteps.abstract_params(ja)
        cfg = ja.model
        js = jax.eval_shape(lambda p: jsteps.wh.whisper_init_serve(
            p, jnp.zeros((b, ja.t_enc, cfg.d_model), cfg.compute_dtype),
            cfg, cap), jp)
        tcell = tsteps.build_cell(ta, treg.ShapeSpec("d", "decode", cap, b),
                                  _meshes({"data": 1, "model": 1})[1])
        return js, tcell.args[1]
    js = jax.eval_shape(lambda: jsteps.family_fns(ja)["init_states"](b, cap))
    return js, tsteps.family_fns(ta)["init_states"](b, cap, "meta")


@pytest.mark.parametrize("arch_id,backend", [
    ("qwen3-0.6b", None), ("qwen3-0.6b", "full"), ("deepseek-moe-16b", None),
    ("mamba2-370m", None), ("recurrentgemma-9b", None),
    ("recurrentgemma-9b", "full"), ("whisper-tiny", None)])
def test_state_specs_match_reference(arch_id, backend):
    for b, cap in ((8, 4096), (1, 8192), (3, 256)):
        js, ts = _states(arch_id, b, 448 if arch_id == "whisper-tiny"
                         else cap, backend)
        _same_abstract(js, ts)
        for sizes in ({"data": 2, "model": 4}, {"data": 4, "model": 16},
                      {"pod": 2, "data": 2, "model": 2}):
            jm, tm = _meshes(sizes)
            for policy in ("seq", "dh"):
                _same_specs(jshd.state_specs(js, jm, b, policy),
                            tshd.state_specs(ts, tm, b, policy))


def test_shape_grid_matches_reference():
    assert treg.SHAPES == {k: treg.ShapeSpec(*dataclasses.astuple(v))
                           for k, v in jreg.SHAPES.items()}
    for arch_id in jreg.ARCHS:
        for name, shape in jreg.SHAPES.items():
            assert treg.get_arch(arch_id).shape_supported(
                treg.SHAPES[name]) == jreg.get_arch(arch_id).shape_supported(
                    shape)


@pytest.mark.parametrize("arch_id", jreg.ARCHS)
def test_cell_args_match_reference(arch_id):
    """Every cell the reference lowers: the port's meta arguments are its
    abstract arguments (reference cells on its 1 x 1 host mesh)."""
    jm = jmesh.make_host_mesh(1, 1)
    tm = _meshes({"data": 1, "model": 1})[1]
    for name, shape in jreg.SHAPES.items():
        ja, ta = jreg.get_arch(arch_id), treg.get_arch(arch_id)
        if not ja.shape_supported(shape)[0]:
            continue
        jcell = jsteps.build_cell(ja, shape, jm)
        tcell = tsteps.build_cell(ta, treg.SHAPES[name], tm)
        assert tcell.name == jcell.name
        assert tcell.donate_argnums == jcell.donate_argnums
        _same_abstract(jcell.args, tcell.args)


@pytest.fixture(scope="module")
def one_rank_mesh():
    """A real 1 x 1 DeviceMesh over a one-rank gloo group, taken down
    after the module."""
    assert not dist.is_initialized()
    mesh = make_host_mesh(1, 1, device_type="cpu")
    yield mesh
    dist.destroy_process_group()


def _bits_equal(a, b):
    la, lb = jax.tree.leaves(a), jax.tree.leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert torch.equal(x, y)


@pytest.mark.parametrize("arch_id", FAMILY_ARCHS)
def test_cells_at_1x1_equal_direct_calls(arch_id, one_rank_mesh):
    arch = treg.get_arch(arch_id, smoke=True)
    fns = tsteps.family_fns(arch)
    params = fns["init"](torch.Generator().manual_seed(0), "cpu")
    opt_cfg = OptConfig(lr=1e-3, warmup_steps=2, total_steps=10)
    b, s = 2, 32
    dcfg = DataConfig(vocab=arch.model.vocab, seq_len=s, global_batch=b)

    train = tsteps.build_cell(arch, treg.ShapeSpec("t", "train", s, b),
                              one_rank_mesh, opt_cfg=opt_cfg)
    batch = train_batch(arch, dcfg, 0)
    assert {k: v.shape for k, v in batch.items()} == {
        k: tuple(v.shape) for k, v in train.args[2].items()}
    psh, osh, _ = train.in_shardings
    opt = adamw_init(params)

    def place(t, pl):
        return distribute_tensor(t, one_rank_mesh, pl, src_data_rank=None)

    # both steps update their inputs in place, and a placed leaf may
    # share its storage with the tensor it was placed from: clones
    got = train.fn(tree_map(place, _clone(params), psh), AdamWState(
        mu=tree_map(place, _clone(opt.mu), osh.mu),
        nu=tree_map(place, _clone(opt.nu), osh.nu),
        step=place(opt.step.clone(), osh.step)), batch)
    ref = tsteps.train_step(_clone(params), _clone(opt), batch, fns["loss"],
                            opt_cfg)
    _bits_equal([x.full_tensor() for x in tree_leaves(got[0])],
                tree_leaves(ref[0]))
    assert all(torch.equal(got[2][k], ref[2][k]) for k in ref[2])

    prefill = tsteps.build_cell(arch, treg.ShapeSpec("p", "prefill", s, b),
                                one_rank_mesh)
    tokens = torch.from_numpy(batch["tokens"])
    if arch.family == "encdec":
        audio = torch.from_numpy(batch["audio_embeds"])
        assert torch.equal(prefill.fn(params, audio),
                           tsteps.wh.whisper_encode(params, audio,
                                                    arch.model))
    elif arch.family in ("ssm", "hybrid"):
        fwd = (tsteps.mb.mamba_forward if arch.family == "ssm"
               else tsteps.rg.rg_forward)
        assert torch.equal(prefill.fn(params, {"tokens": tokens}),
                           fwd(params, tokens, arch.model)[0][:, -1])
    else:
        pb = {k: torch.as_tensor(v) for k, v in batch.items()
              if k != "labels"}
        got_l, got_st = prefill.fn(params, pb)
        ref_l, ref_st = fns["prefill"](params, pb, s)
        assert torch.equal(got_l, ref_l)
        _bits_equal(got_st, ref_st)

    if arch.family == "encdec":
        return           # whisper's decode states need the encoder output
    decode = tsteps.build_cell(arch, treg.ShapeSpec("d", "decode", s, b),
                               one_rank_mesh)
    st_a = fns["init_states"](b, s, "cpu")
    st_b = fns["init_states"](b, s, "cpu")
    for leaf, meta in zip(jax.tree.leaves(st_a),
                          jax.tree.leaves(decode.args[1])):
        assert leaf.shape == meta.shape and leaf.dtype == meta.dtype
    for pos in range(3):
        la, st_a = decode.fn(params, st_a, tokens[:, pos], pos)
        lb, st_b = fns["decode"](params, st_b, tokens[:, pos], pos)
        assert torch.equal(la, lb)
    _bits_equal(st_a, st_b)


def test_sharded_step_with_no_counted_label(one_rank_mesh):
    """A batch whose loss mask counts no label: the sharded step's loss,
    gradients and update are `train_step`'s (loss 0), not NaN: the
    global count is taken as at least 1, as ``cross_entropy`` takes it."""
    arch = treg.get_arch("qwen3-0.6b", smoke=True)
    fns = tsteps.family_fns(arch)
    params = fns["init"](torch.Generator().manual_seed(0), "cpu")
    opt_cfg = OptConfig(lr=1e-3, warmup_steps=2, total_steps=10)
    dcfg = DataConfig(vocab=arch.model.vocab, seq_len=32, global_batch=2)
    batch = train_batch(arch, dcfg, 0)
    batch["loss_mask"] = np.zeros(batch["labels"].shape, np.float32)
    train = tsteps.build_cell(arch, treg.ShapeSpec("t", "train", 32, 2),
                              one_rank_mesh, opt_cfg=opt_cfg)
    psh, osh, _ = train.in_shardings
    opt = adamw_init(params)

    def place(t, pl):
        return distribute_tensor(t, one_rank_mesh, pl, src_data_rank=None)

    # both steps update their inputs in place, and a placed leaf may
    # share its storage with the tensor it was placed from: clones
    got = train.fn(tree_map(place, _clone(params), psh), AdamWState(
        mu=tree_map(place, _clone(opt.mu), osh.mu),
        nu=tree_map(place, _clone(opt.nu), osh.nu),
        step=place(opt.step.clone(), osh.step)), batch)
    ref = tsteps.train_step(_clone(params), _clone(opt), batch, fns["loss"],
                            opt_cfg)
    assert float(got[2]["loss"]) == float(ref[2]["loss"]) == 0.0
    assert all(torch.equal(got[2][k], ref[2][k]) for k in ref[2])
    _bits_equal([x.full_tensor() for x in tree_leaves(got[0])],
                tree_leaves(ref[0]))


@pytest.mark.parametrize("backend,local_window", [("mita", 2048),
                                                  ("full", 16)])
def test_rg_decode_step_matches_jax(backend, local_window):
    ja = jreg.get_arch("recurrentgemma-9b", smoke=True, backend=backend)
    ja = dataclasses.replace(ja, model=dataclasses.replace(
        ja.model, attn=dataclasses.replace(ja.model.attn,
                                           local_window=local_window)))
    tcfg = treg.get_arch("recurrentgemma-9b", smoke=True).model
    tcfg = dataclasses.replace(tcfg, attn=dataclasses.replace(
        tcfg.attn, backend=backend, local_window=local_window))
    jp = jrg.rg_init(jax.random.PRNGKey(0), ja.model)
    tp = params_from_jax(jax.device_get(jp))
    b, cap, steps = 2, 32, 24
    js = jrg.rg_init_decode_states(ja.model, b, cap)
    ts = trg.rg_init_decode_states(tcfg, b, cap, "cpu")
    _same_abstract(js, ts)
    jstep = jax.jit(lambda p, s, t, pos: jrg.rg_decode_step(p, s, t, pos,
                                                            ja.model))
    toks = np.random.default_rng(0).integers(
        0, tcfg.vocab, (steps, b)).astype(np.int32)
    err = 0.0
    for i in range(steps):
        jl, js = jstep(jp, js, toks[i], jnp.int32(i))
        tl, ts = trg.rg_decode_step(tp, ts, torch.from_numpy(toks[i]), i,
                                    tcfg)
        err = max(err, float(np.abs(np.asarray(jl) - tl.numpy()).max()))
    assert err <= 1e-5
    jn = _jflat(jax.device_get(js))
    tn = _tflat(to_numpy(ts))
    for path in jn:
        np.testing.assert_allclose(np.asarray(tn[path], np.float64),
                                   np.asarray(jn[path], np.float64),
                                   rtol=0, atol=1e-5, err_msg=path)
    # the reference's state carries over into the port's and steps on
    ts2 = rg_state_from_jax(jax.device_get(js))
    jl, _ = jstep(jp, js, toks[0], jnp.int32(steps))
    tl, _ = trg.rg_decode_step(tp, ts2, torch.from_numpy(toks[0]), steps,
                               tcfg)
    assert float(np.abs(np.asarray(jl) - tl.numpy()).max()) <= 1e-5
