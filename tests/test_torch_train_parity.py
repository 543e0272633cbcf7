"""Training on the port against the JAX reference (CPU): the train step of
all six families, microbatching, several steps, AdamW on equal gradients,
checkpoints across the two packages, and the data pipeline.

Size: each family's smoke config (float32, no remat), batch 4 x 64 (the
encdec family: 4 clips of 64 frames, 32 decoder tokens), the JAX init's
weights carried over by `repro_torch.convert`, the batches of the
training CLI (`repro_torch.launch.train.train_batch`, numpy) fed to both
packages.  The reference's step is ``jax.jit(build_cell(arch,
ShapeSpec(.., "train", 64, 4), make_host_mesh(1, 1)).fn)``.

Tolerances: the loss 1e-5 (absolute); grad norm and lr 1e-5 relative;
every gradient leaf within 1e-4 of its leaf's max |g|, read from the
first moment after one step from zero (mu = (1 - b1) * clipped g, in
both packages); five qwen3-0.6b steps' losses 1e-4 (parameters are not
compared element by element: where a gradient element is near 0, Adam's
m / sqrt(v) is about +-1 whatever its size, so a rounding-level sign
difference moves a parameter by up to 2 lr).  AdamW on the same numpy
gradients: parameters, mu and nu 1e-6 relative (to the element, or to
the leaf's largest element where a moment's two terms cancel), lr and
grad norm 1e-6, step exact.  Checkpoints and data: exact.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import restore_checkpoint as jrestore
from repro.checkpoint import save_checkpoint as jsave
from repro.configs.registry import ShapeSpec
from repro.configs.registry import get_arch as jget_arch
from repro.data import pipeline as jdata
from repro.launch.mesh import make_host_mesh
from repro.launch.steps import build_cell
from repro.launch.steps import family_fns as jfamily_fns
from repro.optim import OptConfig as JOptConfig
from repro.optim import adamw as jadamw
from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
from repro_torch.configs.registry import get_arch as tget_arch
from repro_torch.convert import params_from_jax, to_numpy
from repro_torch.data import pipeline as tdata
from repro_torch.launch.steps import family_fns, train_step
from repro_torch.launch.train import train_batch
from repro_torch.optim import adamw as tadamw

FAMILIES = ("qwen3-0.6b", "deepseek-moe-16b", "internvl2-76b", "mamba2-370m",
            "recurrentgemma-9b", "whisper-tiny")
SEQ, BATCH = 64, 4
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=10)


@pytest.fixture(autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _np(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


def _leaves(tree, path=()):
    """(path, array) of nested dicts, keys sorted."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    else:
        yield "/".join(path), np.asarray(tree)


class Setup:
    """One family's JAX step and the port's, from the same weights."""

    def __init__(self, arch_id, microbatch=1):
        self.ja = jget_arch(arch_id, smoke=True)
        self.ta = tget_arch(arch_id, smoke=True)
        self.mesh = make_host_mesh(1, 1)
        cell = build_cell(self.ja, ShapeSpec("t", "train", SEQ, BATCH),
                          self.mesh, opt_cfg=JOptConfig(**OPT),
                          microbatch=microbatch)
        self.jstep = jax.jit(cell.fn)
        self.jp = jfamily_fns(self.ja)["init"](jax.random.PRNGKey(0))
        self.tp = params_from_jax(jax.device_get(self.jp))
        self.loss = family_fns(self.ta)["loss"]
        self.dcfg = tdata.DataConfig(vocab=self.ta.model.vocab, seq_len=SEQ,
                                     global_batch=BATCH)
        self.microbatch = microbatch

    def steps(self, n):
        """n steps in both packages: [(jax metrics, port metrics)], and
        the last step's (jax opt state, port opt state)."""
        jp, tp = self.jp, self.tp
        jopt, topt = jadamw.adamw_init(jp), tadamw.adamw_init(tp)
        out = []
        for i in range(n):
            batch = train_batch(self.ta, self.dcfg, i)
            with self.mesh:
                jp, jopt, jm = self.jstep(jp, jopt, batch)
            tp, topt, tm = train_step(tp, topt, batch, self.loss,
                                      tadamw.OptConfig(**OPT),
                                      microbatch=self.microbatch)
            out.append(({k: float(v) for k, v in jm.items()},
                        {k: float(v) for k, v in tm.items()}))
        return out, (jopt, topt)


def _check_step(jm, tm):
    assert abs(tm["loss"] - jm["loss"]) <= 1e-5, (tm, jm)
    for k in ("grad_norm", "lr"):
        assert abs(tm[k] - jm[k]) <= 1e-5 * abs(jm[k]), (k, tm, jm)


def _check_grads(jopt, topt):
    """Every leaf of the first moment (a scaled gradient after one step)
    within 1e-4 of its leaf's max |mu|; none left without a gradient."""
    ref = dict(_leaves(_np(jopt.mu)))
    got = dict(_leaves(to_numpy(topt.mu)))
    assert got.keys() == ref.keys()
    for k, r in ref.items():
        scale = float(np.abs(r).max())
        assert scale > 0, f"{k} has no gradient"
        err = float(np.abs(got[k] - r).max())
        assert err <= 1e-4 * scale, (k, err, scale)
    assert int(topt.step) == int(jopt.step) == 1


@pytest.mark.parametrize("arch_id", FAMILIES)
def test_train_step_matches_reference(arch_id):
    steps, opts = Setup(arch_id).steps(1)
    _check_step(*steps[0])
    _check_grads(*opts)


def test_microbatched_train_step_matches_reference():
    """microbatch = 2: two slices' float32 gradients summed in order and
    halved, the loss their mean -- against the reference's scan."""
    s = Setup("qwen3-0.6b", microbatch=2)
    steps, opts = s.steps(1)
    _check_step(*steps[0])
    _check_grads(*opts)


def test_five_steps_losses_match_reference():
    steps, _ = Setup("qwen3-0.6b").steps(5)
    for i, (jm, tm) in enumerate(steps):
        assert abs(tm["loss"] - jm["loss"]) <= 1e-4, (i, tm, jm)
        assert abs(tm["lr"] - jm["lr"]) <= 1e-5 * jm["lr"], (i, tm, jm)


# ------------------------------------------------------------------ AdamW

def _tree(seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return {"a": {"w": rng.standard_normal((5, 7)).astype(dtype),
                  "b": rng.standard_normal((7,)).astype(dtype)},
            "emb": rng.standard_normal((11, 3)).astype(dtype) * 0.02,
            "z": np.zeros((4,), dtype)}


@pytest.mark.parametrize("clip_norm", [1e9, 0.5])
def test_adamw_update_matches_reference(clip_norm):
    """Four updates on the same numpy gradients (a zero leaf included;
    warmup, then the cosine decay; clipping on and off)."""
    cfg = dict(lr=1e-2, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1,
               clip_norm=clip_norm, warmup_steps=2, total_steps=6,
               min_lr_ratio=0.1)
    jcfg, tcfg = JOptConfig(**cfg), tadamw.OptConfig(**cfg)
    p = _tree(0)
    jp = jax.tree.map(jnp.asarray, p)
    tp = params_from_jax(p)
    jst, tst = jadamw.adamw_init(jp), tadamw.adamw_init(tp)
    for i in range(4):
        g = _tree(10 + i)
        jp, jst, jm = jadamw.adamw_update(jax.tree.map(jnp.asarray, g), jst,
                                          jp, jcfg)
        tp, tst, tm = tadamw.adamw_update(params_from_jax(g), tst, tp, tcfg)
        for k in ("lr", "grad_norm"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       rtol=1e-6, err_msg=k)
        for name, a, b in (("params", tp, jp), ("mu", tst.mu, jst.mu),
                           ("nu", tst.nu, jst.nu)):
            for (k, x), (_, y) in zip(_leaves(to_numpy(a)),
                                      _leaves(_np(b))):
                np.testing.assert_allclose(
                    x, y, rtol=1e-6, atol=1e-6 * float(np.abs(y).max()),
                    err_msg=f"{name} {k} step {i}")
        assert tst.step.dtype == torch.int32
        assert int(tst.step) == int(jst.step) == i + 1


def test_adamw_keeps_bf16_params_bf16():
    """bf16 parameters: f32 moments, a bf16 result within one bf16 ulp of
    the reference's (the float32 update rounds once)."""
    cfg = dict(lr=1e-2, warmup_steps=0, total_steps=10)
    p = {"w": jnp.asarray(_tree(0)["a"]["w"], jnp.bfloat16)}
    g = {"w": jnp.asarray(_tree(1)["a"]["w"], jnp.bfloat16)}
    jp, jst, _ = jadamw.adamw_update(g, jadamw.adamw_init(p), p,
                                     JOptConfig(**cfg))
    tp0 = params_from_jax(jax.device_get(p))
    tp, tst, _ = tadamw.adamw_update(params_from_jax(jax.device_get(g)),
                                     tadamw.adamw_init(tp0), tp0,
                                     tadamw.OptConfig(**cfg))
    assert tp["w"].dtype == torch.bfloat16 and tst.mu["w"].dtype \
        == torch.float32
    want = np.asarray(jp["w"], np.float32)
    np.testing.assert_allclose(tp["w"].float().numpy(), want,
                               rtol=2 ** -8, atol=0)


# ------------------------------------------------------------ checkpoints

def _opt_tree(seed):
    """A (params, AdamWState) tree with a bf16 leaf, as numpy."""
    p = _tree(seed)
    p["a"]["w"] = p["a"]["w"].astype(jnp.bfloat16)
    return p


def test_jax_checkpoint_restores_in_the_port(tmp_path):
    p = _opt_tree(0)
    jp = jax.tree.map(jnp.asarray, p)
    jst = jadamw.adamw_init(jp)
    jst = jst._replace(mu=jax.tree.map(lambda x: x + 1.5, jst.mu),
                       step=jnp.asarray(7, jnp.int32))
    jsave(str(tmp_path), 7, (jp, jst))
    tp = params_from_jax(jax.tree.map(np.zeros_like, p))
    target = (tp, tadamw.adamw_init(tp))
    step, (rp, rst) = restore_checkpoint(str(tmp_path), target)
    assert step == 7
    assert rp["a"]["w"].dtype == torch.bfloat16
    assert rst.step.dtype == torch.int32 and int(rst.step) == 7
    for got, want in ((rp, jp), (rst.mu, jst.mu), (rst.nu, jst.nu)):
        for (k, x), (_, y) in zip(_leaves(to_numpy(got)),
                                  _leaves(_np(want))):
            np.testing.assert_array_equal(x, np.asarray(y, np.float32)
                                          if y.dtype == jnp.bfloat16 else y,
                                          err_msg=k)


def test_port_checkpoint_restores_in_jax(tmp_path):
    p = _opt_tree(1)
    tp = params_from_jax(p)
    tst = tadamw.adamw_init(tp)
    tst = tst._replace(nu=tadamw.tree_map(lambda x: x + 0.25, tst.nu),
                       step=torch.tensor(5, dtype=torch.int32))
    save_checkpoint(str(tmp_path), 5, (tp, tst))
    jp = jax.tree.map(lambda x: jnp.zeros(x.shape, x.dtype), p)
    step, (rp, rst) = jrestore(str(tmp_path), (jp, jadamw.adamw_init(jp)))
    assert step == 5
    assert rp["a"]["w"].dtype == jnp.bfloat16
    assert rst.step.dtype == jnp.int32 and int(rst.step) == 5
    for got, want in ((rp, tp), (rst.nu, tst.nu), (rst.mu, tst.mu)):
        for (k, x), (_, y) in zip(_leaves(_np(got)),
                                  _leaves(to_numpy(want))):
            np.testing.assert_array_equal(np.asarray(x, np.float32), y,
                                          err_msg=k)


# ------------------------------------------------------------------- data

@pytest.mark.parametrize("host", [(0, 1), (1, 2)])
def test_data_pipeline_matches_reference(host):
    kw = dict(vocab=101, seq_len=32, global_batch=4, seed=3,
              host_index=host[0], host_count=host[1])
    jc, tc = jdata.DataConfig(**kw), tdata.DataConfig(**kw)
    assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
    for step in (0, 5):
        for k in ("tokens", "labels"):
            np.testing.assert_array_equal(
                tdata.synthetic_batch(tc, step)[k],
                jdata.synthetic_batch(jc, step)[k])
        a, b = (tdata.synthetic_image_embeds(tc, step, 6, 8),
                jdata.synthetic_image_embeds(jc, step, 6, 8))
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
        a, b = (tdata.synthetic_audio_embeds(tc, step, 9, 4),
                jdata.synthetic_audio_embeds(jc, step, 9, 4))
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    ts, js = tdata.SyntheticLMStream(tc, 2), jdata.SyntheticLMStream(jc, 2)
    try:
        for _ in range(3):
            (i, a), (j, b) = next(ts), next(js)
            assert i == j
            np.testing.assert_array_equal(a["tokens"], b["tokens"])
    finally:
        ts.close()
        js.close()
