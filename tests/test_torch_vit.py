"""The port's ViT (`models.vit`) and the primitives it and whisper add
(`modules.layer_norm`, `gelu_mlp_*`, ``attention_apply(bidir=True)``)
against the JAX reference (CPU), with the JAX init's weights carried over
by `repro_torch.convert`.

The config is ``benchmarks/common.py``'s ``tiny_vit_cfg`` at two layers:
d 64, 4 heads of 16 over 4 KV heads, N 64 patches of 48 values, m = 8
landmarks (window 8), k = 8, 10 classes, float32.  Tolerances:
``layer_norm`` and ``gelu_mlp`` 1e-6; one attention layer 3e-5 (the
sparse forwards' tolerance in `tests/test_torch_sparse.py`); logits 1e-4;
the loss 1e-5; accuracy exact.  ``impl="pallas"`` runs the plain expert
kernel here (no launch on the CPU) and the Pallas kernel in interpret
mode on the JAX side.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import modules as jnn
from repro.models import vit as jvit
from repro.models.transformer import block_apply as jblock_apply
from repro_torch.convert import params_from_jax
from repro_torch.kernels import ops
from repro_torch.models import modules as tnn
from repro_torch.models import transformer as ttfm
from repro_torch.models import vit as tvit

LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)
ATTN_TOL = dict(atol=3e-5, rtol=3e-5)
PRIM_TOL = dict(atol=1e-6, rtol=1e-6)
N, PATCH, CLASSES = 64, 48, 10


@pytest.fixture(autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _cfgs(**attn):
    """tiny_vit_cfg's widths at 2 layers, in both packages."""
    def build(nn_mod):
        a = dict(backend="mita", window=N // 8, k=8, s=1, causal=False,
                 block_q=32)
        a.update(attn)
        return nn_mod.ModelConfig(n_layers=2, d_model=64, n_heads=4, n_kv=4,
                                  d_ff=128, vocab=11,
                                  attn=nn_mod.AttnConfig(**a))
    return build(jnn), build(tnn)


@pytest.fixture(scope="module")
def weights():
    jc, _ = _cfgs()
    jp = jvit.vit_init(jax.random.PRNGKey(0), jc, PATCH, CLASSES)
    return jp, params_from_jax(jax.device_get(jp))


def _batch(b=2, seed=0):
    rng = np.random.default_rng(seed)
    return {"patches": rng.standard_normal((b, N, PATCH)).astype(np.float32),
            "label": rng.integers(0, CLASSES, (b,)).astype(np.int32)}


def test_layer_norm_and_gelu_mlp():
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((3, 7, 64)) * 2 + 0.5).astype(np.float32)
    scale = rng.standard_normal(64).astype(np.float32)
    bias = rng.standard_normal(64).astype(np.float32)
    got = tnn.layer_norm(*(torch.from_numpy(a) for a in (x, scale, bias)))
    want = jnn.layer_norm(*(jnp.asarray(a) for a in (x, scale, bias)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **PRIM_TOL)
    jc, tc = _cfgs()
    jp = jnn.gelu_mlp_init(jax.random.PRNGKey(2), jc)
    jp = dict(jp, bi=jnp.asarray(rng.standard_normal(128), jnp.float32),
              bo=jnp.asarray(rng.standard_normal(64), jnp.float32))
    tp = params_from_jax(jax.device_get(jp))
    got = tnn.gelu_mlp_apply(tp, torch.from_numpy(x), tc)
    want = jnn.gelu_mlp_apply(jp, jnp.asarray(x), jc)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **PRIM_TOL)
    own = tnn.gelu_mlp_init(torch.Generator().manual_seed(0), tc, "cpu")
    assert {k: tuple(v.shape) for k, v in own.items()} == {
        k: tuple(v.shape) for k, v in jp.items()}


BACKENDS = {
    "mita_sorted": dict(), "mita_pallas": dict(impl="pallas"),
    "mita_capacity": dict(impl="capacity", capacity_factor=4.0),
    "mita_ref": dict(backend="mita_ref"), "agent": dict(backend="agent"),
    "mita_route": dict(backend="mita_route"), "full": dict(backend="full"),
    "local": dict(backend="local", local_window=16),
    "moba": dict(backend="moba"), "linear": dict(backend="linear"),
}


@pytest.mark.parametrize("name", list(BACKENDS))
def test_attention_apply_bidir(weights, name):
    """One layer's attention with ``bidir=True`` for every backend, on a
    causal config (``bidir`` must turn causality off everywhere)."""
    jp, tp = weights
    jc, tc = _cfgs(causal=True, **BACKENDS[name])
    x = np.random.default_rng(3).standard_normal((2, N, 64)).astype(
        np.float32)
    lp_j = jax.tree_util.tree_map(lambda a: a[0], jp["blocks"])["attn"]
    lp_t = ttfm.layer_params(tp["blocks"], 0)["attn"]
    want = jnn.attention_apply(lp_j, jnp.asarray(x), jc, bidir=True)
    got = tnn.attention_apply(lp_t, torch.from_numpy(x), tc, bidir=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **ATTN_TOL)
    causal = tnn.attention_apply(lp_t, torch.from_numpy(x), tc)
    assert not np.allclose(causal.numpy(), got.numpy(), **ATTN_TOL)


def test_block_apply_bidir(weights):
    jp, tp = weights
    jc, tc = _cfgs()
    x = np.random.default_rng(4).standard_normal((2, N, 64)).astype(
        np.float32)
    bp = jax.tree_util.tree_map(lambda a: a[1], jp["blocks"])
    want, _ = jblock_apply(bp, jnp.asarray(x), jc, jnp.arange(N), bidir=True)
    got, aux = ttfm.block_apply(ttfm.layer_params(tp["blocks"], 1),
                                torch.from_numpy(x), tc, torch.arange(N),
                                bidir=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **ATTN_TOL)
    assert aux == 0.0


VIT_CASES = {
    "mita_sorted": dict(), "mita_pallas": dict(impl="pallas"),
    "mita_ref": dict(backend="mita_ref"), "agent": dict(backend="agent"),
    "mita_route": dict(backend="mita_route"), "full": dict(backend="full"),
    "linear": dict(backend="linear"), "random_landmarks":
        dict(landmark="random", impl="pallas"),
}


@pytest.mark.parametrize("name", list(VIT_CASES))
def test_vit_forward_loss_accuracy(weights, name):
    jp, tp = weights
    jc, tc = _cfgs(**VIT_CASES[name])
    batch = _batch(4)
    ops.reset_launch_counts()
    got = tvit.vit_forward(tp, torch.from_numpy(batch["patches"]), tc)
    assert ops.launch_counts()["mita_expert_attention"] == 0   # CPU: plain
    want = jvit.vit_forward(jp, jnp.asarray(batch["patches"]), jc)
    assert tuple(got.shape) == (4, CLASSES)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGIT_TOL)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    np.testing.assert_allclose(tvit.vit_loss(tp, batch, tc).item(),
                               float(jvit.vit_loss(jp, jb, jc)), atol=1e-5,
                               rtol=1e-5)
    acc = tvit.vit_accuracy(tp, batch, tc).item()
    assert acc == float(jvit.vit_accuracy(jp, jb, jc))


def test_vit_pallas_equals_span_m():
    """Bidirectional, every sub-query is routed: the expert path equals the
    sorted path with the whole expert range in its span, and differs from
    the default span 4 < m only where that span drops experts."""
    jc, tc = _cfgs(window=4, k=8, block_q=4)            # m = 16
    jp = jvit.vit_init(jax.random.PRNGKey(1), jc, PATCH, CLASSES)
    tp = params_from_jax(jax.device_get(jp))
    x = torch.from_numpy(_batch(2, seed=5)["patches"])
    pal = tvit.vit_forward(tp, x, dataclasses.replace(
        tc, attn=dataclasses.replace(tc.attn, impl="pallas")))
    span = tvit.vit_forward(tp, x, dataclasses.replace(
        tc, attn=dataclasses.replace(tc.attn, expert_span=16)))
    np.testing.assert_allclose(pal.numpy(), span.numpy(), **LOGIT_TOL)


def test_vit_init_layout(weights):
    """The port's own init builds the reference's layout."""
    jp, tp = weights
    _, tc = _cfgs()
    own = tvit.vit_init(torch.Generator().manual_seed(0), tc, PATCH, CLASSES,
                        device="cpu")
    for path, leaf in jax.tree_util.tree_leaves_with_path(
            jax.device_get(jp)):
        node_o, node_t = own, tp
        for p in path:
            node_o, node_t = node_o[p.key], node_t[p.key]
        assert tuple(node_o.shape) == leaf.shape == tuple(node_t.shape)
        assert node_o.dtype == node_t.dtype
    assert tuple(own["pos"].shape) == (tvit.POS_ROWS, 64)
