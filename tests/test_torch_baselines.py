"""The paper's baseline attentions (`repro_torch.core.baselines`) and their
``attention_apply`` branches against the JAX reference, float32, inputs
from numpy seeds.  The reference computes them in plain XLA; the port in
plain PyTorch: floats agree to atol = rtol = 1e-5 (float32 matrix products
reduce in another order on each side).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_arch as jget_arch
from repro.core import baselines as jb
from repro.models import modules as jnn
from repro.models import transformer as jtfm
from repro_torch.configs.registry import get_arch as tget_arch
from repro_torch.convert import params_from_jax
from repro_torch.core import baselines as tb
from repro_torch.models import modules as tnn

TOL = dict(atol=1e-5, rtol=1e-5)


def _qkv(seed, lead=(2, 2, 3), kv_lead=(2, 2, 1), n=64, d=16):
    """q [..., N, d] and k, v over a broadcast-1 group axis (GQA)."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(lead + (n, d)).astype(np.float32),
            rng.standard_normal(kv_lead + (n, d)).astype(np.float32),
            rng.standard_normal(kv_lead + (n, d)).astype(np.float32))


def _both(jfn, tfn, args, **kw):
    j = jfn(*(jnp.asarray(a) for a in args), **kw)
    t = tfn(*(torch.as_tensor(a) for a in args), **kw)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL)


@pytest.mark.parametrize("causal", [True, False])
def test_full_attention(causal):
    _both(jb.full_attention, tb.full_attention, _qkv(0), causal=causal)


@pytest.mark.parametrize("causal,window", [(True, 16), (False, 16),
                                           (True, 64)])
def test_local_attention(causal, window):
    """(The reference's blockwise form needs k and v with q's lead.)"""
    _both(jb.local_attention, tb.local_attention,
          _qkv(1, kv_lead=(2, 2, 3)), window=window, causal=causal)


@pytest.mark.parametrize("causal", [True, False])
def test_linear_attention(causal):
    _both(jb.linear_attention, tb.linear_attention, _qkv(2), causal=causal)


@pytest.mark.parametrize("causal,top_blocks", [(True, 1), (True, 2),
                                               (False, 2)])
def test_moba_attention(causal, top_blocks):
    _both(jb.moba_attention, tb.moba_attention, _qkv(3, kv_lead=(2, 2, 3)),
          block_size=16, top_blocks=top_blocks, causal=causal)


def test_window_must_divide_the_length():
    q, k, v = (torch.as_tensor(a) for a in _qkv(4, n=40))
    with pytest.raises(ValueError, match="not divisible"):
        tb.local_attention(q, k, v, window=16)
    with pytest.raises(ValueError, match="divide"):
        tb.moba_attention(q, k, v, block_size=16, top_blocks=1)


@pytest.mark.parametrize("backend,layout", [
    ("full", "grouped"), ("linear", "grouped"), ("full", "repeat"),
    ("local", "repeat"), ("moba", "repeat"), ("linear", "repeat")])
def test_attention_apply_branches(backend, layout):
    """`attention_apply` with each baseline backend, on the qwen3-0.6b smoke
    config (GQA 4 heads over 2, qk-norm, RoPE); local attention with a
    32-token window over 64 positions.  Local and MoBA run in the "repeat"
    layout only: the reference's blockwise forms reshape k and v with q's
    lead."""
    jc = jget_arch("qwen3-0.6b", smoke=True).model
    tc = tget_arch("qwen3-0.6b", smoke=True).model
    jc = dataclasses.replace(jc, attn=dataclasses.replace(
        jc.attn, backend=backend, local_window=32, gqa_layout=layout))
    tc = dataclasses.replace(tc, attn=dataclasses.replace(
        tc.attn, backend=backend, local_window=32, gqa_layout=layout))
    jp = jtfm.lm_init(jax.random.PRNGKey(0), jc)["blocks"]
    jp = jax.tree.map(lambda a: a[0], jp)["attn"]
    tp = params_from_jax(jax.device_get(jp))
    x = np.random.default_rng(5).standard_normal((2, 64, 128)).astype(
        np.float32)
    j = jnn.attention_apply(jp, jnp.asarray(x), jc)
    t = tnn.attention_apply(tp, torch.as_tensor(x), tc)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL)


def test_unknown_backend_raises():
    tc = tget_arch("qwen3-0.6b", smoke=True).model
    tc = dataclasses.replace(tc, attn=dataclasses.replace(tc.attn,
                                                          backend="nope"))
    p = tnn.attention_init(torch.Generator().manual_seed(0), tc, "cpu")
    with pytest.raises(ValueError, match="unknown attention backend"):
        tnn.attention_apply(p, torch.zeros(1, 16, 128), tc)
