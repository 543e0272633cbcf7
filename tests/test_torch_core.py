"""Port of the MiTA core against the JAX reference (CPU).

The same numpy inputs go through ``repro.core`` and ``repro_torch.core``.
Float outputs agree to atol = rtol = 1e-5 (float32; the two frameworks sum
in different orders); integer decisions (top-k indices, validity) must be
identical, forced ties included.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import combine as jcomb
from repro.core import landmarks as jlm
from repro.core import mita as jmita
from repro.core import mita_sparse as jsparse
from repro_torch.core import combine as tcomb
from repro_torch.core import landmarks as tlm
from repro_torch.core import mita as tmita
from repro_torch.core import mita_sparse as tsparse

TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _qkv(seed, lead=(2, 2), n=64, d=16):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(lead + (n, d)).astype(np.float32)
                 for _ in range(3))


@pytest.mark.parametrize("masked", [False, True])
def test_partials_and_combine(masked):
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((3, 4, 10)).astype(np.float32)
    vals = rng.standard_normal((3, 4, 10, 8)).astype(np.float32)
    scores = rng.standard_normal((3, 5, 7)).astype(np.float32)
    svals = rng.standard_normal((3, 7, 8)).astype(np.float32)
    mask = smask = None
    if masked:
        mask = rng.random((3, 4, 10)) > 0.5
        mask[0, 0] = False                      # a fully masked row
        smask = rng.random((3, 5, 7)) > 0.4
        smask[1, 2] = False
    j1 = jcomb.partial_from_logits(jnp.asarray(logits), jnp.asarray(vals),
                                   None if mask is None else jnp.asarray(mask))
    t1 = tcomb.partial_from_logits(torch.from_numpy(logits),
                                   torch.from_numpy(vals),
                                   None if mask is None
                                   else torch.from_numpy(mask))
    j2 = jcomb.partial_from_scores(jnp.asarray(scores), jnp.asarray(svals),
                                   None if smask is None
                                   else jnp.asarray(smask))
    t2 = tcomb.partial_from_scores(torch.from_numpy(scores),
                                   torch.from_numpy(svals),
                                   None if smask is None
                                   else torch.from_numpy(smask))
    for jp, tp in ((j1, t1), (j2, t2)):
        for f in ("o", "m", "l"):
            np.testing.assert_allclose(_np(getattr(tp, f)),
                                       _np(getattr(jp, f)), **TOL)
    # combine two partials of matching shape, one with an empty row
    j3 = jcomb.combine([j1, jcomb.Partial(o=j1.o * 0.5, m=j1.m - 1.0,
                                          l=j1.l * 2.0)])
    t3 = tcomb.combine([t1, tcomb.Partial(o=t1.o * 0.5, m=t1.m - 1.0,
                                          l=t1.l * 2.0)])
    np.testing.assert_allclose(_np(t3), _np(j3), **TOL)
    if masked:
        assert np.all(_np(t3)[0, 0] == 0.0)


def test_pool1d_and_window_ends():
    q, _, _ = _qkv(1)
    np.testing.assert_allclose(_np(tlm.pool1d(torch.from_numpy(q), 4)),
                               _np(jlm.pool1d(jnp.asarray(q), 4)), **TOL)
    np.testing.assert_array_equal(_np(tlm.window_ends(64, 4)),
                                  _np(jlm.window_ends(64, 4)))
    with pytest.raises(ValueError, match="divisible"):
        tlm.pool1d(torch.from_numpy(q), 5)


@pytest.mark.parametrize("causal", [True, False])
def test_landmark_functions(causal):
    q, k, v = _qkv(2)
    cfg_j = jmita.MiTAConfig(m=4, k=8, s=1, causal=causal)
    cfg_t = tmita.MiTAConfig(m=4, k=8, s=1, causal=causal)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    jl = jmita.extract_landmarks(jq, cfg_j)
    tl = tmita.extract_landmarks(tq, cfg_t)
    js = jmita.landmark_scores(jk, jl, cfg_j)
    ts = tmita.landmark_scores(tk, tl, cfg_t)
    np.testing.assert_allclose(_np(ts), _np(js), **TOL)
    ji, jvld = jmita.topk_indices(js, cfg_j)
    ti, tvld = tmita.topk_indices(ts, cfg_t)
    np.testing.assert_array_equal(_np(ti), _np(ji))
    np.testing.assert_array_equal(_np(tvld), _np(jvld))
    jke, jve, _ = jmita.gather_topk(jk, jv, js, cfg_j)
    tke, tve, _ = tmita.gather_topk(tk, tv, ts, cfg_t)
    np.testing.assert_array_equal(_np(tke), _np(jke))
    np.testing.assert_array_equal(_np(tve), _np(jve))
    np.testing.assert_allclose(_np(tmita.landmark_values(tv, ts)),
                               _np(jmita.landmark_values(jv, js)), **TOL)
    np.testing.assert_allclose(_np(tmita.routing_logits(tq, tl, cfg_t)),
                               _np(jmita.routing_logits(jq, jl, cfg_j)),
                               **TOL)


def test_topk_forced_ties():
    """Integer-valued scores with many exact ties: the port's top-k must
    return lax.top_k's order (ties by ascending index) exactly."""
    rng = np.random.default_rng(3)
    s_kv = rng.integers(0, 3, size=(2, 3, 40, 5)).astype(np.float32)
    s_kv[0, 0, 30:] = float(jcomb.NEG_INF)       # masked tail lanes tie too
    cfg_j = jmita.MiTAConfig(m=5, k=12)
    cfg_t = tmita.MiTAConfig(m=5, k=12)
    ji, jv = jmita.topk_indices(jnp.asarray(s_kv), cfg_j)
    ti, tv = tmita.topk_indices(torch.from_numpy(s_kv), cfg_t)
    np.testing.assert_array_equal(_np(ti), _np(ji))
    np.testing.assert_array_equal(_np(tv), _np(jv))
    r = rng.integers(0, 2, size=(4, 7, 6)).astype(np.float32)
    np.testing.assert_array_equal(
        _np(tmita.argmax_first(torch.from_numpy(r))),
        np.argmax(r, axis=-1))


@pytest.mark.parametrize("causal,g,s", [(True, 1, 1), (True, 2, 2),
                                        (False, 1, 1)])
def test_mita_attention(causal, g, s):
    rng = np.random.default_rng(4)
    b, hkv, n, d = 2, 2, 64, 16
    q = rng.standard_normal((b, hkv, g, n, d)).astype(np.float32)
    k = rng.standard_normal((b, hkv, 1, n, d)).astype(np.float32)
    v = rng.standard_normal((b, hkv, 1, n, d)).astype(np.float32)
    cfg_j = jmita.MiTAConfig(m=4, k=8, s=s, causal=causal)
    cfg_t = tmita.MiTAConfig(m=4, k=8, s=s, causal=causal)
    qlm_np = q.mean(axis=2, keepdims=True) if g > 1 else None
    jo = jmita.mita_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), cfg_j,
        q_landmarks=None if qlm_np is None else jnp.asarray(qlm_np))
    to = tmita.mita_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), cfg_t,
        q_landmarks=None if qlm_np is None else torch.from_numpy(qlm_np))
    np.testing.assert_allclose(_np(to), _np(jo), **TOL)


@pytest.mark.parametrize("s,block_q,span", [(1, 16, 4), (2, 32, 2),
                                            (1, 64, 1)])
def test_mita_attention_sparse_sorted(s, block_q, span):
    """Sorted span path against its JAX counterpart, including spans too
    short for some blocks (dropped routed branches must match)."""
    rng = np.random.default_rng(5)
    b, hkv, g, n, d = 2, 2, 2, 64, 16
    q = rng.standard_normal((b, hkv, g, n, d)).astype(np.float32)
    k = rng.standard_normal((b, hkv, 1, n, d)).astype(np.float32)
    v = rng.standard_normal((b, hkv, 1, n, d)).astype(np.float32)
    qlm = q.mean(axis=2, keepdims=True)
    cfg_j = jmita.MiTAConfig(m=4, k=8, s=s, causal=True)
    cfg_t = tmita.MiTAConfig(m=4, k=8, s=s, causal=True)
    jo = jsparse.mita_attention_sparse(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), cfg_j,
        impl="sorted", block_q=block_q, expert_span=span,
        q_landmarks=jnp.asarray(qlm))
    to = tsparse.mita_attention_sparse(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), cfg_t,
        impl="sorted", block_q=block_q, expert_span=span,
        q_landmarks=torch.from_numpy(qlm))
    np.testing.assert_allclose(_np(to), _np(jo), **TOL)

