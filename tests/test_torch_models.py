"""The port's LM against the JAX reference on the smoke size of
qwen3-0.6b (2 layers, d_model 128, 4 heads, 2 KV heads, head_dim 32,
vocab 251, w = k = 16, float32), with the JAX init's weights carried over
by `repro_torch.convert`.  Floats agree to atol = rtol = 1e-5; expert rows,
validity and greedy tokens are exact.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_arch as jget_arch
from repro.core import mita_decode as jdec
from repro.launch.serve import static_generate as jstatic_generate
from repro.models import transformer as jtfm
from repro_torch import prng
from repro_torch.configs.registry import get_arch as tget_arch
from repro_torch.convert import (decode_state_from_jax, full_state_from_jax,
                                 params_from_jax, paged_state_from_jax,
                                 to_numpy)
from repro_torch.launch.serve import static_generate as tstatic_generate
from repro_torch.models import transformer as ttfm

TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _cfgs(external=False):
    jc = jget_arch("qwen3-0.6b", smoke=True).model
    tc = tget_arch("qwen3-0.6b", smoke=True).model
    jc = dataclasses.replace(jc, attn=dataclasses.replace(
        jc.attn, external_finalize=external))
    tc = dataclasses.replace(tc, attn=dataclasses.replace(
        tc.attn, external_finalize=external))
    return jc, tc


@pytest.fixture(scope="module")
def weights():
    jc, _ = _cfgs()
    jp = jtfm.lm_init(jax.random.PRNGKey(0), jc)
    return jp, params_from_jax(jax.device_get(jp))


def _prompts(b, n, vocab=251, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (b, n)).astype(
        np.int32)


def _assert_tree(tree_t, tree_j):
    for f, a in to_numpy(tree_t)._asdict().items():
        b = np.asarray(getattr(tree_j, f))
        if a.dtype.kind in "biu":
            np.testing.assert_array_equal(a, b, err_msg=f)
        else:
            np.testing.assert_allclose(a, b, err_msg=f, **TOL)


def test_convert_round_trip_and_init_layout(weights):
    """Every converted leaf keeps the JAX shape, dtype and values, and the
    port's own `lm_init` builds the same layout."""
    jp, tp = weights
    _, tc = _cfgs()
    own = ttfm.lm_init(torch.Generator().manual_seed(0), tc, device="cpu")
    jl = jax.tree_util.tree_leaves_with_path(jax.device_get(jp))
    assert len(jl) == len(jax.tree_util.tree_leaves(to_numpy(own)))
    for path, leaf in jl:
        node_t, node_o = tp, own
        for p in path:
            node_t, node_o = node_t[p.key], node_o[p.key]
        assert tuple(node_t.shape) == leaf.shape == tuple(node_o.shape)
        assert str(node_t.dtype).endswith(str(leaf.dtype))
        assert node_o.dtype == node_t.dtype
        np.testing.assert_array_equal(node_t.numpy(), np.asarray(leaf))


def test_lm_forward(weights):
    jp, tp = weights
    jc, tc = _cfgs()
    toks = _prompts(2, 32)
    jl, _ = jtfm.lm_forward(jp, jnp.asarray(toks), jc)
    tl = ttfm.lm_forward(tp, torch.from_numpy(toks), tc)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)


@pytest.mark.parametrize("n", [32, 12])
def test_lm_prefill_states(weights, n):
    """Prefill logits and every leaf of every layer's decode state (n = 12
    is shorter than a window: no landmark yet, the open window's q_sum is
    carried)."""
    jp, tp = weights
    jc, tc = _cfgs()
    toks = _prompts(2, n)
    jl, jst = jtfm.lm_prefill(jp, jnp.asarray(toks), jc, 64)
    tl, tst = ttfm.lm_prefill(tp, torch.from_numpy(toks), tc, 64)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    _assert_tree(tst, jst)


@pytest.mark.parametrize("external", [False, True])
def test_lm_decode_40_steps(weights, external):
    """40 teacher-forced decode steps from a prefill (crossing windows at
    48 and 64), with `lm_finalize_states` at boundaries in external mode;
    logits every step, the final states leaf by leaf."""
    jp, tp = weights
    jc, tc = _cfgs(external)
    n, steps = 32, 40
    toks = _prompts(2, n)
    feed = _prompts(2, steps, seed=1)
    jl, jst = jtfm.lm_prefill(jp, jnp.asarray(toks), jc, 80)
    _, tst = ttfm.lm_prefill(tp, torch.from_numpy(toks), tc, 80)
    jstep = jax.jit(lambda st, tok, pos: jtfm.lm_decode_step(
        jp, st, tok, pos, jc))
    jfin = jax.jit(lambda st: jtfm.lm_finalize_states(st, jc))
    for i in range(steps):
        pos = n + i
        if external and pos % 16 == 0:
            jst = jfin(jst)
            tst = ttfm.lm_finalize_states(tst, tc)
        jl, jst = jstep(jst, jnp.asarray(feed[:, i]), jnp.asarray(pos))
        tl, tst = ttfm.lm_decode_step(tp, tst, torch.from_numpy(feed[:, i]),
                                      pos, tc)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   err_msg=f"step {i}", **TOL)
    _assert_tree(tst, jst)


def test_lm_paged_decode_step(weights):
    """Prefill two requests into shuffled pages (`pack_prefill_into_states`)
    and run the fused paged step beside JAX's, with the external finalize
    fired from the host ``due`` when a slot closes a window."""
    jp, tp = weights
    jc, tc = _cfgs(external=True)
    n, steps, w, m_slot = 32, 20, 16, 4
    toks = _prompts(2, n)
    n_pages = 10
    table = np.asarray([[7, 2, 9, 4], [1, 8, 3, 6]], np.int32)
    jst = jtfm.init_paged_states(jc, 2, n_pages, m_slot)
    _, jpre = jtfm.lm_prefill(jp, jnp.asarray(toks), jc, n)
    tst = ttfm.init_paged_states(tc, 2, n_pages, m_slot, device="cpu")
    _, tpre = ttfm.lm_prefill(tp, torch.from_numpy(toks), tc, n)
    for s in range(2):
        jpre_s = jax.tree.map(lambda a: a[:, s:s + 1] if a.ndim >= 2 else a,
                              jpre)
        jst = jtfm.pack_prefill_into_states(jst, jpre_s, s,
                                            jnp.asarray(table[s, :2]), jc)
        tpre_s = type(tpre)(*(x[:, s:s + 1] if x.ndim >= 2 else x
                              for x in tpre))
        ttfm.pack_prefill_into_states(tst, tpre_s, s,
                                      torch.from_numpy(table[s, :2]), tc)
    _assert_tree(tst, jst)
    jstep = jax.jit(lambda st, tok, pos, due: jtfm.lm_paged_decode_step(
        jp, st, tok, pos, jnp.asarray(table), jnp.ones(2, bool), jc,
        due=due))
    t = np.full(2, n, np.int32)
    m_done = t // w
    feed = _prompts(2, steps, seed=2)
    for i in range(steps):
        due = (t % w == 0) & (t // w > m_done)
        m_done = np.where(due, t // w, m_done)
        jl, jst = jstep(jst, jnp.asarray(feed[:, i]), jnp.asarray(t),
                        jnp.asarray(due))
        tl, tst = ttfm.lm_paged_decode_step(
            tp, tst, torch.from_numpy(feed[:, i]), torch.from_numpy(t),
            torch.from_numpy(table), torch.ones(2, dtype=torch.bool), tc,
            due=due)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   err_msg=f"step {i}", **TOL)
        t = t + 1
    fields = jdec.PagedMiTAState._fields
    for f in fields:
        a = to_numpy(getattr(tst, f))
        b = np.asarray(getattr(jst, f))
        if f in ("k_pool", "v_pool"):
            a, b = a[:, :-1], b[:, :-1]
        if a.dtype.kind in "biu":
            np.testing.assert_array_equal(a, b, err_msg=f)
        else:
            np.testing.assert_allclose(a, b, err_msg=f, **TOL)


def test_state_converters_keep_layout(weights):
    jp, _ = weights
    jc, _ = _cfgs()
    _, jst = jtfm.lm_prefill(jp, jnp.asarray(_prompts(1, 32)), jc, 48)
    tst = decode_state_from_jax(jax.device_get(jst))
    _assert_tree(tst, jst)
    pst = jtfm.init_paged_states(jc, 2, 6, 3)
    tp = paged_state_from_jax(jax.device_get(pst))
    for f in jdec.PagedMiTAState._fields:
        assert tuple(getattr(tp, f).shape) == getattr(pst, f).shape


def test_sample_tokens_first_index_and_nan():
    """Greedy rows take the first index of the maximum (a NaN row its first
    NaN); a tempered row in the same batch leaves the greedy rows alone
    and draws what `jax.random` draws for its (rid, index) key."""
    logits = torch.tensor([[1.0, 3.0, 3.0, 0.0],
                           [float("nan"), 5.0, float("nan"), 1.0],
                           [2.0, 2.0, 2.0, 2.0]])
    rid = np.asarray([4, 5, 6], np.int32)
    idx = np.asarray([0, 1, 2], np.int32)
    greedy = np.zeros(3, np.float32)
    np.testing.assert_array_equal(
        ttfm.sample_tokens(logits, rid, idx, greedy, prng.PRNGKey(0))
        .numpy(), [1, 0, 0])
    temp = np.asarray([0.0, 0.0, 0.5], np.float32)
    got = ttfm.sample_tokens(logits, rid, idx, temp, prng.PRNGKey(0))
    want = jtfm.sample_tokens(jnp.asarray(logits.numpy()), jnp.asarray(rid),
                   jnp.asarray(idx), jnp.asarray(temp),
                   jax.random.PRNGKey(0))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.numpy()[:2].tolist() == [1, 0]


@pytest.mark.parametrize("backend", ["full", "agent"])
def test_non_mita_backend_decodes_on_full_cache(weights, backend):
    """ROADMAP C.14: a backend other than mita / mita_ref prefills and
    decodes on a full-attention cache, as the reference does.  The same
    weights through both packages: `lm_prefill`'s states leaf by leaf,
    the prefill and 24 decode steps' logits within 1e-5, and
    `static_generate`'s greedy tokens equal (before the repair the port
    decoded with MiTA and emitted the mita stream)."""
    jp, tp = weights
    jc, tc = (dataclasses.replace(c, attn=dataclasses.replace(
        c.attn, backend=backend)) for c in _cfgs())
    toks = _prompts(2, 16)
    feed = _prompts(2, 24, seed=1)
    jl, jst = jtfm.lm_prefill(jp, jnp.asarray(toks), jc, 48)
    tl, tst = ttfm.lm_prefill(tp, torch.from_numpy(toks), tc, 48)
    assert isinstance(jst, jdec.FullDecodeState)
    assert type(tst).__name__ == "FullDecodeState"
    _assert_tree(tst, jst)
    _assert_tree(full_state_from_jax(jax.device_get(jst)), jst)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    for i in range(feed.shape[1]):
        jl, jst = jtfm.lm_decode_step(jp, jst, jnp.asarray(feed[:, i]),
                                      jnp.asarray(16 + i), jc)
        tl, tst = ttfm.lm_decode_step(tp, tst, torch.from_numpy(feed[:, i]),
                                      16 + i, tc)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    _assert_tree(tst, jst)
    jt, _ = jstatic_generate(jp, jc, jnp.asarray(toks), 24)
    tt, _ = tstatic_generate(tp, tc, torch.from_numpy(toks), 24)
    np.testing.assert_array_equal(tt, np.asarray(jt))
    empty = ttfm.init_decode_states(tc, 2, 48, device="cpu")
    assert type(empty).__name__ == "FullDecodeState"
    assert tuple(empty.k_cache.shape) == (tc.n_layers, 2, tc.n_kv, 48, tc.dh)
