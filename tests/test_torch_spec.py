"""Speculative decoding in the port against the JAX package, float32 at the
smoke size of qwen3-0.6b, with the JAX init's weights.

  * `mita_paged_landmark_attend` (landmark branch only; slots with
    ``m_cnt == 0`` attend the zero sink) at 1e-5;
  * the backend's triple on the same paged state, reached by the same
    prefill and plain decode steps: `lm_landmark_draft` drafts
    (``draft_steps``) and ``verify_step`` tokens equal, ``verify_step``'s
    ``q_sum`` stack and the state after ``rollback`` at 1e-5 — in both
    finalize modes, with the external-mode finalize due at verify
    position 0 for one slot, a greedy and a tempered slot, and an idle one;
  * the engines: the port's ``spec_k = 3`` streams equal the JAX engine's
    at temperatures 0 and 0.8 in both finalize modes, and equal the port's
    own ``spec_k = 0`` streams;
  * the tempered static oracle (``static_reference``) equals the JAX
    backend's, and the port's engine emits it with host and fused
    sampling.

Tokens are compared exactly: these inputs have no near-ties (the engine
test's greedy streams also equal the static path's).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_arch as jget_arch
from repro.core import mita_decode as jdec
from repro.models import transformer as jtfm
from repro.serve import EngineConfig as JEngineConfig
from repro.serve import Request as JRequest
from repro.serve import ServingEngine as JServingEngine
from repro.serve.backends.mita import MiTABackend as JMiTABackend
from repro_torch import prng
from repro_torch.configs.registry import get_arch as tget_arch
from repro_torch.convert import paged_state_from_jax, params_from_jax, \
    to_numpy
from repro_torch.core import mita_decode as tdec
from repro_torch.serve import EngineConfig, Request, ServingEngine
from repro_torch.serve.backends.mita import MiTABackend

TOL = dict(rtol=1e-5, atol=1e-5)
W = 16


@pytest.fixture(autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def smoke():
    jc = jget_arch("qwen3-0.6b", smoke=True).model
    tc = tget_arch("qwen3-0.6b", smoke=True).model
    jp = jtfm.lm_init(jax.random.PRNGKey(0), jc)
    return jc, tc, jp, params_from_jax(jax.device_get(jp))


def test_landmark_attend_vs_jax():
    rng = np.random.default_rng(0)
    s, hkv, g, m, d = 4, 2, 2, 5, 32
    cfg = jdec.DecodeConfig(window=W, k=W)
    jst = jdec.init_paged_state(hkv, d, 12, s, m, cfg, dtype=jnp.float32)
    jst = jst._replace(
        lm_q=jnp.asarray(rng.standard_normal((s, hkv, m, d)), jnp.float32),
        lm_v=jnp.asarray(rng.standard_normal((s, hkv, m, d)), jnp.float32))
    q = rng.standard_normal((s, hkv, g, d)).astype(np.float32)
    m_cnt = np.asarray([0, 1, 3, 5], np.int32)
    want = jdec.mita_paged_landmark_attend(jst, jnp.asarray(q),
                                           jnp.asarray(m_cnt), cfg)
    tst = paged_state_from_jax(jax.device_get(jst))
    before = to_numpy(tst)
    got = tdec.mita_paged_landmark_attend(
        tst, torch.from_numpy(q), torch.from_numpy(m_cnt),
        tdec.DecodeConfig(window=W, k=W))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert not got[0].any() and torch.isfinite(got).all()
    # stale rows past m_cnt do not count, and nothing is written
    tst.lm_q[1, :, 1:] = 1e3
    tst.lm_v[1, :, 1:] = -1e3
    again = tdec.mita_paged_landmark_attend(
        tst, torch.from_numpy(q), torch.from_numpy(m_cnt),
        tdec.DecodeConfig(window=W, k=W))
    np.testing.assert_array_equal(again.numpy(), got.numpy())
    for f, a in before._asdict().items():
        if f not in ("lm_q", "lm_v"):
            np.testing.assert_array_equal(getattr(to_numpy(tst), f), a)


def _backends(smoke, finalize):
    jc, tc, jp, tp = smoke
    kw = dict(n_slots=3, pages_per_slot=6, n_pages=18, sample_device="fused",
              spec_k=3, finalize=finalize)
    jb = JMiTABackend(jp, jc, JEngineConfig(**kw))
    tb = MiTABackend(tp, tc, EngineConfig(**kw), device="cpu")
    return jb, tb


@pytest.mark.parametrize("finalize", ["external", "inline"])
def test_draft_verify_rollback_vs_jax(smoke, finalize):
    jc, tc, jp, tp = smoke
    jb, tb = _backends(smoke, finalize)
    rng = np.random.default_rng(1)
    lens = (32, 32)                    # slot 2 stays idle
    prompts = [rng.integers(0, jc.vocab, n).astype(np.int32) for n in lens]
    pt = np.arange(18, dtype=np.int32).reshape(3, 6)
    tok = np.zeros(3, np.int32)
    for slot, p in enumerate(prompts):
        jl = jb.prefill_group(p[None], [slot], [list(pt[slot])])
        tl = tb.prefill_group(p[None], [slot], [list(pt[slot])])
        np.testing.assert_allclose(tl.numpy(), jl, **TOL)
        tok[slot] = np.argmax(jl[0])
        for b in (jb, tb):
            b.slot_filled(slot, len(p))
    t = np.asarray([32, 32, 0], np.int32)
    rid = np.asarray([3, 4, 0], np.int32)
    temp = np.asarray([0.0, 0.8, 0.0], np.float32)
    si = np.ones(3, np.int32)
    jkey, tkey = jax.random.PRNGKey(0), prng.PRNGKey(0)
    # plain decode to t = (48, 42), slot 1 joining after 6 steps: slot 0 is
    # then due at verify position 0 (external mode), slot 1 mid-window
    for step in range(16):
        active = np.asarray([True, step >= 6, False])
        if step in (0, 6):
            for b in (jb, tb):
                b.invalidate()
        jo = jb.decode_step(tok, t, active, pt, rid, temp, si, jkey)
        to = tb.decode_step(tok, t, active, pt, rid, temp, si, tkey)
        np.testing.assert_array_equal(to, jo)
        tok = np.where(active, to, tok).astype(np.int32)
        t, si = t + active, si + active
    for b in (jb, tb):
        b.invalidate()
    spec_len = np.where(active, np.minimum(3, tb.draft_horizon(t)), 0) \
        .astype(np.int32)
    np.testing.assert_array_equal(spec_len, np.where(
        active, np.minimum(3, jb.draft_horizon(t)), 0))
    jd = jb.draft_steps(tok, t, active, pt, rid, temp, si, jkey, spec_len)
    td = tb.draft_steps(tok, t, active, pt, rid, temp, si, tkey, spec_len)
    n = td.shape[0]
    np.testing.assert_array_equal(td, jd[:n])
    jv = jb.verify_step(tok, t, active, pt, rid, temp, si, jkey, spec_len,
                        jd)
    tv = tb.verify_step(tok, t, active, pt, rid, temp, si, tkey, spec_len,
                        td)
    assert tv.shape[0] == int(spec_len.max()) + 1
    np.testing.assert_array_equal(tv[:, active], jv[:tv.shape[0], active])
    np.testing.assert_allclose(tb._q_stack.numpy(),
                               np.asarray(jb._q_stack)[:tv.shape[0]], **TOL)
    np.testing.assert_array_equal(tb.m_done, jb.m_done)
    if finalize == "external":
        assert tb.m_done[0] == 3         # the position-0 finalize ran
    commits = np.ones(3, np.int32)
    for slot in (0, 1):
        j = 0
        while j < spec_len[slot] and td[j, slot] == tv[j, slot]:
            j += 1
        commits[slot] = j + 1
    commits[1] = max(commits[1], 2)      # a partial commit, rolled back
    jb.rollback(commits, active)
    tb.rollback(commits, active)
    for f, a in to_numpy(tb.states)._asdict().items():
        b = np.asarray(getattr(jb.states, f))
        if a.dtype.kind in "biu":
            np.testing.assert_array_equal(a, b, err_msg=f)
        else:
            np.testing.assert_allclose(a, b, err_msg=f, **TOL)


SPECS = [(W, 5), (2 * W, 9), (2 * W, 4), (W, 20)]


def _requests(cls, vocab, temperature):
    rng = np.random.default_rng(7)
    return [cls(rid=i, prompt=rng.integers(0, vocab, n).astype(np.int32),
                max_new_tokens=g, temperature=temperature)
            for i, (n, g) in enumerate(SPECS)]


@pytest.mark.parametrize("temperature", [0.0, 0.8])
@pytest.mark.parametrize("finalize", ["external", "inline"])
def test_engine_spec_streams_vs_jax(smoke, finalize, temperature):
    jc, tc, jp, tp = smoke
    kw = dict(n_slots=3, pages_per_slot=4, n_pages=24, prefill_chunk=W,
              sample_device="fused", finalize=finalize)
    jeng = JServingEngine(jp, jc, JEngineConfig(spec_k=3, **kw))
    want = {f.rid: f.tokens.tolist()
            for f in jeng.run(_requests(JRequest, jc.vocab, temperature))}
    got = {}
    for k in (0, 3):
        eng = ServingEngine(tp, tc, EngineConfig(spec_k=k, **kw),
                            device="cpu")
        done = eng.run(_requests(Request, tc.vocab, temperature))
        assert [f.reason for f in done] == ["complete"] * len(SPECS)
        got[k] = {f.rid: f.tokens.tolist() for f in done}
    assert got[3] == got[0], "spec_k=3 diverged from spec_k=0"
    assert got[3] == want, "spec_k=3 diverged from the JAX engine"
    st, jst = eng.stats(), jeng.stats()
    for key in ("spec_drafted", "spec_accepted", "spec_rollbacks"):
        assert st[key] == jst[key], key
    assert st["spec_drafted"] > 0


def test_static_reference_tempered_vs_jax_and_engine(smoke):
    """The backends' tempered oracle (static steps, the engine's
    (rid, index)-keyed host rule, key PRNGKey(0)) equals the JAX backend's,
    and the port's engine emits it with host and with fused sampling."""
    jc, tc, jp, tp = smoke
    jb, tb = _backends(smoke, "external")
    prompts = np.random.default_rng(9).integers(0, jc.vocab, (2, 32)) \
        .astype(np.int32)
    rids = [5, 6]
    want = jb.static_reference(prompts, 20, temperature=0.8, rids=rids)
    got = tb.static_reference(prompts, 20, temperature=0.8, rids=rids)
    np.testing.assert_array_equal(got, np.asarray(want))
    for device in ("host", "fused"):
        eng = ServingEngine(tp, tc, EngineConfig(
            n_slots=2, pages_per_slot=4, n_pages=8, sample_device=device),
            device="cpu")
        done = eng.run([Request(rid=r, prompt=p, max_new_tokens=20,
                                temperature=0.8)
                        for r, p in zip(rids, prompts)])
        np.testing.assert_array_equal(np.stack([f.tokens for f in done]),
                                      got, err_msg=device)
