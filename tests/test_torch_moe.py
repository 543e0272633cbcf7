"""The MoE family (deepseek-moe-16b, dbrx-132b) and the VLM inputs
(internvl2-76b) on the port, held to the JAX reference at the smoke size
(2 layers, d_model 128, 8 experts top-2, d_ff 64, vocab 251, w = k = 16,
float32), with the JAX init's weights carried over by `repro_torch.convert`.

  * `moe._dispatch_slots` and the routing decisions (gate picks, queue
    slots, ``keep``) are exact; `moe_apply` outputs agree within 1e-5, the
    aux loss within 1e-6, with and without drops and shared experts, at
    token counts whose gcd with 16 is 1, 4 and 16, and on exact gate ties.
  * ``lm_forward`` / ``lm_loss`` (aux included) / ``lm_prefill``, the
    decode steps and both chunk prefills agree within 1e-5 (integers
    exact).
  * The port's monolithic, batched-chunk and per-job engines give the JAX
    engine's greedy tokens with the real capacity factor while prefills
    drop tokens; a preempted MoE stream equals the JAX engine's preempted
    stream; ``spec_k`` 3 equals ``spec_k`` 0.
  * internvl2-76b: ``image_embeds`` / ``extra_embeds`` over the first P
    positions.
  * The three configs equal the reference's field by field.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import arch_params as jarch_params
from repro.configs.registry import get_arch as jget_arch
from repro.models import moe as jmoe
from repro.models import transformer as jtfm
from repro.models.modules import ModelConfig as JModelConfig
from repro.serve import EngineConfig as JEngineConfig
from repro.serve import Request as JRequest
from repro.serve import ServingEngine as JServingEngine
from repro_torch.configs.registry import get_arch as tget_arch
from repro_torch.convert import params_from_jax, to_numpy
from repro_torch.kernels import ops
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as ttfm
from repro_torch.serve import EngineConfig, Request, ServingEngine
from test_torch_dense_serve import _assert_fields_equal

TOL = dict(atol=1e-5, rtol=1e-5)
MOE = ("deepseek-moe-16b", "dbrx-132b")
W = 16


@pytest.fixture(autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module", params=MOE)
def smoke(request):
    ja = jget_arch(request.param, smoke=True)
    ta = tget_arch(request.param, smoke=True)
    jp = jarch_params(ja, jax.random.PRNGKey(0))
    return ja.model, ta.model, jp, params_from_jax(jax.device_get(jp))


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _prompts(b, n, vocab=251, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (b, n)).astype(
        np.int32)


# ----------------------------------------------------------- moe_apply ----

@pytest.mark.parametrize("t,e", [(40, 8), (96, 16), (7, 4)])
def test_dispatch_slots_exact(t, e):
    """Stable queue ranks on random assignments that include the drop
    sentinel ``e``, and batched over a leading axis."""
    rng = np.random.default_rng(t)
    assign = rng.integers(0, e + 1, (3, t)).astype(np.int32)
    got = tmoe._dispatch_slots(torch.from_numpy(assign), e)
    assert got.dtype == torch.int32
    for i in range(3):
        want = jmoe._dispatch_slots(jnp.asarray(assign[i]), e)
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(want))


def _jax_routing(jp, x, cfg):
    """The reference's routing decisions, as `moe.moe_apply` computes
    them: gate picks, queue slots and ``keep`` per group."""
    b, n, d = x.shape
    g = math.gcd(b * n, 16)
    tg = b * n // g
    gates = jax.nn.softmax(jnp.asarray(x).reshape(g, tg, d)
                           @ jp["router"], axis=-1)
    _, idx = jax.lax.top_k(gates, cfg.moe_top_k)
    cap = max(8, int(math.ceil(tg * cfg.moe_top_k / cfg.n_experts
                               * cfg.moe_capacity_factor)))
    cap = (cap + 7) // 8 * 8
    slot = jax.vmap(lambda a: jmoe._dispatch_slots(a, cfg.n_experts))(
        idx.reshape(g, -1))
    return np.asarray(idx), np.asarray(slot), cap


def _moe_pair(cfg_name, **over):
    jc = dataclasses.replace(jget_arch(cfg_name, smoke=True).model, **over)
    tc = dataclasses.replace(tget_arch(cfg_name, smoke=True).model, **over)
    jp = jmoe.moe_init(jax.random.PRNGKey(1), jc)
    return jc, tc, jp, params_from_jax(jax.device_get(jp))


@pytest.mark.parametrize("bn", [(1, 33), (3, 28), (2, 136)],
                         ids=["gcd1", "gcd4", "gcd16"])
@pytest.mark.parametrize("shared", [0, 1])
@pytest.mark.parametrize("cf", [1.25, 8.0], ids=["drops", "no_drops"])
def test_moe_apply_vs_jax(bn, shared, cf):
    """Outputs within 1e-5 and aux within 1e-6 of the reference; the gate
    picks, queue slots and kept assignments exact.  The tokens share a
    common direction, so routing is skewed: with capacity factor 1.25 at
    least one assignment drops, at 8 (capacity >= the group) none does."""
    jc, tc, jp, tp = _moe_pair("deepseek-moe-16b", n_shared_experts=shared,
                               moe_capacity_factor=cf)
    b, n = bn
    rng = np.random.default_rng(b * n)
    x = (rng.standard_normal((1, 1, jc.d_model))
         + 0.5 * rng.standard_normal((b, n, jc.d_model))).astype(np.float32)
    jo, ja = jmoe.moe_apply(jp, jnp.asarray(x), jc)
    to, ta = tmoe.moe_apply(tp, torch.from_numpy(x), tc)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **TOL)
    np.testing.assert_allclose(ta.item(), float(ja), atol=1e-6, rtol=0)
    idx, slot, cap = _jax_routing(jp, x, jc)
    g = math.gcd(b * n, 16)
    r = tmoe.route(tp, torch.from_numpy(x).reshape(g, -1, jc.d_model), tc)
    assert r.cap == cap
    np.testing.assert_array_equal(r.gate_idx.numpy(), idx)
    np.testing.assert_array_equal(r.slot.numpy(), slot)
    dropped = int((slot >= cap).sum())
    assert (dropped > 0) == (cf == 1.25)


@pytest.mark.parametrize("router", ["zero", "duplicate_columns"])
def test_moe_gate_ties_pick_the_first_index(router):
    """Exactly tied gates: the first index wins, as ``jax.lax.top_k``, and
    the picks, slots and outputs equal the reference's."""
    jc, tc, jp, _ = _moe_pair("dbrx-132b", moe_capacity_factor=1.25)
    r = np.asarray(jp["router"])
    if router == "zero":
        r = np.zeros_like(r)
    else:
        r = np.concatenate([r[:, :4], r[:, :4]], axis=1)
    jp = dict(jp, router=jnp.asarray(r))
    tp = params_from_jax(jax.device_get(jp))
    x = np.random.default_rng(3).standard_normal(
        (2, 40, jc.d_model)).astype(np.float32)
    jo, ja = jmoe.moe_apply(jp, jnp.asarray(x), jc)
    to, ta = tmoe.moe_apply(tp, torch.from_numpy(x), tc)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **TOL)
    np.testing.assert_allclose(ta.item(), float(ja), atol=1e-6, rtol=0)
    idx, slot, _ = _jax_routing(jp, x, jc)
    r = tmoe.route(tp, torch.from_numpy(x).reshape(16, -1, jc.d_model), tc)
    np.testing.assert_array_equal(r.gate_idx.numpy(), idx)
    np.testing.assert_array_equal(r.slot.numpy(), slot)
    t_idx = r.gate_idx.numpy()
    if router == "zero":
        assert (t_idx == np.arange(jc.moe_top_k)).all()
    else:
        # expert j + 4 is j's copy: the first copy, then its twin
        assert (t_idx[..., 0] < 4).all()
        assert (t_idx[..., 1] == t_idx[..., 0] + 4).all()


def test_moe_init_layout():
    """`moe_init` matches the reference's leaves (shapes, dtypes), and its
    stacked form gives each layer the reference's scales."""
    jc, tc, jp, _ = _moe_pair("deepseek-moe-16b")
    own = tmoe.moe_init(torch.Generator().manual_seed(0), tc, "cpu")
    stacked = tmoe.moe_init(torch.Generator().manual_seed(0), tc, "cpu",
                            n_layers=3)
    for path, leaf in jax.tree_util.tree_leaves_with_path(
            jax.device_get(jp)):
        a, s = own, stacked
        for p in path:
            a, s = a[p.key], s[p.key]
        assert tuple(a.shape) == leaf.shape
        assert tuple(s.shape) == (3, *leaf.shape)
        assert str(a.dtype).endswith(str(leaf.dtype))
        std = float(np.std(np.asarray(leaf)))
        for i in range(3):
            assert abs(float(s[i].std()) / std - 1) < 0.1


# --------------------------------------------------------- the model ------

def _with_impl(cfg, impl):
    return dataclasses.replace(cfg, attn=dataclasses.replace(cfg.attn,
                                                             impl=impl))


@pytest.mark.parametrize("impl", ["sorted", "pallas"])
def test_lm_forward_loss_prefill(smoke, impl):
    """lm_forward logits, lm_loss with the aux term and lm_prefill's
    logits and states at N = 64 (impl="pallas": the plain B.4 on the
    CPU, no launch)."""
    jc, tc, jp, tp = smoke
    jc, tc = _with_impl(jc, impl), _with_impl(tc, impl)
    toks = _prompts(2, 64)
    labels = _prompts(2, 64, seed=1)
    jl, jaux = jtfm.lm_forward(jp, jnp.asarray(toks), jc)
    ops.reset_launch_counts()
    tl, taux = ttfm.lm_forward_aux(tp, torch.from_numpy(toks), tc)
    assert ops.launch_counts()["mita_expert_attention"] == 0
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    np.testing.assert_allclose(taux.item(), float(jaux), atol=1e-6, rtol=0)
    assert float(jaux) > 0
    batch = {"tokens": toks, "labels": labels}
    jv = jtfm.lm_loss(jp, {k: jnp.asarray(v) for k, v in batch.items()}, jc)
    tv = ttfm.lm_loss(tp, batch, tc)
    np.testing.assert_allclose(tv.item(), float(jv), **TOL)
    if impl == "sorted":
        jl, jst = jtfm.lm_prefill(jp, jnp.asarray(toks), jc, 96)
        tl, tst = ttfm.lm_prefill(tp, torch.from_numpy(toks), tc, 96)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        _assert_tree(tst, jst)


def _assert_tree(tree_t, tree_j, skip_scratch=False):
    for f, a in to_numpy(tree_t)._asdict().items():
        b = np.asarray(getattr(tree_j, f))
        if skip_scratch and f in ("k_pool", "v_pool"):
            a, b = a[:, :-1], b[:, :-1]
        if a.dtype.kind in "biu":
            np.testing.assert_array_equal(a, b, err_msg=f)
        else:
            np.testing.assert_allclose(a, b, err_msg=f, **TOL)


def test_decode_steps(smoke):
    """20 teacher-forced monolithic decode steps from a prefill, then a
    paged decode step over two slots (one inactive), against JAX: the MoE
    sees [S, 1, D] in both."""
    jc, tc, jp, tp = smoke
    n, steps = 32, 20
    toks = _prompts(2, n)
    feed = _prompts(2, steps, seed=1)
    _, jst = jtfm.lm_prefill(jp, jnp.asarray(toks), jc, 64)
    _, tst = ttfm.lm_prefill(tp, torch.from_numpy(toks), tc, 64)
    jstep = jax.jit(lambda st, tok, pos: jtfm.lm_decode_step(
        jp, st, tok, pos, jc))
    for i in range(steps):
        jl, jst = jstep(jst, jnp.asarray(feed[:, i]), jnp.asarray(n + i))
        tl, tst = ttfm.lm_decode_step(tp, tst, torch.from_numpy(feed[:, i]),
                                      n + i, tc)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   err_msg=f"step {i}", **TOL)
    _assert_tree(tst, jst)

    table = np.asarray([[3, 1, 4, 0], [2, 5, 6, 7]], np.int32)
    jps = jtfm.init_paged_states(jc, 2, 8, 4)
    tps = ttfm.init_paged_states(tc, 2, 8, 4, device="cpu")
    t = np.asarray([5, 0], np.int32)
    act = np.asarray([True, False])
    jpaged = jax.jit(lambda st, tok, pos: jtfm.lm_paged_decode_step(
        jp, st, tok, pos, jnp.asarray(table), jnp.asarray(act), jc))
    for i in range(3):
        jl, jps = jpaged(jps, jnp.asarray(feed[:, i]), jnp.asarray(t + i))
        tl, tps = ttfm.lm_paged_decode_step(
            tp, tps, torch.from_numpy(feed[:, i]), torch.from_numpy(t + i),
            torch.from_numpy(table), torch.from_numpy(act), tc)
        np.testing.assert_allclose(tl.numpy()[act], np.asarray(jl)[act],
                                   **TOL)
    _assert_tree(tps, jps, skip_scratch=True)


@pytest.mark.parametrize("mode", ["batched", "per-job"])
def test_chunk_prefills(smoke, mode):
    """Chunk prefills of a 96-token and a 72-token prompt (chunk 64: the
    second chunk ragged) into slots 2 and 0: logits and every layer's
    state against JAX.  Batched: both rows in one dispatch of [2, 64]
    tokens; per-job: one row a call."""
    jc, tc, jp, tp = smoke
    m_slot, n_pages, nc = 8, 16, 64
    jst = jtfm.init_paged_states(jc, 3, n_pages, m_slot)
    tst = ttfm.init_paged_states(tc, 3, n_pages, m_slot, device="cpu")
    rng = np.random.default_rng(2)
    ntr = np.asarray([96, 72], np.int32)
    prompts = [rng.integers(0, jc.vocab, n).astype(np.int32) for n in ntr]
    table = rng.permutation(n_pages)[: 2 * m_slot].reshape(2, m_slot).astype(
        np.int32)
    slots = np.asarray([2, 0], np.int32)
    done = np.zeros(2, np.int32)
    t = torch.from_numpy
    jchunks = jax.jit(lambda p, s, *a: jtfm.lm_prefill_chunks(p, s, *a, jc))
    jchunk = jax.jit(lambda p, s, *a: jtfm.lm_prefill_chunk(p, s, *a, jc))
    while (done < ntr).any():
        nv = np.minimum(nc, ntr - done).astype(np.int32)
        act = nv > 0
        toks = np.zeros((2, nc), np.int32)
        for i in range(2):
            toks[i, : nv[i]] = prompts[i][done[i]:done[i] + nv[i]]
        if mode == "batched":
            args = (toks, act, table, slots, done.copy(), nv, ntr)
            lj, jst = jchunks(jp, jst, *(jnp.asarray(a) for a in args))
            lt, tst = ttfm.lm_prefill_chunks(tp, tst, *(t(a) for a in args),
                                             tc)
            np.testing.assert_allclose(lt.numpy()[act], np.asarray(lj)[act],
                                       **TOL)
        else:
            for i in np.nonzero(act)[0]:
                lj, jst = jchunk(
                    jp, jst, jnp.asarray(toks[i]), jnp.asarray(slots[i]),
                    jnp.asarray(table[i]), jnp.asarray(done[i]),
                    jnp.asarray(nv[i]), jnp.asarray(ntr[i]))
                lt, tst = ttfm.lm_prefill_chunk(
                    tp, tst, t(toks[i]), int(slots[i]), t(table[i]),
                    int(done[i]), int(nv[i]), int(ntr[i]), tc)
                np.testing.assert_allclose(lt.numpy(), np.asarray(lj),
                                           **TOL)
        _assert_tree(tst, jst, skip_scratch=True)
        done = done + nv


# ------------------------------------------------------------ engines -----

class _DropCounter:
    """Counts the assignments the port's MoE prefills drop (calls with
    more than one token a row)."""

    def __init__(self, monkeypatch):
        self.dropped = 0
        apply = ttfm.moe_apply

        def counting(p, x, cfg, tp=None):
            b, n, d = x.shape
            if n > 1:
                g = math.gcd(b * n, tmoe.MOE_GROUPS)
                r = tmoe.route(p, x.reshape(g, -1, d), cfg)
                self.dropped += int((r.slot >= r.cap).sum())
            return apply(p, x, cfg, tp)

        monkeypatch.setattr(ttfm, "moe_apply", counting)


ENGINE_MODES = {"monolithic": dict(prefill_chunk=0),
                "batched": dict(prefill_chunk=128),
                "per-job": dict(prefill_chunk=256, prefill_mode="per-job")}


@pytest.mark.parametrize("mode", list(ENGINE_MODES))
def test_engines_match_jax_engine_with_drops(smoke, mode, monkeypatch):
    """Four prompts of 256 and 288 tokens, 12 new tokens each, two slots,
    the real capacity factor 1.25: the port's engine gives the JAX
    engine's greedy tokens while its prefills drop assignments (chunks of
    128 tokens on two rows and of 256 on one row hold 16 tokens a group,
    past the capacity of 8)."""
    jc, tc, jp, tp = smoke
    assert tc.moe_capacity_factor == 1.25
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, tc.vocab, n).astype(np.int32)
               for n in (256, 288, 256, 288)]
    gen = 12
    pages = -(-(288 + gen) // W)
    kw = dict(n_slots=2, pages_per_slot=pages, n_pages=2 * pages + 2,
              **ENGINE_MODES[mode])
    want = JServingEngine(jp, jc, JEngineConfig(**kw)).run(
        [JRequest(rid=i, prompt=p, max_new_tokens=gen)
         for i, p in enumerate(prompts)])
    drops = _DropCounter(monkeypatch)
    got = ServingEngine(tp, tc, EngineConfig(**kw), device="cpu").run(
        [Request(rid=i, prompt=p, max_new_tokens=gen)
         for i, p in enumerate(prompts)])
    assert drops.dropped > 0
    assert [f.reason for f in got] == ["complete"] * len(prompts)
    for f, jf in zip(got, want):
        np.testing.assert_array_equal(f.tokens, np.asarray(jf.tokens),
                                      err_msg=f"request {f.rid}")


def _preempted_run(eng_cls, req_cls, params, cfg, ecfg, device=None):
    """A 3-window victim decoding 24 tokens, evicted by two priority-5
    arrivals after 6 steps (the reference's preemption scenario)."""
    rng = np.random.default_rng(5)
    victim = rng.integers(0, cfg.vocab, 3 * W).astype(np.int32)
    hp = rng.integers(0, cfg.vocab, (2, 2 * W)).astype(np.int32)
    eng = (eng_cls(params, cfg, ecfg) if device is None
           else eng_cls(params, cfg, ecfg, device=device))
    eng.submit(req_cls(rid=0, prompt=victim, max_new_tokens=24, priority=0))
    for _ in range(6):
        eng.step()
    for i in range(2):
        eng.submit(req_cls(rid=1 + i, prompt=hp[i], max_new_tokens=24,
                           priority=5))
    while eng.step():
        pass
    done = sorted(eng.finished, key=lambda f: f.rid)
    return eng, {f.rid: np.asarray(f.tokens).tolist() for f in done}


def test_moe_preemption_round_trip(smoke):
    """The preempted MoE streams equal the JAX engine's on the same
    schedule (recompute-from-prompt included), and the port's spec_k = 3
    streams equal its spec_k = 0 streams."""
    jc, tc, jp, tp = smoke
    kw = dict(n_slots=2, pages_per_slot=6, n_pages=8, prefill_chunk=2 * W)
    jeng, want = _preempted_run(JServingEngine, JRequest, jp, jc,
                                JEngineConfig(**kw))
    eng, got = _preempted_run(ServingEngine, Request, tp, tc,
                              EngineConfig(**kw), "cpu")
    assert eng.n_preemptions >= 1 and eng.n_preemptions == jeng.n_preemptions
    assert got == want
    spec = {}
    for k in (0, 3):
        _, spec[k] = _preempted_run(
            ServingEngine, Request, tp, tc,
            EngineConfig(sample_device="fused", spec_k=k, **kw), "cpu")
    assert spec[3] == spec[0]


# ----------------------------------------------------------------- vlm ----

def test_vlm_image_embeds():
    """internvl2-76b at the smoke size: lm_forward and lm_loss with 16
    image embeddings over the first positions, lm_prefill with
    ``extra_embeds``, against JAX; the embeddings change the logits."""
    ja = jget_arch("internvl2-76b", smoke=True)
    ta = tget_arch("internvl2-76b", smoke=True)
    assert ta.family == "vlm" and ta.n_img_tokens == 16
    jc, tc = ja.model, ta.model
    jp = jarch_params(ja, jax.random.PRNGKey(0))
    tp = params_from_jax(jax.device_get(jp))
    toks = _prompts(2, 48)
    img = np.random.default_rng(9).standard_normal(
        (2, ta.n_img_tokens, tc.d_model)).astype(np.float32)
    jl, _ = jtfm.lm_forward(jp, jnp.asarray(toks), jc,
                            extra_embeds=jnp.asarray(img))
    tl = ttfm.lm_forward(tp, torch.from_numpy(toks), tc,
                         extra_embeds=torch.from_numpy(img))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    plain = ttfm.lm_forward(tp, torch.from_numpy(toks), tc)
    assert not torch.allclose(plain, tl)
    batch = {"tokens": toks, "labels": _prompts(2, 48, seed=1),
             "image_embeds": img}
    jv = jtfm.lm_loss(jp, {k: jnp.asarray(v) for k, v in batch.items()}, jc)
    tv = ttfm.lm_loss(tp, batch, tc)
    np.testing.assert_allclose(tv.item(), float(jv), **TOL)
    jl, jst = jtfm.lm_prefill(jp, jnp.asarray(toks), jc, 64,
                              extra_embeds=jnp.asarray(img))
    tl, tst = ttfm.lm_prefill(tp, torch.from_numpy(toks), tc, 64,
                              extra_embeds=torch.from_numpy(img))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    _assert_tree(tst, jst)


# ------------------------------------------------------------- configs ----

@pytest.mark.parametrize("smoke_size", [False, True])
@pytest.mark.parametrize("name", MOE + ("internvl2-76b",))
def test_config_equals_reference(name, smoke_size):
    ja = jget_arch(name, smoke=smoke_size)
    ta = tget_arch(name, smoke=smoke_size)
    assert (ta.arch_id, ta.family, ta.notes, ta.n_img_tokens) == (
        ja.arch_id, ja.family, ja.notes, ja.n_img_tokens)
    _assert_fields_equal(ta.model, ja.model, JModelConfig, name)


def test_moe_head_shapes():
    """What these configs bring to the kernels at head dim 128: Hkv 16,
    G 1 (deepseek), Hkv 8, G 6 (dbrx: the first group size that is not a
    power of two) and Hkv 8, G 8 (internvl2)."""
    got = {n: (tget_arch(n).model.n_kv, tget_arch(n).model.group,
               tget_arch(n).model.dh)
           for n in MOE + ("internvl2-76b",)}
    assert got == {"deepseek-moe-16b": (16, 1, 128),
                   "dbrx-132b": (8, 6, 128), "internvl2-76b": (8, 8, 128)}


def test_serve_cli_moe_static_equals_continuous():
    """``repro_torch.launch.serve --arch deepseek-moe-16b --smoke --device
    cpu``: the continuous engine prints the static path's tokens."""
    from repro_torch.launch.serve import main
    base = ["--arch", "deepseek-moe-16b", "--smoke", "--device", "cpu",
            "--batch", "2", "--prompt-len", "32", "--gen", "6"]
    static = main(base + ["--engine", "static"])
    cont = main(base + ["--engine", "continuous", "--requests", "2"])
    assert set(cont["reasons"]) == {"complete"}
    for i in range(2):
        assert list(cont["tokens"][i]) == list(static["tokens"][i])
