"""The port's chunked serving path against the JAX reference (CPU).

* `chunk_prefill_plain` (through `core.mita_decode.mita_batched_chunk_
  prefill`) beside the JAX op on its XLA path, never the Pallas output:
  the `tests/test_kernel_oracle.py` chunk cases -- ragged resume points
  with inactive rows in every dispatch, non-aligned prompt heads,
  preemption-recompute rows, ``s_route`` 1 and 2, external finalize on and
  off.  Integer state is exact; floats agree to atol = rtol = 1e-5.
* `lm_prefill_chunks` beside the JAX function (smoke qwen3-0.6b).
* The chunked engine against the JAX chunked engine and the port's own
  `static_generate`, and its scheduling behaviour: one prefill dispatch
  per step, preemption round trips, no livelock between equals, priority
  admission, cancel in every state, prefix-cache hits equal to cold runs.

The CUDA kernel itself is held to `chunk_prefill_plain` on the card by
``tests/test_torch_gpu.py`` and ``chip_smoke.py``.
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
from repro_torch.configs.registry import get_arch as tget_arch
from repro_torch.convert import params_from_jax, paged_state_from_jax, to_numpy
from repro_torch.core import mita_decode as tdec
from repro_torch.kernels import ops
from repro_torch.models import transformer as ttfm
from repro_torch.serve import EngineConfig, Request, ServingEngine

TOL = dict(atol=1e-5, rtol=1e-5)
W, K = 8, 8
STATE = ("lm_q", "lm_v", "expert_idx", "expert_valid", "q_sum", "pre_lm_q",
         "pre_q_sum", "k_pool", "v_pool")


@pytest.fixture(autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _assert_state(st_t, st_j, msg):
    """Integers exact, floats to TOL; pools without the scratch row."""
    for f in STATE:
        a, b = to_numpy(getattr(st_t, f)), np.asarray(getattr(st_j, f))
        if f in ("k_pool", "v_pool"):
            a, b = a[:-1], b[:-1]
        if a.dtype.kind in "biu":
            np.testing.assert_array_equal(a, b, err_msg=f"{f} {msg}")
        else:
            np.testing.assert_allclose(a, b, err_msg=f"{f} {msg}", **TOL)


# ------------------------------------------------------------ the op -------

def _drive_chunks(n_trains, n_totals, chunk, s_route=1, external=True,
                  stagger=True, m_slot=4, hkv=2, g=2, d=16, seed=5):
    """Chunk-prefill the port and the JAX XLA op side by side over a
    shuffled page pool; with ``stagger`` rows advance on alternating
    dispatches (ragged resume points, inactive rows in every dispatch).
    Outputs at valid positions and all state are compared after every
    dispatch.  Returns the port's final state."""
    cfg_j = jdec.DecodeConfig(window=W, k=K, s=s_route, prefill_impl="xla",
                              external_finalize=external)
    cfg_t = tdec.DecodeConfig(window=W, k=K, s=s_route,
                              external_finalize=external)
    s_n = len(n_totals)
    rng = np.random.default_rng(seed)
    n_pages = s_n * m_slot + 2
    table = rng.permutation(n_pages)[: s_n * m_slot].reshape(
        s_n, m_slot).astype(np.int32)
    nmax = max(n_totals)
    q = rng.standard_normal((s_n, hkv, g, nmax, d)).astype(np.float32)
    k = rng.standard_normal((s_n, hkv, nmax, d)).astype(np.float32)
    v = rng.standard_normal((s_n, hkv, nmax, d)).astype(np.float32)
    st_j = jdec.init_paged_state(hkv, d, n_pages, s_n, m_slot, cfg_j,
                                 jnp.float32)
    st_t = paged_state_from_jax(jax.device_get(st_j))
    step = jax.jit(jdec.mita_batched_chunk_prefill, static_argnames="cfg")
    done = np.zeros(s_n, np.int32)
    it = 0
    while (done < np.asarray(n_totals)).any():
        act = done < np.asarray(n_totals)
        if stagger and s_n > 1:
            act = act & (np.arange(s_n) % 2 == it % 2)
        it += 1
        if not act.any():
            continue
        nv = np.where(act, np.minimum(chunk, np.asarray(n_totals) - done),
                      0).astype(np.int32)
        qc = np.zeros((s_n, hkv, g, chunk, d), np.float32)
        kc = np.zeros((s_n, hkv, chunk, d), np.float32)
        vc = np.zeros((s_n, hkv, chunk, d), np.float32)
        for s in range(s_n):
            if act[s]:
                sl = slice(done[s], done[s] + nv[s])
                qc[s, :, :, : nv[s]] = q[s, :, :, sl]
                kc[s, :, : nv[s]] = k[s, :, sl]
                vc[s, :, : nv[s]] = v[s, :, sl]
        slots = np.arange(s_n, dtype=np.int32)
        ntr = np.asarray(n_trains, np.int32)
        o_j, st_j = step(st_j, jnp.asarray(qc), jnp.asarray(kc),
                         jnp.asarray(vc), jnp.asarray(table),
                         jnp.asarray(slots), jnp.asarray(done),
                         jnp.asarray(nv), jnp.asarray(ntr), jnp.asarray(act),
                         cfg=cfg_j)
        o_t, st_t = tdec.mita_batched_chunk_prefill(
            st_t, _t(qc), _t(kc), _t(vc), _t(table), _t(slots), _t(done),
            _t(nv), _t(ntr), _t(act), cfg_t)
        o_j = np.asarray(o_j)
        for s in range(s_n):
            np.testing.assert_allclose(
                o_t.numpy()[s][:, :, : nv[s]], o_j[s][:, :, : nv[s]],
                err_msg=f"out row {s} dispatch {it}", **TOL)
        _assert_state(st_t, st_j, f"dispatch {it}")
        done = done + nv
    return st_t


@pytest.mark.parametrize("case", [
    # ragged resume + recompute rows (n_total > n_train), routing, modes
    dict(n_trains=[32, 16, 20], n_totals=[32, 24, 28], chunk=8),
    dict(n_trains=[32, 16, 20], n_totals=[32, 24, 28], chunk=8, s_route=2),
    dict(n_trains=[32, 16, 20], n_totals=[32, 24, 28], chunk=8,
         external=False),
    # non-aligned heads (w' = 10 for n = 20, w' = n for n < 2w); a chunk
    # shorter than w' crosses the eager landmark-query commit
    dict(n_trains=[20, 12], n_totals=[20, 12], chunk=8),
    dict(n_trains=[20, 12], n_totals=[28, 20], chunk=16, s_route=2),
    # one chunk per row, inactive rows in each dispatch
    dict(n_trains=[16, 16], n_totals=[16, 16], chunk=16),
], ids=["ragged", "ragged-s2", "ragged-inline", "nonaligned",
        "nonaligned-recompute-s2", "inactive"])
def test_chunk_prefill_plain_vs_jax_xla(case):
    _drive_chunks(**case)


def test_chunk_prefill_recompute_round_trip():
    """Recompute-from-prompt at the op level: prompt-then-generated built
    in chunks of 8 and of 16 (each step held to JAX) give the same state."""
    st_a = _drive_chunks([16], [32], chunk=8, stagger=False)
    st_b = _drive_chunks([16], [32], chunk=16, stagger=False)
    for f in STATE[:7]:
        np.testing.assert_allclose(to_numpy(getattr(st_a, f)),
                                   to_numpy(getattr(st_b, f)), atol=2e-5,
                                   err_msg=f"{f} chunk-size invariance")


def test_chunk_prefill_inactive_rows_untouched():
    """Every piece of an inactive row's slot state passes through, and its
    output is zero; no pool row outside the scratch row changes."""
    st_j = jdec.init_paged_state(2, 16, 10, 2, 4, jdec.DecodeConfig(
        window=W, k=K), jnp.float32)
    st = paged_state_from_jax(jax.device_get(st_j))
    rng = np.random.default_rng(1)
    for x in st:
        if x.is_floating_point():
            x.copy_(_t(rng.standard_normal(x.shape).astype(np.float32)))
    before = type(st)(*(x.clone() for x in st))
    q = _t(rng.standard_normal((2, 2, 2, 8, 16)).astype(np.float32))
    kv = _t(rng.standard_normal((2, 2, 8, 16)).astype(np.float32))
    table = _t(np.asarray([[0, 1, 2, 3], [4, 5, 6, 7]], np.int32))
    out, st = tdec.mita_batched_chunk_prefill(
        st, q, kv, kv, table, _t(np.asarray([1, 0], np.int32)),
        _t(np.asarray([8, 0], np.int32)), _t(np.asarray([8, 0], np.int32)),
        _t(np.asarray([16, 1], np.int32)), _t(np.asarray([True, False])),
        tdec.DecodeConfig(window=W, k=K, external_finalize=True))
    assert torch.all(out[1] == 0)
    for f in STATE[:7]:
        assert torch.equal(getattr(st, f)[0], getattr(before, f)[0]), f
    changed = (st.k_pool != before.k_pool).any(-1).any(-1).nonzero()[:, 0]
    assert set(changed.tolist()) <= set(range(W, 2 * W)) | {10 * W}


# --------------------------------------------------------- the LM forward --

SW = 16                     # window of the smoke qwen3-0.6b config


@pytest.fixture(scope="module")
def smoke():
    jc = jget_arch("qwen3-0.6b", smoke=True).model
    tc = tget_arch("qwen3-0.6b", smoke=True).model
    jp = jtfm.lm_init(jax.random.PRNGKey(0), jc)
    return jc, tc, jp, params_from_jax(jax.device_get(jp))


def test_lm_prefill_chunks_vs_jax(smoke):
    """Two batched dispatches over rows of an aligned (48) and a
    non-aligned (40: m = 2, w' = 20) prompt, written into slots 2 and 0 of
    a three-slot state, the second dispatch ragged: logits of the active
    rows and every layer's state agree with the JAX function."""
    jc, tc, jp, tp = smoke
    m_slot, n_pages, nc = 4, 10, 32
    jst = jtfm.init_paged_states(jc, 3, n_pages, m_slot)
    tst = paged_state_from_jax(jax.device_get(jst))
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, jc.vocab, n).astype(np.int32) for n in (48, 40)]
    table = rng.permutation(n_pages)[: 2 * m_slot].reshape(2, m_slot).astype(
        np.int32)
    slots = np.asarray([2, 0], np.int32)
    ntr = np.asarray([48, 40], np.int32)
    fn = jax.jit(lambda p, s, *a: jtfm.lm_prefill_chunks(p, s, *a, jc))
    done = np.zeros(2, np.int32)
    while (done < ntr).any():
        nv = np.minimum(nc, ntr - done).astype(np.int32)
        act = nv > 0
        toks = np.zeros((2, nc), np.int32)
        for i in range(2):
            toks[i, : nv[i]] = prompts[i][done[i]:done[i] + nv[i]]
        args = (toks, act, table, slots, done.copy(), nv, ntr)
        lj, jst = fn(jp, jst, *(jnp.asarray(a) for a in args))
        lt, tst = ttfm.lm_prefill_chunks(tp, tst, *(_t(a) for a in args), tc)
        np.testing.assert_allclose(lt.numpy()[act], np.asarray(lj)[act],
                                   atol=1e-4, rtol=1e-4)
        _assert_state(tst, jst, f"after t0 {done.tolist()}")
        done = done + nv


# --------------------------------------------------------------- engine ----

def _engine(tp, tc, **kw):
    return ServingEngine(tp, tc, EngineConfig(**kw), device="cpu")


@pytest.mark.parametrize("n", [48, 12], ids=["aligned", "nonaligned"])
def test_chunked_engine_matches_jax_engine_and_static(smoke, n):
    """Greedy tokens of the chunked engine equal the JAX chunked engine's
    and the port's `static_generate` (12 is non-aligned: m = 1, w' = 12)."""
    jc, tc, jp, tp = smoke
    gen = 20
    rng = np.random.default_rng(n)
    prompts = rng.integers(0, jc.vocab, (3, n)).astype(np.int32)
    pages = -(-(n + gen) // SW)
    kw = dict(n_slots=2, pages_per_slot=pages, n_pages=3 * pages + 2,
              prefill_chunk=SW)
    jeng = JServingEngine(jp, jc, JEngineConfig(**kw))
    jdone = jeng.run([JRequest(rid=i, prompt=p, max_new_tokens=gen)
                      for i, p in enumerate(prompts)])
    eng = _engine(tp, tc, **kw)
    done = eng.run([Request(rid=i, prompt=p, max_new_tokens=gen)
                    for i, p in enumerate(prompts)])
    ref = eng.backend.static_reference(prompts, gen)
    assert eng.stats()["chunks"] >= 3 * (n // SW)
    for i, (f, jf) in enumerate(zip(done, jdone)):
        np.testing.assert_array_equal(f.tokens, np.asarray(jf.tokens),
                                      err_msg=f"req {i} vs JAX engine")
        np.testing.assert_array_equal(f.tokens, ref[i],
                                      err_msg=f"req {i} vs static")


def test_batched_prefill_is_one_dispatch_per_step(smoke):
    """Several requests mid-prefill at once advance in exactly one prefill
    dispatch per step, and still emit the static path's tokens."""
    _, tc, _, tp = smoke
    b, n, gen = 3, 6 * SW, 4
    prompts = np.random.default_rng(21).integers(0, tc.vocab, (b, n)).astype(
        np.int32)
    pages = -(-(n + gen) // SW)
    eng = _engine(tp, tc, n_slots=b, pages_per_slot=pages,
                  n_pages=b * pages + 2, prefill_chunk=SW)
    for i in range(b):
        eng.submit(Request(rid=i, prompt=prompts[i], max_new_tokens=gen))
    saw_concurrent = False
    while True:
        before = eng.prefill_dispatches
        eng._admit(0.0)
        n_jobs = len(eng.prefilling)
        if not eng.step():
            break
        saw_concurrent |= n_jobs > 1
        assert eng.prefill_dispatches - before <= 1
        if n_jobs > 1:
            assert all(j.done > 0 for j in eng.prefilling.values())
    assert saw_concurrent
    ref = eng.backend.static_reference(prompts, gen)
    for f in sorted(eng.finished, key=lambda f: f.rid):
        np.testing.assert_array_equal(f.tokens, ref[f.rid])


@pytest.mark.parametrize("n", [16, 20], ids=["aligned", "nonaligned"])
def test_preemption_round_trip_identical_tokens(smoke, n):
    """A low-priority request evicted mid-decode by high-priority arrivals
    (pages released, rebuilt by recompute-from-prompt) emits the tokens of
    its unpreempted run; page accounting holds throughout."""
    _, tc, _, tp = smoke
    gen = 24
    rng = np.random.default_rng(3)
    victim = rng.integers(0, tc.vocab, n).astype(np.int32)
    kw = dict(n_slots=2, pages_per_slot=6, n_pages=8, prefill_chunk=2 * SW)
    ref = _engine(tp, tc, **kw).run(
        [Request(rid=0, prompt=victim, max_new_tokens=gen)])[0].tokens
    eng = _engine(tp, tc, **kw)
    eng.submit(Request(rid=0, prompt=victim, max_new_tokens=gen))
    for _ in range(6):
        eng.step()
    for i in (1, 2):
        eng.submit(Request(rid=i, prompt=rng.integers(0, tc.vocab, 16).astype(
            np.int32), max_new_tokens=24, priority=5))
    while eng.step():
        owned = [p for pages in eng.slot_pages.values() for p in pages]
        assert len(owned) == len(set(owned)), "page double-booked"
        assert len(owned) + len(eng.alloc.free) == kw["n_pages"]
    done = sorted(eng.finished, key=lambda f: f.rid)
    assert len(done) == 3 and eng.n_preemptions >= 1
    assert done[0].preemptions >= 1
    np.testing.assert_array_equal(done[0].tokens, ref)


def test_equal_priority_jobs_never_livelock(smoke):
    """Two equal-priority long prompts whose chunked prefills together
    exceed the pool: pages flow to the senior job and both finish."""
    _, tc, _, tp = smoke
    prompts = np.random.default_rng(13).integers(0, tc.vocab, (2, 8 * SW))
    eng = _engine(tp, tc, n_slots=2, pages_per_slot=9, n_pages=9,
                  prefill_chunk=2 * SW)
    for i in range(2):
        eng.submit(Request(rid=i, prompt=prompts[i].astype(np.int32),
                           max_new_tokens=1))
    for _ in range(400):
        if not eng.step():
            break
    else:
        raise AssertionError("engine livelocked: no progress in 400 steps")
    done = sorted(eng.finished, key=lambda f: f.rid)
    assert [f.rid for f in done] == [0, 1]
    assert all(len(f.tokens) == 1 for f in done)


def test_priority_orders_admission(smoke):
    """With one slot, a later higher-priority request is admitted first;
    FCFS holds within a priority class."""
    _, tc, _, tp = smoke
    pr = np.random.default_rng(11).integers(0, tc.vocab, (3, SW)).astype(
        np.int32)
    eng = _engine(tp, tc, n_slots=1, pages_per_slot=3, n_pages=3,
                  prefill_chunk=SW)
    for rid, prio in ((0, 0), (1, 3), (2, 3)):
        eng.submit(Request(rid=rid, prompt=pr[rid], max_new_tokens=4,
                           priority=prio))
    while eng.step():
        pass
    order = [f.rid for f in sorted(eng.finished, key=lambda f: f.finished)]
    assert order == [1, 2, 0]


def test_cancel_releases_pages_in_every_state(smoke):
    """`cancel` while waiting, mid chunked prefill and decoding frees the
    slot and every page at once and makes the rid reusable."""
    _, tc, _, tp = smoke
    prompts = np.random.default_rng(23).integers(0, tc.vocab, (3, 4 * SW))
    prompts = prompts.astype(np.int32)
    eng = _engine(tp, tc, n_slots=1, pages_per_slot=6, n_pages=6,
                  prefill_chunk=SW)
    eng.submit(Request(rid=0, prompt=prompts[0], max_new_tokens=8))
    eng.submit(Request(rid=1, prompt=prompts[1], max_new_tokens=8))
    eng.step()
    assert eng.cancel(1)                       # waiting
    f1 = next(f for f in eng.finished if f.rid == 1)
    assert f1.cancelled and len(f1.tokens) == 0 and not eng.waiting
    assert eng.prefilling and eng.cancel(0)    # mid prefill
    assert eng.alloc.in_use == 0 and not eng.prefilling
    assert len(eng.free_slots) == 1
    eng.submit(Request(rid=0, prompt=prompts[2], max_new_tokens=16))
    for _ in range(8):
        eng.step()
    assert eng.slot_req and eng.cancel(0)      # decoding
    f0 = [f for f in eng.finished if f.rid == 0][-1]
    assert f0.cancelled and 0 < len(f0.tokens) < 16
    assert eng.alloc.in_use == 0
    assert not eng.cancel(0) and not eng.step()


def test_preempted_prefill_keeps_admission_stamp(smoke):
    """A victim evicted mid-prefill reports its original admission time."""
    _, tc, _, tp = smoke
    rng = np.random.default_rng(17)
    eng = _engine(tp, tc, n_slots=1, pages_per_slot=8, n_pages=8,
                  prefill_chunk=SW)
    eng.submit(Request(rid=0, prompt=rng.integers(0, tc.vocab, 6 * SW)
                       .astype(np.int32), max_new_tokens=2))
    eng.step()
    first_admit = next(iter(eng.prefilling.values())).admit_time
    eng.submit(Request(rid=1, prompt=rng.integers(0, tc.vocab, SW)
                       .astype(np.int32), max_new_tokens=4, priority=5))
    while eng.step():
        pass
    f0 = next(f for f in eng.finished if f.rid == 0)
    assert f0.preemptions >= 1 and f0.admitted == first_admit


def test_prefix_cache_hits_equal_cold_run(smoke):
    """A prompt sharing a cached two-chunk prefix attaches its pages and
    summary rows; every request's tokens equal the cold engine's, and the
    engine gives the JAX cached engine's tokens and hit counts."""
    jc, tc, jp, tp = smoke
    rng = np.random.default_rng(31)
    a = rng.integers(0, tc.vocab, 6 * SW).astype(np.int32)
    b = np.concatenate([a[: 4 * SW],
                        rng.integers(0, tc.vocab, 2 * SW).astype(np.int32)])
    kw = dict(n_slots=2, pages_per_slot=8, n_pages=24, prefill_chunk=2 * SW)

    def drive(eng, req):
        eng.submit(req(rid=0, prompt=a, max_new_tokens=12))
        while eng.prefilling or not eng.active.any():
            eng.step()
        eng.submit(req(rid=1, prompt=b, max_new_tokens=12))
        while eng.step():
            pass
        return {f.rid: np.asarray(f.tokens) for f in eng.finished}

    cold = drive(_engine(tp, tc, **kw), Request)
    eng = _engine(tp, tc, prefix_cache=True, **kw)
    hot = drive(eng, Request)
    jeng = JServingEngine(jp, jc, JEngineConfig(prefix_cache=True, **kw))
    jhot = drive(jeng, JRequest)
    st = eng.stats()
    assert st["prefix_cache_hits"] == jeng.stats()["prefix_cache_hits"] >= 1
    assert st["prefix_tokens_reused"] == 4 * SW
    for rid in (0, 1):
        np.testing.assert_array_equal(hot[rid], cold[rid])
        np.testing.assert_array_equal(hot[rid], jhot[rid])


@pytest.mark.parametrize("n", [8, 300, 2048])
def test_topk_sort_keys_order_is_first_index_top_k(n):
    """The chunk kernel's packed top-K keys (host mirror): a descending
    sort of them is `topk_first`'s order -- scores descending, ties by
    ascending index, -0 tied with +0 -- and its scores are
    `torch.topk`'s values."""
    from repro_torch.core.mita import topk_first
    from repro_torch.kernels import mita_chunk_prefill as mcp
    rng = np.random.default_rng(n)
    x = torch.from_numpy(rng.integers(-3, 4, (6, n)).astype(np.float32) / 2)
    x[:, :: 7] = -0.0
    x[0, 1::5] = float(np.finfo(np.float32).min)    # masked lanes
    x[1, :3] = float("inf")
    x[2] = torch.from_numpy(                           # no ties
        rng.standard_normal(n).astype(np.float32))
    keys = mcp.topk_sort_keys(x)
    order = ~torch.sort(keys, dim=-1, descending=True).values & 0xFFFFFFFF
    vals, idx = topk_first(x, n)
    assert torch.equal(order, idx)
    k = min(n, 128)
    assert torch.equal(torch.gather(x, -1, order[:, :k]),
                       torch.topk(x, k, dim=-1).values)


def test_chunk_dispatch_routes_by_device():
    """CPU tensors take the plain version (no launch counted); the CUDA
    wrapper refuses CPU tensors before building or launching anything."""
    from repro_torch.kernels import mita_chunk_prefill as mcp
    st = tdec.init_paged_state(2, 32, 6, 2, 2, tdec.DecodeConfig(
        window=W, k=K), torch.float32)
    rows = [x[:1] for x in st[2:]]
    q = torch.zeros((1, 2, 2, 8, 32))
    kv = torch.zeros((1, 2, 8, 32))
    sched = (_t(np.asarray([[0, 1]], np.int32)),
             *(_t(np.asarray([x], np.int32)) for x in (0, 8, 8)),
             _t(np.asarray([True])))
    kw = dict(window=W, k_width=K, n_route=1, external_finalize=True)
    ops.reset_launch_counts()
    out = ops.batched_chunk_prefill(q, kv, kv, *rows, st.k_pool, st.v_pool,
                                    *sched, **kw)
    assert out[0].shape == q.shape
    assert ops.launch_counts()["mita_chunk_prefill_fused"] == 0
    with pytest.raises(ValueError, match="CUDA"):
        mcp.mita_chunk_prefill_fused(q, kv, kv, *rows, st.k_pool, st.v_pool,
                                     *sched, **kw)


# ------------------------------------------------------------- per-job mode --

@pytest.mark.parametrize("chunk,external", [(16, True), (12, True),
                                            (16, False)],
                         ids=["aligned", "resume", "inline"])
def test_mita_chunk_prefill_per_job_vs_jax(chunk, external):
    """The per-job op (`mita_chunk_prefill`, plain PyTorch: the reference's
    op is plain XLA) beside the JAX op: slot 1 of 3 over a shuffled pool,
    a prompt of 3 windows (n_train 24) then 10 generated positions (the
    recompute shape); chunks of 12 resume an open window from ``q_sum``.
    Outputs at valid positions and every state field after each chunk."""
    cfg_j = jdec.DecodeConfig(window=W, k=K, external_finalize=external)
    cfg_t = tdec.DecodeConfig(window=W, k=K, external_finalize=external)
    hkv, g, d, m_slot, n_pages, slot = 2, 2, 16, 5, 16, 1
    n_train, n_total = 24, 34
    rng = np.random.default_rng(9)
    table = rng.permutation(n_pages)[:m_slot].astype(np.int32)
    q = rng.standard_normal((hkv, g, n_total, d)).astype(np.float32)
    k = rng.standard_normal((hkv, n_total, d)).astype(np.float32)
    v = rng.standard_normal((hkv, n_total, d)).astype(np.float32)
    st_j = jdec.init_paged_state(hkv, d, n_pages, 3, m_slot, cfg_j,
                                 jnp.float32)
    st_t = paged_state_from_jax(jax.device_get(st_j))
    step = jax.jit(jdec.mita_chunk_prefill, static_argnames="cfg")
    done = 0
    while done < n_total:
        nv = min(chunk, n_total - done)
        qc = np.zeros((hkv, g, chunk, d), np.float32)
        kc = np.zeros((hkv, chunk, d), np.float32)
        vc = np.zeros((hkv, chunk, d), np.float32)
        qc[:, :, :nv] = q[:, :, done:done + nv]
        kc[:, :nv] = k[:, done:done + nv]
        vc[:, :nv] = v[:, done:done + nv]
        o_j, st_j = step(st_j, jnp.asarray(qc), jnp.asarray(kc),
                         jnp.asarray(vc), jnp.asarray(table), np.int32(slot),
                         np.int32(done), np.int32(nv), np.int32(n_train),
                         cfg=cfg_j)
        o_t, st_t = tdec.mita_chunk_prefill(
            st_t, _t(qc), _t(kc), _t(vc), _t(table), slot, done, nv,
            n_train, cfg_t)
        np.testing.assert_allclose(o_t.numpy()[:, :, :nv],
                                   np.asarray(o_j)[:, :, :nv],
                                   err_msg=f"out t0 {done}", **TOL)
        _assert_state(st_t, st_j, f"t0 {done}")
        done += nv


def test_lm_prefill_chunk_per_job_vs_jax(smoke):
    """`lm_prefill_chunk` (one slot, one chunk a call) beside the JAX
    function: a 48-token prompt in chunks of 32 into slot 2 of 3; logits
    and every layer's state after each chunk."""
    jc, tc, jp, tp = smoke
    m_slot, n_pages, nc, slot = 4, 10, 32, 2
    jst = jtfm.init_paged_states(jc, 3, n_pages, m_slot)
    tst = paged_state_from_jax(jax.device_get(jst))
    rng = np.random.default_rng(12)
    prompt = rng.integers(0, jc.vocab, 48).astype(np.int32)
    table = rng.permutation(n_pages)[:m_slot].astype(np.int32)
    fn = jax.jit(lambda p, s, *a: jtfm.lm_prefill_chunk(p, s, *a, jc))
    done = 0
    while done < 48:
        nv = min(nc, 48 - done)
        toks = np.zeros(nc, np.int32)
        toks[:nv] = prompt[done:done + nv]
        lj, jst = fn(jp, jst, jnp.asarray(toks), np.int32(slot),
                     jnp.asarray(table), np.int32(done), np.int32(nv),
                     np.int32(48))
        lt, tst = ttfm.lm_prefill_chunk(tp, tst, _t(toks), slot, _t(table),
                                        done, nv, 48, tc)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=1e-4,
                                   rtol=1e-4)
        _assert_state(tst, jst, f"t0 {done}")
        done += nv


@pytest.mark.parametrize("n", [48, 12], ids=["aligned", "nonaligned"])
def test_per_job_engine_matches_jax_engine_and_static(smoke, n):
    """``prefill_mode="per-job"``: one job's chunk per dispatch, a
    non-aligned prompt (12: not window-aligned) through the monolithic
    route; greedy tokens equal the JAX per-job engine's and the port's
    `static_generate`."""
    jc, tc, jp, tp = smoke
    gen = 20
    prompts = np.random.default_rng(n + 1).integers(0, jc.vocab, (3, n)) \
        .astype(np.int32)
    pages = -(-(n + gen) // SW)
    kw = dict(n_slots=2, pages_per_slot=pages, n_pages=3 * pages + 2,
              prefill_chunk=SW, prefill_mode="per-job")
    jdone = JServingEngine(jp, jc, JEngineConfig(**kw)).run(
        [JRequest(rid=i, prompt=p, max_new_tokens=gen)
         for i, p in enumerate(prompts)])
    eng = _engine(tp, tc, **kw)
    done = eng.run([Request(rid=i, prompt=p, max_new_tokens=gen)
                    for i, p in enumerate(prompts)])
    ref = eng.backend.static_reference(prompts, gen)
    st = eng.stats()
    if n % SW == 0:
        assert st["chunks"] == st["prefill_dispatches"] == 3 * (n // SW)
    else:
        assert st["chunks"] == 0 and st["prefill_dispatches"] == 3
    for i, (f, jf) in enumerate(zip(done, jdone)):
        np.testing.assert_array_equal(f.tokens, np.asarray(jf.tokens),
                                      err_msg=f"req {i} vs JAX engine")
        np.testing.assert_array_equal(f.tokens, ref[i],
                                      err_msg=f"req {i} vs static")


def test_per_job_preemption_round_trip(smoke):
    """Per-job mode: a victim evicted mid-decode and rebuilt chunk by chunk
    from prompt + emitted tokens re-emits its unpreempted stream."""
    _, tc, _, tp = smoke
    rng = np.random.default_rng(31)
    victim = rng.integers(0, tc.vocab, 16).astype(np.int32)
    kw = dict(n_slots=2, pages_per_slot=6, n_pages=8, prefill_chunk=2 * SW,
              prefill_mode="per-job")
    ref = _engine(tp, tc, **kw).run(
        [Request(rid=0, prompt=victim, max_new_tokens=24)])[0].tokens
    eng = _engine(tp, tc, **kw)
    eng.submit(Request(rid=0, prompt=victim, max_new_tokens=24))
    for _ in range(6):
        eng.step()
    for i in (1, 2):
        eng.submit(Request(rid=i, prompt=rng.integers(0, tc.vocab, 16).astype(
            np.int32), max_new_tokens=24, priority=5))
    while eng.step():
        pass
    done = sorted(eng.finished, key=lambda f: f.rid)
    assert len(done) == 3 and eng.n_preemptions >= 1
    np.testing.assert_array_equal(done[0].tokens, ref)
