"""The port's serving engine against the JAX engine and against its own
static path, on the smoke size of qwen3-0.6b with the JAX init's weights.

Greedy tokens must be identical.  The trace mixes prompt lengths 32 and 48
with 24 new tokens, so every request crosses a window boundary and the
finalize runs; host and fused sampling both serve it.  The page allocator
and the engine's admission rules are checked on their own.
"""

import jax
import numpy as np
import pytest
import torch

from repro.configs.registry import get_arch as jget_arch
from repro.models import transformer as jtfm
from repro.serve import EngineConfig as JEngineConfig
from repro.serve import Request as JRequest
from repro.serve import ServingEngine as JServingEngine
from repro_torch.configs.registry import get_arch as tget_arch
from repro_torch.convert import params_from_jax
from repro_torch.serve import EngineConfig, Request, ServingEngine
from repro_torch.serve.engine import AllocatorInvariantError, _PageAllocator

GEN = 24
W = 16


@pytest.fixture(autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def setup():
    jc = jget_arch("qwen3-0.6b", smoke=True).model
    tc = tget_arch("qwen3-0.6b", smoke=True).model
    jp = jtfm.lm_init(jax.random.PRNGKey(0), jc)
    tp = params_from_jax(jax.device_get(jp))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, jc.vocab, 32 if i % 2 == 0 else 48).astype(
        np.int32) for i in range(6)]
    return jc, tc, jp, tp, prompts


def _ecfg(cls, sample_device):
    pages = -(-(48 + GEN) // W)
    return cls(n_slots=4, pages_per_slot=pages, n_pages=2 * 4 * pages,
               sample_device=sample_device)


@pytest.fixture(scope="module")
def jax_tokens(setup):
    jc, _, jp, _, prompts = setup
    eng = JServingEngine(jp, jc, _ecfg(JEngineConfig, "host"))
    done = eng.run([JRequest(rid=i, prompt=p, max_new_tokens=GEN)
                    for i, p in enumerate(prompts)])
    return {f.rid: np.asarray(f.tokens) for f in done}


@pytest.mark.parametrize("sample_device", ["host", "fused"])
def test_engine_matches_jax_engine_and_static(setup, jax_tokens,
                                              sample_device):
    _, tc, _, tp, prompts = setup
    eng = ServingEngine(tp, tc, _ecfg(EngineConfig, sample_device),
                        device="cpu")
    done = eng.run([Request(rid=i, prompt=p, max_new_tokens=GEN)
                    for i, p in enumerate(prompts)])
    assert [f.reason for f in done] == ["complete"] * len(prompts)
    ours = {f.rid: f.tokens for f in done}
    for rid, toks in jax_tokens.items():
        np.testing.assert_array_equal(ours[rid], toks, err_msg=f"rid {rid}")
    # the port's own static path (the backend's oracle), per prompt length
    for n in (32, 48):
        rids = [i for i, p in enumerate(prompts) if len(p) == n]
        ref = eng.backend.static_reference(np.stack([prompts[i]
                                                     for i in rids]), GEN)
        for row, rid in enumerate(rids):
            np.testing.assert_array_equal(ours[rid], ref[row])
    st = eng.stats()
    assert st["decode_dispatches"] == eng.steps > 0
    assert st["paged_kernel_fallbacks"] == st["finalize_kernel_fallbacks"] \
        == 0


def test_stats_schema(setup):
    from repro.serve.backends import STATS_SCHEMA as J_SCHEMA
    from repro_torch.serve.backends import STATS_SCHEMA
    _, tc, _, tp, _ = setup
    eng = ServingEngine(tp, tc, _ecfg(EngineConfig, "host"), device="cpu")
    assert STATS_SCHEMA == J_SCHEMA
    assert set(eng.stats()) == set(STATS_SCHEMA)


def test_unservable_prompt_is_rejected_like_jax(setup):
    """A prompt length the sorted prefill cannot serve (N*s % block_q) is
    shed at submit time by both engines; nothing is admitted."""
    jc, tc, jp, tp, _ = setup
    prompt = np.arange(40, dtype=np.int32)
    jeng = JServingEngine(jp, jc, _ecfg(JEngineConfig, "host"))
    teng = ServingEngine(tp, tc, _ecfg(EngineConfig, "host"), device="cpu")
    assert not jeng.submit(JRequest(rid=0, prompt=prompt, max_new_tokens=4))
    assert not teng.submit(Request(rid=0, prompt=prompt, max_new_tokens=4))
    assert teng.finished[0].reason == "rejected"
    assert "block_q" in teng.reject_reasons[0]
    too_long = np.zeros(64, np.int32)
    assert not teng.submit(Request(rid=1, prompt=too_long,
                                   max_new_tokens=64))
    assert teng.stats()["rejected"] == 2


def test_cancel_and_deadline(setup):
    _, tc, _, tp, prompts = setup
    eng = ServingEngine(tp, tc, _ecfg(EngineConfig, "host"), device="cpu")
    for i in range(3):
        eng.submit(Request(rid=i, prompt=prompts[0], max_new_tokens=GEN))
    eng.submit(Request(rid=9, prompt=prompts[0], max_new_tokens=GEN,
                       deadline_ms=0.0))
    eng.step()
    assert eng.cancel(1)
    assert not eng.cancel(1)
    while eng.step():
        pass
    by = {f.rid: f for f in eng.finished}
    assert by[1].reason == "cancelled" and by[9].reason == "deadline_expired"
    assert by[0].reason == by[2].reason == "complete"
    assert eng.alloc.in_use == 0 and sorted(eng.free_slots) == [0, 1, 2, 3]


@pytest.mark.parametrize("field", ["spec_k", "prefill_mode",
                                   "prefill_chunk", "prefix_cache"])
def test_engine_config_rejects_next_slice_features(setup, field):
    """The engine refuses, as the reference does (ValueError): an unknown
    prefill mode (both "batched" and "per-job" are ported), speculation
    without fused sampling or with a negative ``spec_k``, a chunk that is
    not a multiple of the window and a prefix cache without chunked
    prefill."""
    _, tc, _, tp, _ = setup
    if field == "prefill_mode":
        ServingEngine(tp, tc, EngineConfig(prefill_mode="per-job",
                                           prefill_chunk=W), device="cpu")
        with pytest.raises(ValueError, match="unknown prefill_mode"):
            ServingEngine(tp, tc, EngineConfig(prefill_mode="legacy"),
                          device="cpu")
        return
    if field == "spec_k":
        with pytest.raises(ValueError, match="fused"):
            ServingEngine(tp, tc, EngineConfig(spec_k=2), device="cpu")
        with pytest.raises(ValueError, match=">= 0"):
            ServingEngine(tp, tc, EngineConfig(spec_k=-1), device="cpu")
        return
    kw = ({"prefill_chunk": W + 1} if field == "prefill_chunk"
          else {"prefix_cache": True})
    match = "multiple of" if field == "prefill_chunk" else "requires chunked"
    with pytest.raises(ValueError, match=match):
        ServingEngine(tp, tc, EngineConfig(**kw), device="cpu")


def test_page_allocator_ref_counts():
    a = _PageAllocator(6, reserve=1)
    p = a.alloc(3)
    assert a.in_use == 3 and a.high_water == 3
    a.retain(p[:2])
    assert a.refcount(p[0]) == 2 and a.shared_pages == 2
    a.release(p)
    assert a.refcount(p[0]) == 1 and a.refcount(p[2]) == 0
    assert a.in_use == 2
    with pytest.raises(AllocatorInvariantError, match="double-free"):
        a.release([p[2]])
    with pytest.raises(AllocatorInvariantError, match="duplicate"):
        a.release([p[0], p[0]])
    assert a.refcount(p[0]) == 1          # the failed call applied nothing
    with pytest.raises(AllocatorInvariantError, match="not allocated"):
        a.retain([p[2]])
    a.release(p[:2])
    assert a.in_use == 0


def test_page_allocator_reserve():
    a = _PageAllocator(4, reserve=2)
    assert a.can_alloc(2) and not a.can_alloc(3)
    a.alloc(2)
    with pytest.raises(AllocatorInvariantError, match="exhausted"):
        a.alloc(1)
    a.alloc(1, reserved=True)
    assert a.reserve_dips == 1 and a.high_water == 3
