"""The MiTA cell of the backend conformance battery
(``tests/test_backend_conformance.py``) run against the port, and the
main-path gate: the port's engine against the JAX engine on the serving
benchmark's traces.

The battery (port backend, CPU, float32, the reference's MiTA cell:
2 layers, d_model 64, 4 heads / 2 KV heads, vocab 97, window 8,
``mita_ref``):

  * chunked admission with slot reuse: greedy streams equal the backend's
    own static reference; a preempted victim re-emits its stream;
  * a drained trace releases every page, reference and slot;
  * ``stats()`` has exactly `STATS_SCHEMA`;
  * ``spec_k = 3`` streams equal ``spec_k = 0`` at temperatures 0 and 0.8,
    with drafts both accepted and rolled back (this cell's drafter agrees
    with verification on some tokens: both counters are asserted > 0);
  * the speculation contract surface, and `BackendBase` refusing it;
  * a backend raising mid-step (before it changes any state) leaves the
    engine consistent: draining it releases everything and every stream
    still equals the static reference.

The same battery runs on the reference's two recurrent cells (``mamba2``:
2 layers, d_model 32, one SSD head; ``rglru``: one super-block, d_model 64,
4 heads / 2 KV heads, ``mita_ref`` attention, window 8) through the port's
`Mamba2Backend` and `RGLRUBackend`, speculation in both recurrent modes
(``self`` never rejects, ``stress`` always rolls back).

Under a supervisor, on all three cells: seeded chaos (transient and
slot-bound faults, allocator spikes) leaves every stream equal to the
fault-free engine's with zero leaks and moving counters
(`test_supervised_chaos_parity`); and the reference's schedule fuzzer
(mita and mamba2, Hypothesis with its settings: 6 examples of random
prompts, budgets, ``spec_k``, staggered arrivals, an optional cancel and
optional chaos gated at ``draft_steps``, never at ``verify_step``) holds
every completed stream to the fault-free ``spec_k = 0`` run.

The gate imports ``benchmarks/serve_bench.py``'s Poisson trace (`_trace`,
8 of its 32 requests, monolithic engine, 8 slots) and its interference
trace (`_interference_trace`, 6 short requests of its 48 and 1 long of its
3, chunked + preemptive engine) with the bench's model and engine
configurations, runs each through the JAX engine and the port's engine on
the same weights, arrivals queued up front, and requires equal greedy
tokens per request.
"""

import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from _hypothesis_compat import given, settings, st
from benchmarks.common import tiny_lm_cfg
from benchmarks.serve_bench import _interference_trace, _trace
from repro.core.mita_decode import window_aligned
from repro.models import mamba2 as jm2
from repro.models import rglru as jrg
from repro.models import transformer as jtfm
from repro.models.modules import AttnConfig as JAttnConfig
from repro.models.modules import ModelConfig as JModelConfig
from repro.serve import EngineConfig as JEngineConfig
from repro.serve import ServingEngine as JServingEngine
from repro_torch.convert import params_from_jax
from repro_torch.models.modules import AttnConfig, ModelConfig
from repro_torch.serve import (ChaosBackend, ChaosConfig, EngineConfig,
                               Request, ServingEngine, Supervisor,
                               SupervisorConfig)
from repro_torch.serve.backends import (BACKEND_STAT_KEYS, ENGINE_STAT_KEYS,
                                        STATS_SCHEMA, BackendBase)
from repro_torch.serve.backends.mita import MiTABackend
from repro_torch.serve.backends.recurrent import Mamba2Backend, RGLRUBackend

W = 8


@pytest.fixture(autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _port_cfg(jc: JModelConfig) -> ModelConfig:
    """The port's config with the JAX config's values (float32)."""
    def common(cls, obj):
        names = {f.name for f in dataclasses.fields(cls)}
        return {f.name: getattr(obj, f.name)
                for f in dataclasses.fields(obj)
                if f.name in names and not f.name.endswith("dtype")}
    kw = common(ModelConfig, jc)
    kw["attn"] = AttnConfig(**common(AttnConfig, jc.attn))
    return ModelConfig(**kw)


@functools.lru_cache(maxsize=None)
def _cells(name):
    """``(cfg, params, backend class)`` of the battery's three cells: the
    reference's configs, the JAX init's weights."""
    key = jax.random.PRNGKey(0)
    if name == "mita":
        jc = JModelConfig(n_layers=2, d_model=64, n_heads=4, n_kv=2,
                          d_ff=128, vocab=97,
                          attn=JAttnConfig(window=W, k=W,
                                           backend="mita_ref"))
        jp, mk = jtfm.lm_init(key, jc), MiTABackend
    elif name == "mamba2":
        jc = JModelConfig(n_layers=2, d_model=32, n_heads=1, n_kv=1, d_ff=0,
                          vocab=97, attn=JAttnConfig(window=W,
                                                     backend="full"))
        jp, mk = jm2.mamba_init(key, jc), Mamba2Backend
    else:
        jc = JModelConfig(n_layers=3, d_model=64, n_heads=4, n_kv=2,
                          d_ff=128, vocab=97,
                          attn=JAttnConfig(window=W, k=W,
                                           backend="mita_ref"))
        jp, mk = jrg.rg_init(key, jc), RGLRUBackend
    return _port_cfg(jc), params_from_jax(jax.device_get(jp)), mk


@pytest.fixture(scope="module")
def cell():
    """``(cfg, params, engine factory)`` of the reference's MiTA cell."""
    cfg, params, _ = _cells("mita")

    def engine(ecfg, backend=None):
        backend = backend or MiTABackend(params, cfg, ecfg, device="cpu")
        return ServingEngine(params, cfg, ecfg, backend=backend)

    return cfg, params, engine


def _requests(vocab, specs, temperature=0.0, seed=7):
    rng = np.random.default_rng(seed)
    return [Request(rid=i, prompt=rng.integers(0, vocab, ln).astype(np.int32),
                    max_new_tokens=g, temperature=temperature)
            for i, (ln, g) in enumerate(specs)]


def _tokens(done):
    return {f.rid: f.tokens.tolist() for f in done if not f.cancelled}


# --------------------------------------------------------------- the battery

def test_alloc_prefill_decode_reference_parity(cell):
    cfg, params, engine = cell
    reqs = _requests(cfg.vocab, [(W, 4), (2 * W, 7), (3 * W, 3), (W, 6)])
    eng = engine(EngineConfig(n_slots=2, pages_per_slot=5, n_pages=12,
                              prefill_chunk=W))
    done = eng.run(reqs)
    assert len(done) == len(reqs)
    ref = eng.backend.fresh()
    for f, r in zip(done, reqs):
        expect = ref.static_reference(r.prompt[None], r.max_new_tokens)
        np.testing.assert_array_equal(f.tokens, expect[0],
                                      err_msg=f"req {f.rid}")


def test_preempt_recompute_parity(cell):
    cfg, params, engine = cell
    rng = np.random.default_rng(3)
    victim = rng.integers(0, cfg.vocab, 2 * W).astype(np.int32)
    ecfg = EngineConfig(n_slots=2, pages_per_slot=6, n_pages=8,
                        prefill_chunk=2 * W)
    ref = engine(ecfg).run(
        [Request(rid=0, prompt=victim, max_new_tokens=16)])[0].tokens
    eng = engine(ecfg)
    eng.submit(Request(rid=0, prompt=victim, max_new_tokens=16, priority=0))
    for _ in range(6):
        eng.step()
    hp = rng.integers(0, cfg.vocab, (2, 2 * W)).astype(np.int32)
    for i in (1, 2):
        eng.submit(Request(rid=i, prompt=hp[i - 1], max_new_tokens=16,
                           priority=5))
    while eng.step():
        pass
    done = sorted(eng.finished, key=lambda f: f.rid)
    assert len(done) == 3
    assert eng.n_preemptions >= 1, "scenario no longer triggers preemption"
    np.testing.assert_array_equal(done[0].tokens, ref)


def test_retire_releases_everything(cell):
    cfg, params, engine = cell
    ecfg = EngineConfig(n_slots=3, pages_per_slot=5, n_pages=15,
                        prefill_chunk=W)
    eng = engine(ecfg)
    eng.run(_requests(cfg.vocab, [(W, 3), (2 * W, 5), (W, 2), (2 * W, 4)]))
    assert eng.alloc.in_use == 0 and eng.alloc.refs == {}
    assert sorted(eng.alloc.free) == list(range(ecfg.n_pages))
    assert not eng.active.any() and not eng.slot_pages
    assert sorted(eng.free_slots) == list(range(ecfg.n_slots))


def test_stats_schema_is_exact(cell):
    cfg, params, engine = cell
    eng = engine(EngineConfig(n_slots=2, pages_per_slot=4, n_pages=8,
                              prefill_chunk=W))
    eng.run(_requests(cfg.vocab, [(W, 2)]))
    st = eng.stats()
    assert set(st) == STATS_SCHEMA, (set(st) ^ STATS_SCHEMA)
    assert set(eng.backend.stats()) == BACKEND_STAT_KEYS
    assert st["backend"] == "mita" and "backend" in ENGINE_STAT_KEYS


@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_speculative_parity(cell, temperature):
    """spec_k = 3 streams are bit-identical to spec_k = 0, requests retire
    after the same tokens, drafts are both accepted and rolled back, and
    the counters are consistent."""
    cfg, params, engine = cell
    specs = [(W, 5), (2 * W - 3, 9), (2 * W, 4), (5, 11)]
    base_ecfg = EngineConfig(n_slots=3, pages_per_slot=4, n_pages=24,
                             prefill_chunk=W, sample_device="fused")
    base = _tokens(engine(base_ecfg).run(
        _requests(cfg.vocab, specs, temperature=temperature)))
    eng = engine(dataclasses.replace(base_ecfg, spec_k=3))
    got = _tokens(eng.run(_requests(cfg.vocab, specs,
                                    temperature=temperature)))
    assert got == base
    st = eng.stats()
    assert 0 < st["spec_accepted"] < st["spec_drafted"]
    assert 0 < st["spec_rollbacks"] \
        <= st["spec_drafted"] - st["spec_accepted"]


def test_speculation_contract_surface(cell):
    cfg, params, engine = cell
    eng = engine(EngineConfig(n_slots=2, pages_per_slot=4, n_pages=8))
    assert eng.backend.supports_speculation
    h = eng.backend.draft_horizon(np.array([0, 5, W - 1, W, 3 * W + 2]))
    assert h.shape == (5,) and np.issubdtype(h.dtype, np.integer)
    assert (h >= 0).all()
    with pytest.raises(ValueError, match="fused"):
        engine(EngineConfig(n_slots=2, pages_per_slot=4, n_pages=8,
                            spec_k=2))
    with pytest.raises(ValueError, match="landmark"):
        MiTABackend(params, cfg, EngineConfig(spec_k=2, spec_mode="stress",
                                              sample_device="fused"),
                    device="cpu")


def test_base_backend_refuses_speculation(cell):
    cfg, params, _ = cell
    b = BackendBase(None, None, EngineConfig())
    assert not b.supports_speculation
    for call in (lambda: b.draft_steps(*[None] * 9),
                 lambda: b.verify_step(*[None] * 10),
                 lambda: b.rollback(None, None)):
        with pytest.raises(NotImplementedError, match="speculative"):
            call()
    assert (b.draft_horizon(np.zeros(3, np.int32))
            == np.iinfo(np.int32).max).all()

    class NoSpec(MiTABackend):
        supports_speculation = False

    ecfg = EngineConfig(n_slots=2, pages_per_slot=4, n_pages=8, spec_k=2,
                        sample_device="fused")
    with pytest.raises(ValueError, match="does not support speculative"):
        ServingEngine(params, cfg, ecfg,
                      backend=NoSpec(params, cfg, ecfg, device="cpu"))


class _Fault(RuntimeError):
    pass


class _FaultOnce:
    """Delegates to a backend; once armed, the next call of ``op`` raises
    before it reaches the wrapped backend."""

    def __init__(self, inner, op):
        self.inner, self.op, self.armed = inner, op, False

    def __getattr__(self, name):
        attr = getattr(self.inner, name)
        if name != self.op or not self.armed:
            return attr

        def fault(*args, **kwargs):
            self.armed = False
            raise _Fault(name)
        return fault


@pytest.mark.parametrize("chunk,op", [(0, "prefill_group"),
                                      (W, "prefill_chunks"),
                                      (W, "decode_step")])
def test_midstep_exception_leaks_no_pages(cell, chunk, op):
    cfg, params, engine = cell
    specs = [(W, 3), (2 * W, 4)]
    ecfg = EngineConfig(n_slots=2, pages_per_slot=4, n_pages=10,
                        prefill_chunk=chunk)
    inner = MiTABackend(params, cfg, ecfg, device="cpu")
    fb = _FaultOnce(inner, op)
    eng = engine(ecfg, backend=fb)
    for r in _requests(cfg.vocab, specs):
        eng.submit(r)
    if op == "decode_step":        # land the fault after prefill finished
        while not eng.active.any():
            eng.step()
    fb.armed = True
    with pytest.raises(_Fault):
        while eng.step():
            pass
    while eng.step():              # fault healed: the same engine drains
        pass
    assert eng.alloc.in_use == 0 and eng.alloc.refs == {}
    ref = inner.fresh()
    for f, r in zip(sorted(eng.finished, key=lambda f: f.rid),
                    _requests(cfg.vocab, specs)):
        np.testing.assert_array_equal(
            f.tokens, ref.static_reference(r.prompt[None],
                                           r.max_new_tokens)[0])


# ------------------------------------------------------ the recurrent cells

@pytest.fixture(scope="module", params=("mamba2", "rglru"))
def rcell(request):
    """``(name, cfg, params, engine factory, backend class)`` of the
    reference's recurrent cells, on the port."""
    cfg, params, mk = _cells(request.param)

    def engine(ecfg, backend=None):
        backend = backend or mk(params, cfg, ecfg, device="cpu")
        return ServingEngine(params, cfg, ecfg, backend=backend)

    return request.param, cfg, params, engine, mk


def test_recurrent_cell_reference_parity(rcell):
    """Chunked admission with slot reuse: every greedy stream equals the
    backend's static reference."""
    name, cfg, params, engine, _ = rcell
    reqs = _requests(cfg.vocab, [(W, 4), (2 * W, 7), (3 * W, 3), (W, 6)])
    eng = engine(EngineConfig(n_slots=2, pages_per_slot=5, n_pages=12,
                              prefill_chunk=W))
    done = eng.run(reqs)
    assert len(done) == len(reqs)
    ref = eng.backend.fresh()
    for f, r in zip(done, reqs):
        np.testing.assert_array_equal(
            f.tokens, ref.static_reference(r.prompt[None],
                                           r.max_new_tokens)[0],
            err_msg=f"{name} req {f.rid}")


def test_recurrent_cell_preempt_recompute_parity(rcell):
    name, cfg, params, engine, _ = rcell
    rng = np.random.default_rng(3)
    victim = rng.integers(0, cfg.vocab, 2 * W).astype(np.int32)
    ecfg = EngineConfig(n_slots=2, pages_per_slot=6, n_pages=8,
                        prefill_chunk=2 * W)
    ref = engine(ecfg).run(
        [Request(rid=0, prompt=victim, max_new_tokens=16)])[0].tokens
    eng = engine(ecfg)
    eng.submit(Request(rid=0, prompt=victim, max_new_tokens=16, priority=0))
    for _ in range(6):
        eng.step()
    hp = rng.integers(0, cfg.vocab, (2, 2 * W)).astype(np.int32)
    for i in (1, 2):
        eng.submit(Request(rid=i, prompt=hp[i - 1], max_new_tokens=16,
                           priority=5))
    while eng.step():
        pass
    done = sorted(eng.finished, key=lambda f: f.rid)
    assert len(done) == 3
    assert eng.n_preemptions >= 1, "scenario no longer triggers preemption"
    np.testing.assert_array_equal(done[0].tokens, ref,
                                  err_msg=f"{name} victim diverged")


def test_recurrent_cell_retire_releases_everything(rcell):
    name, cfg, params, engine, _ = rcell
    ecfg = EngineConfig(n_slots=3, pages_per_slot=5, n_pages=15,
                        prefill_chunk=W)
    eng = engine(ecfg)
    eng.run(_requests(cfg.vocab, [(W, 3), (2 * W, 5), (W, 2), (2 * W, 4)]))
    assert eng.alloc.in_use == 0 and eng.alloc.refs == {}, name
    assert sorted(eng.alloc.free) == list(range(ecfg.n_pages))
    assert not eng.active.any() and not eng.slot_pages
    assert sorted(eng.free_slots) == list(range(ecfg.n_slots))


def test_recurrent_cell_stats_schema_is_exact(rcell):
    name, cfg, params, engine, _ = rcell
    eng = engine(EngineConfig(n_slots=2, pages_per_slot=4, n_pages=8,
                              prefill_chunk=W))
    eng.run(_requests(cfg.vocab, [(W, 2)]))
    st = eng.stats()
    assert set(st) == STATS_SCHEMA, (set(st) ^ STATS_SCHEMA)
    assert set(eng.backend.stats()) == BACKEND_STAT_KEYS
    assert st["backend"] == name
    assert st["prefill_kernel_fallbacks"] == 0


@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_recurrent_cell_speculative_parity_all_modes(rcell, temperature):
    """spec_k = 3 in the self and stress modes: streams equal the port's
    spec_k = 0 run; self drafts all verify, stress drafts roll back."""
    name, cfg, params, engine, _ = rcell
    specs = [(W, 5), (2 * W - 3, 9), (2 * W, 4), (5, 11)]
    base_ecfg = EngineConfig(n_slots=3, pages_per_slot=4, n_pages=24,
                             prefill_chunk=W, sample_device="fused")
    base = _tokens(engine(base_ecfg).run(
        _requests(cfg.vocab, specs, temperature=temperature)))
    for mode in ("self", "stress"):
        eng = engine(dataclasses.replace(base_ecfg, spec_k=3,
                                         spec_mode=mode))
        got = _tokens(eng.run(_requests(cfg.vocab, specs,
                                        temperature=temperature)))
        assert got == base, f"{name} spec_mode={mode}"
        st = eng.stats()
        assert st["spec_accepted"] <= st["spec_drafted"]
        assert st["spec_rollbacks"] \
            <= st["spec_drafted"] - st["spec_accepted"]
        if mode == "self":
            assert st["spec_rollbacks"] == 0
            assert st["spec_accepted"] == st["spec_drafted"] > 0
        else:
            assert st["spec_rollbacks"] > 0


def test_recurrent_cell_speculation_contract_surface(rcell):
    name, cfg, params, engine, mk = rcell
    eng = engine(EngineConfig(n_slots=2, pages_per_slot=4, n_pages=8))
    assert eng.backend.supports_speculation
    h = eng.backend.draft_horizon(np.array([0, 5, W - 1, W, 3 * W + 2]))
    assert h.shape == (5,) and np.issubdtype(h.dtype, np.integer)
    assert (h >= 0).all()
    with pytest.raises(ValueError, match="fused"):
        engine(EngineConfig(n_slots=2, pages_per_slot=4, n_pages=8,
                            spec_k=2))
    with pytest.raises(ValueError, match="self"):
        mk(params, cfg, EngineConfig(spec_k=2, spec_mode="landmark",
                                     sample_device="fused"), device="cpu")


@pytest.mark.parametrize("chunk,op", [(0, "prefill_group"),
                                      (W, "prefill_chunks"),
                                      (W, "decode_step")])
def test_recurrent_cell_midstep_exception_leaks_no_pages(rcell, chunk, op):
    name, cfg, params, engine, mk = rcell
    specs = [(W, 3), (2 * W, 4)]
    ecfg = EngineConfig(n_slots=2, pages_per_slot=4, n_pages=10,
                        prefill_chunk=chunk)
    inner = mk(params, cfg, ecfg, device="cpu")
    fb = _FaultOnce(inner, op)
    eng = engine(ecfg, backend=fb)
    for r in _requests(cfg.vocab, specs):
        eng.submit(r)
    if op == "decode_step":
        while not eng.active.any():
            eng.step()
    fb.armed = True
    with pytest.raises(_Fault):
        while eng.step():
            pass
    while eng.step():
        pass
    assert eng.alloc.in_use == 0 and eng.alloc.refs == {}, f"{name}/{op}"
    ref = inner.fresh()
    for f, r in zip(sorted(eng.finished, key=lambda f: f.rid),
                    _requests(cfg.vocab, specs)):
        np.testing.assert_array_equal(
            f.tokens, ref.static_reference(r.prompt[None],
                                           r.max_new_tokens)[0],
            err_msg=f"{name}/{op}: stream diverged after fault")


# ------------------------------------------------- supervision and fuzzing

def _complete(done):
    return {f.rid: f.tokens.tolist() for f in done if f.reason == "complete"}


@pytest.mark.parametrize("name", ["mita", "mamba2", "rglru"])
def test_supervised_chaos_parity(name):
    """Seeded chaos (transient + slot-bound faults + allocator spikes)
    under the supervisor: every request completes bit-identical to the
    fault-free engine, the pool drains to zero, and the robustness
    counters in `stats()` actually move — for every backend."""
    cfg, params, mk = _cells(name)
    specs = [(W, 4), (2 * W, 6), (W, 3), (2 * W, 5)]
    ecfg = EngineConfig(n_slots=2, pages_per_slot=4, n_pages=12,
                        prefill_chunk=W)
    ref = _complete(ServingEngine(
        params, cfg, ecfg, backend=mk(params, cfg, ecfg, device="cpu")).run(
            _requests(cfg.vocab, specs)))
    chaos = ChaosConfig(seed=5, p_fault=0.3, transient_len=2,
                        p_slot_fault=0.4, alloc_spike_every=5,
                        alloc_spike_pages=2,
                        ops=("decode_step", "prefill_chunks"))
    cb = ChaosBackend(mk(params, cfg, ecfg, device="cpu"), chaos)
    eng = ServingEngine(params, cfg, ecfg, backend=cb)
    sup = Supervisor(eng, SupervisorConfig(max_retries=2, stall_steps=4))
    done = sup.run(_requests(cfg.vocab, specs))
    sup.close()
    assert _complete(done) == ref, f"{name}: supervised streams diverged"
    assert eng.alloc.in_use == 0 and eng.alloc.refs == {}
    assert cb.n_injected > 0, f"{name}: chaos schedule fired nothing"
    assert sup.stats()["retries"] > 0


@settings(max_examples=6, deadline=None)
@given(st.sampled_from(["mita", "mamba2"]), st.integers(1, 4),
       st.booleans(), st.booleans(), st.integers(0, 2**31 - 1))
def test_speculative_schedule_fuzz(name, spec_k, cancel, chaos, seed):
    """Property: ANY random schedule — prompt lengths, generation budgets,
    staggered arrivals, optional mid-trace cancellation, optional seeded
    chaos (supervised transient/slot faults + allocator spikes) — gives
    token streams bit-identical to the fault-free spec_k=0 engine for
    every request that ran to completion, and the allocator ends every
    trace with zero pages in use (mita exercises the landmark drafter;
    mamba2 the stress mode, so rollback replay is fuzzed too).  Chaos
    only intercepts ops whose faults fire BEFORE any state mutation
    (`draft_steps` is gated pre-draft, never `verify_step`), so a retried
    step replays against unchanged backend state by construction."""
    _fuzz_case(name, spec_k, cancel, chaos, seed)


def _fuzz_case(name, spec_k, cancel, chaos, seed):
    cfg, params, mk = _cells(name)
    rng = np.random.default_rng(seed)
    servable = [5, 6, W, W + 2, 2 * W - 2, 2 * W]
    specs = [(int(rng.choice(servable)), int(rng.integers(2, 10)))
             for _ in range(5)]
    mode = "auto" if name == "mita" else "stress"

    def run(k, with_chaos):
        ecfg = EngineConfig(n_slots=2, pages_per_slot=4, n_pages=16,
                            prefill_chunk=W, sample_device="fused",
                            spec_k=k, spec_mode=mode if k else "auto")
        backend = mk(params, cfg, ecfg, device="cpu")
        cb = None
        if with_chaos:
            backend = cb = ChaosBackend(backend, ChaosConfig(
                seed=seed ^ 0xC0FFEE, p_fault=0.2, transient_len=2,
                p_slot_fault=0.3, alloc_spike_every=7, alloc_spike_pages=2,
                ops=("decode_step", "prefill_chunks", "draft_steps")))
        eng = ServingEngine(params, cfg, ecfg, backend=backend)
        sup = Supervisor(eng, SupervisorConfig(max_retries=2,
                                               stall_steps=4)) \
            if with_chaos else None
        step = sup.step if sup is not None else eng.step
        pend = _requests(cfg.vocab, specs, seed=seed)
        idx = steps = 0
        while idx < len(pend) or eng.waiting or eng.prefilling \
                or eng.active.any():
            while idx < len(pend) and idx <= steps:
                eng.submit(pend[idx])
                idx += 1
            if cancel and steps == 3:
                eng.cancel(1)
            step()
            steps += 1
        if cb is not None:
            cb.release_spikes()
            sup.close()
        assert eng.alloc.in_use == 0 and eng.alloc.refs == {}, "page leak"
        return _complete(eng.finished)

    got, base = run(spec_k, chaos), run(0, False)
    # the one cancel target may legitimately finish before the cancel
    # fires in one run but not the other (spec_k / retries shift how many
    # tokens a loop iteration emits); every request completed in BOTH
    # runs must be bit-identical, and no other request may go missing
    ctx = f"{name} spec_k={spec_k} cancel={cancel} chaos={chaos} seed={seed}"
    assert set(got) ^ set(base) <= ({1} if cancel else set()), (
        f"{ctx}: completed-request sets diverged beyond the cancel target")
    for r in set(got) & set(base):
        assert got[r] == base[r], f"{ctx}: rid {r} diverged"


# schedules on which the reference's supervisor ends in SupervisionExhausted
# (ROADMAP C.9: a new slot fault with the last quarantine's signature is
# retried and sent to the ladder, which clears nothing); the port
# quarantines it again at once and completes
C9_EXAMPLES = [("mamba2", 1, False, 3398), ("mita", 2, True, 1375484614),
               ("mamba2", 4, True, 383294387), ("mita", 1, False, 1854459574),
               ("mamba2", 4, False, 619563013)]


@pytest.mark.parametrize("name,spec_k,cancel,seed", C9_EXAMPLES)
def test_speculative_schedule_fuzz_c9_examples(name, spec_k, cancel, seed):
    _fuzz_case(name, spec_k, cancel, True, seed)


# ------------------------------------------------------------ main-path gate

def _port_requests(reqs):
    return [Request(rid=r.rid, prompt=np.asarray(r.prompt),
                    max_new_tokens=r.max_new_tokens,
                    temperature=r.temperature, arrival=r.arrival,
                    priority=r.priority) for r in reqs]


def _gate(jc, ecfg_kw, reqs):
    jp = jtfm.lm_init(jax.random.PRNGKey(0), jc)
    want = JServingEngine(jp, jc, JEngineConfig(**ecfg_kw)).run(reqs)
    tp = params_from_jax(jax.device_get(jp))
    eng = ServingEngine(tp, _port_cfg(jc), EngineConfig(**ecfg_kw),
                        device="cpu")
    got = eng.run(_port_requests(reqs))
    assert [f.reason for f in got] == ["complete"] * len(reqs)
    assert [f.rid for f in got] == [f.rid for f in want]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.tokens, w.tokens,
                                      err_msg=f"rid {g.rid}")
    return eng


def test_main_path_gate_poisson_trace():
    """``serve_poisson``'s model and engine (monolithic prefill)."""
    jc = tiny_lm_cfg("mita", m=8, k=16, layers=2, d=64, seq=256)
    w = jc.attn.window
    pages = window_aligned(2 * w + 4 * w, w) // w
    _gate(jc, dict(n_slots=8, pages_per_slot=pages, n_pages=16 * pages),
          _trace(jc.vocab, w, 8))


def test_main_path_gate_interference_trace():
    """``serve_interference``'s model and chunked + preemptive engine."""
    jc = tiny_lm_cfg("mita_ref", m=8, k=16, layers=2, d=64, seq=256)
    w = jc.attn.window
    pages = window_aligned(12 * w + 8, w) // w
    eng = _gate(jc, dict(n_slots=8, pages_per_slot=pages,
                         n_pages=3 * pages + 6, prefill_chunk=2 * w,
                         reserve_pages=4),
                _interference_trace(jc.vocab, w, 6, 1))
    assert eng.stats()["chunks"] > 1
