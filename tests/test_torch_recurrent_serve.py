"""The port's recurrent serving path against the JAX reference: mamba2-370m
and recurrentgemma-9b at their smoke sizes (float32, weights from the JAX
init carried over by `repro_torch.convert`), served by `ServingEngine`
over `serve.backends.for_arch`.

* Greedy streams equal the JAX engine's and the backend's own
  `static_reference` (a time-major loop of the decode step) in the
  monolithic, batched-chunked and per-job-chunked modes, with prompts
  that are not window-aligned and slots reused.
* A preempted victim (recompute-from-prompt) re-emits its stream.
* ``spec_k = 3`` in the ``self`` and ``stress`` modes equals the port's
  own ``spec_k = 0`` run at temperatures 0 and 0.8 (held to the port's
  run, not to the JAX streams: ROADMAP C.7).
* `for_arch` / `resolve`, and the serving CLI on the CPU.
"""

import jax
import numpy as np
import pytest
import torch

from repro.configs.registry import arch_params as jarch_params
from repro.configs.registry import get_arch as jget_arch
from repro.serve import EngineConfig as JEngineConfig
from repro.serve import Request as JRequest
from repro.serve import ServingEngine as JServingEngine
from repro.serve import backends as jbackends
from repro_torch.configs.registry import arch_params
from repro_torch.configs.registry import get_arch as tget_arch
from repro_torch.convert import params_from_jax
from repro_torch.serve import EngineConfig, Request, ServingEngine, backends
from repro_torch.serve.backends.recurrent import Mamba2Backend, RGLRUBackend

ARCHS = ("mamba2-370m", "recurrentgemma-9b")
MODES = {"monolithic": dict(prefill_chunk=0),
         "batched": dict(prefill_chunk=16),
         "per-job": dict(prefill_chunk=16, prefill_mode="per-job")}


@pytest.fixture(autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module", params=ARCHS)
def arch(request):
    ja = jget_arch(request.param, smoke=True)
    ta = tget_arch(request.param, smoke=True)
    jp = jarch_params(ja, jax.random.PRNGKey(0))
    return ja, ta, jp, params_from_jax(jax.device_get(jp))


def _engine(ta, tp, **kw):
    ecfg = EngineConfig(**kw)
    return ServingEngine(tp, ta.model, ecfg,
                         backend=backends.for_arch(ta, tp, ecfg,
                                                   device="cpu"))


def _specs(w=16):
    """(prompt length, new tokens): aligned and not, slots reused."""
    return [(2 * w, 6), (w, 9), (3 * w - 5, 4), (w + 3, 7)]


def _prompts(specs, vocab=251, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, n).astype(np.int32) for n, _ in specs]


@pytest.mark.parametrize("mode", list(MODES))
def test_engine_streams_equal_jax_engine_and_static_reference(arch, mode):
    ja, ta, jp, tp = arch
    specs = _specs()
    prompts = _prompts(specs)
    kw = dict(n_slots=2, pages_per_slot=5, n_pages=12, **MODES[mode])
    eng = _engine(ta, tp, **kw)
    done = eng.run([Request(rid=i, prompt=p, max_new_tokens=g)
                    for i, (p, (_, g)) in enumerate(zip(prompts, specs))])
    jecfg = JEngineConfig(**kw)
    jdone = JServingEngine(jp, ja.model, jecfg,
                           backend=jbackends.for_arch(ja, jp, jecfg)).run(
        [JRequest(rid=i, prompt=p, max_new_tokens=g)
         for i, (p, (_, g)) in enumerate(zip(prompts, specs))])
    ref = eng.backend.fresh()
    assert [f.reason for f in done] == ["complete"] * len(specs)
    for f, jf, p, (_, g) in zip(done, jdone, prompts, specs):
        np.testing.assert_array_equal(f.tokens, np.asarray(jf.tokens),
                                      err_msg=f"rid {f.rid} vs JAX engine")
        np.testing.assert_array_equal(
            f.tokens, ref.static_reference(p[None], g)[0],
            err_msg=f"rid {f.rid} vs static_reference")
    st = eng.stats()
    if mode == "per-job":
        # one chunk per dispatch; the non-aligned prompts chunk too
        assert st["chunks"] == st["prefill_dispatches"] > len(specs)
    if mode == "batched":
        assert st["chunks"] > st["prefill_dispatches"]


def test_preemption_recompute_is_token_exact(arch):
    """A low-priority victim evicted mid-decode by high-priority arrivals
    (rebuilt by chunk prefill over prompt + emitted tokens) emits the
    tokens of its unpreempted run."""
    _, ta, _, tp = arch
    rng = np.random.default_rng(3)
    victim = rng.integers(0, 251, 32).astype(np.int32)
    kw = dict(n_slots=2, pages_per_slot=4, n_pages=5, prefill_chunk=32)
    ref = _engine(ta, tp, **kw).run(
        [Request(rid=0, prompt=victim, max_new_tokens=24)])[0].tokens
    eng = _engine(ta, tp, **kw)
    eng.submit(Request(rid=0, prompt=victim, max_new_tokens=24))
    for _ in range(6):
        eng.step()
    for i in (1, 2):
        eng.submit(Request(rid=i, prompt=rng.integers(0, 251, 32).astype(
            np.int32), max_new_tokens=24, priority=5))
    while eng.step():
        pass
    done = sorted(eng.finished, key=lambda f: f.rid)
    assert len(done) == 3 and eng.n_preemptions >= 1
    np.testing.assert_array_equal(done[0].tokens, ref)


@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_speculation_self_and_stress_equal_plain_decode(arch, temperature):
    """spec_k = 3 in both recurrent modes: streams equal spec_k = 0 (the
    port's own run); self drafts all verify, stress drafts roll back."""
    _, ta, _, tp = arch
    specs = [(16, 5), (29, 9), (32, 4), (5, 11)]
    prompts = _prompts(specs, seed=4)
    base = dict(n_slots=3, pages_per_slot=4, n_pages=24, prefill_chunk=16,
                sample_device="fused")

    def run(**kw):
        eng = _engine(ta, tp, **base, **kw)
        done = eng.run([Request(rid=i, prompt=p, max_new_tokens=g,
                                temperature=temperature)
                        for i, (p, (_, g)) in enumerate(zip(prompts,
                                                            specs))])
        return {f.rid: f.tokens.tolist() for f in done}, eng.stats()

    want, _ = run()
    for mode in ("self", "stress"):
        got, st = run(spec_k=3, spec_mode=mode)
        assert got == want, mode
        if mode == "self":
            assert st["spec_rollbacks"] == 0
            assert st["spec_accepted"] == st["spec_drafted"] > 0
        else:
            assert st["spec_rollbacks"] > 0


def test_for_arch_and_resolve():
    """`for_arch` gives each family its backend; `resolve` (a bare
    `ModelConfig`) refuses the recurrent ones, as the reference does."""
    for name, cls in (("recurrentgemma-9b", RGLRUBackend),
                      ("mamba2-370m", Mamba2Backend)):
        ta = tget_arch(name, smoke=True)
        tp = arch_params(ta, torch.Generator().manual_seed(0), "cpu")
        ecfg = EngineConfig(n_slots=2, pages_per_slot=4, n_pages=8)
        assert isinstance(backends.for_arch(ta, tp, ecfg, device="cpu"), cls)
    with pytest.raises(ValueError, match="MiTA"):
        ServingEngine(tp, ta.model, EngineConfig())
    with pytest.raises(ValueError, match="self"):
        Mamba2Backend(tp, ta.model, EngineConfig(
            spec_k=2, spec_mode="landmark", sample_device="fused"),
            device="cpu")


@pytest.mark.parametrize("name", ARCHS)
def test_serve_cli_static_and_per_job(name):
    """`repro_torch.launch.serve` on the CPU: the backend's static
    reference and the per-job chunked engine give the same tokens."""
    from repro_torch.launch.serve import main
    args = ["--arch", name, "--smoke", "--device", "cpu", "--batch", "2",
            "--prompt-len", "32", "--gen", "5"]
    st = main(args + ["--engine", "static"])
    eng = main(args + ["--engine", "continuous", "--prefill-chunk", "16",
                       "--prefill-mode", "per-job", "--requests", "2"])
    for i in range(2):
        np.testing.assert_array_equal(eng["tokens"][i], st["tokens"][i])


@pytest.mark.parametrize("mode", ["batched", "per-job"])
def test_warmup_runs_on_a_scratch_engine(arch, mode):
    """`ServingEngine.warmup` drives every path for the given lengths on a
    scratch engine: this engine's pages, slots and finished list stay
    untouched, and a later run still equals the static reference."""
    _, ta, _, tp = arch
    eng = _engine(ta, tp, n_slots=2, pages_per_slot=4, n_pages=10,
                  prefill_chunk=16, prefill_mode=mode)
    eng.warmup([16, 21])
    assert eng.alloc.in_use == 0 and not eng.finished and eng.steps == 0
    assert sorted(eng.free_slots) == [0, 1]
    p = _prompts([(21, 4)], seed=8)[0]
    done = eng.run([Request(rid=0, prompt=p, max_new_tokens=4)])
    np.testing.assert_array_equal(
        done[0].tokens, eng.backend.fresh().static_reference(p[None], 4)[0])
