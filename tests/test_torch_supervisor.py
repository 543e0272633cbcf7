"""Supervised serving on the port: the supervisor + chaos battery of
``tests/test_supervisor.py`` on the port's MiTA cell, the same schedules
through both packages, the step timer, and torn dispatches.

The cell is the reference's (2 layers, d_model 64, 4 heads / 2 KV heads,
vocab 89, window 8, ``mita_ref``, float32 on the CPU) with the JAX init's
weights (`repro_torch.convert`).  Everything is compared exactly: tokens,
injector counters, supervision counters and journals; no tolerance enters.

  * the 16 policy tests: deterministic schedules, each fault kind's
    lifecycle (retry / quarantine / ladder rung), deadline and rejection
    accounting, stall relief under allocator spikes, straggler counting,
    the `AllocatorInvariantError` no-retry contract and the snapshot /
    restore journal;
  * the cross-package check: one `ChaosConfig` on one trace through the
    JAX `Supervisor` + `ServingEngine` and through the port's gives equal
    tokens, ``n_injected`` / ``n_faults_started`` / ``n_spikes``,
    retries, quarantines, ladder rungs and snapshot JSON (arrival times
    left out), for a transient, a slot-bound and a ladder schedule and a
    kill after 6 steps followed by a restore;
  * torn dispatches (`serve.backends.TornDispatch`): one layer function of
    a decode and of a chunk-prefill dispatch raises after the first layer
    ran, on each backend.  Supervised, the streams equal the fault-free
    run and the dispatch is quarantined, not retried; on the bare engine
    the exception propagates; a control that retries instead shows a
    different state where the dispatch had written state in place;
  * ROADMAP C.13, a property the reference shares: its preemption round
    trip is bit exact in float32 and parts in bfloat16; the port's is
    exact in float32.
"""

import dataclasses
import functools
import json
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import mamba2 as jm2
from repro.models import rglru as jrg
from repro.models import transformer as jtfm
from repro.models.modules import AttnConfig as JAttnConfig
from repro.models.modules import ModelConfig as JModelConfig
from repro.serve import ChaosBackend as JChaosBackend
from repro.serve import ChaosConfig as JChaosConfig
from repro.serve import EngineConfig as JEngineConfig
from repro.serve import Request as JRequest
from repro.serve import ServingEngine as JServingEngine
from repro.serve import Supervisor as JSupervisor
from repro.serve import SupervisorConfig as JSupervisorConfig
from repro.serve.backends.mita import MiTABackend as JMiTABackend
from repro_torch.convert import params_from_jax
from repro_torch.distributed.fault_tolerance import StepTimer
from repro_torch.models import mamba2 as m2
from repro_torch.models import rglru as rg
from repro_torch.models import transformer as tfm
from repro_torch.models.modules import AttnConfig, ModelConfig
from repro_torch.serve import (AllocatorInvariantError, ChaosBackend,
                               ChaosConfig, EngineConfig, Request,
                               ServingEngine, Supervisor, SupervisorConfig,
                               SupervisionExhausted)
from repro_torch.serve.backends import TornDispatch
from repro_torch.serve.backends.mita import MiTABackend
from repro_torch.serve.backends.recurrent import Mamba2Backend, RGLRUBackend
from repro_torch.serve.supervisor import DEGRADATION_RUNGS

W = 8
SPECS = [(W, 4), (2 * W, 6), (W, 3)]


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
def _jcell():
    jc = JModelConfig(
        n_layers=2, d_model=64, n_heads=4, n_kv=2, d_ff=128, vocab=89,
        attn=JAttnConfig(window=W, k=W, backend="mita_ref"))
    return jc, jtfm.lm_init(jax.random.PRNGKey(0), jc)


@functools.lru_cache(maxsize=None)
def _cell():
    jc, jp = _jcell()
    return _port_cfg(jc), params_from_jax(jax.device_get(jp))


def _ecfg(**kw):
    base = dict(n_slots=2, pages_per_slot=4, n_pages=12, prefill_chunk=W)
    base.update(kw)
    return EngineConfig(**base)


def _engine(ecfg=None, chaos=None):
    cfg, params = _cell()
    ecfg = ecfg or _ecfg()
    backend = MiTABackend(params, cfg, ecfg, device="cpu")
    if chaos is not None:
        backend = ChaosBackend(backend, chaos)
    return ServingEngine(params, cfg, ecfg, backend=backend)


def _requests(specs, seed=7, cls=Request, vocab=89, **kw):
    rng = np.random.default_rng(seed)
    return [cls(rid=i, prompt=rng.integers(0, vocab, ln).astype(np.int32),
                max_new_tokens=g, **kw)
            for i, (ln, g) in enumerate(specs)]


def _tokens(done):
    return {f.rid: np.asarray(f.tokens).tolist() for f in done
            if f.reason == "complete"}


@functools.lru_cache(maxsize=None)
def _reference(specs=tuple(SPECS)):
    return tuple(sorted(_tokens(_engine().run(_requests(specs))).items()))


def _ref(specs=tuple(SPECS)):
    return dict(_reference(specs))


# ----------------------------------------------------------- chaos itself --

def test_chaos_schedule_is_deterministic():
    """Same ChaosConfig + same trace => identical fault schedule, counts,
    and (supervised) identical tokens."""
    chaos = ChaosConfig(seed=9, p_fault=0.3, transient_len=2,
                        p_slot_fault=0.5,
                        ops=("decode_step", "prefill_chunks"))
    outs = []
    for _ in range(2):
        eng = _engine(chaos=chaos)
        sup = Supervisor(eng, SupervisorConfig(max_retries=2))
        done = sup.run(_requests(SPECS))
        outs.append((eng.backend.n_injected, eng.backend.n_faults_started,
                     sup.stats()["retries"], sup.stats()["quarantined"],
                     tuple(sorted(_tokens(done).items()))))
    assert outs[0] == outs[1]
    assert outs[0][0] > 0


def test_chaos_inject_validates():
    cb = ChaosBackend(object(), ChaosConfig())
    with pytest.raises(ValueError, match="unknown op"):
        cb.inject("no_such_op")
    with pytest.raises(ValueError, match="unknown fault kind"):
        cb.inject("decode_step", kind="cosmic_ray")


# ------------------------------------------------------- fault lifecycles --

def test_transient_fault_retries_to_parity():
    """A transient fault is absorbed entirely by the retry loop: no
    quarantine, no rungs, bit-identical streams, counted retries."""
    eng = _engine(chaos=ChaosConfig(transient_len=2))
    sup = Supervisor(eng, SupervisorConfig(max_retries=3))
    cb = eng.backend
    for r in _requests(SPECS):
        sup.submit(r)
    while not eng.active.any():
        sup.step()
    cb.inject("decode_step")        # raises twice, then heals
    while sup.step():
        pass
    st = sup.stats()
    assert _tokens(eng.finished) == _ref()
    assert st["retries"] == 2 and st["quarantined"] == 0
    assert st["degradation_level"] == 0
    assert eng.alloc.in_use == 0 and eng.alloc.refs == {}


def test_slot_fault_quarantines_only_victim():
    """A slot-bound fault evicts ONLY the implicated slot; the victim
    resurrects through recompute-from-prompt bit-identically and the
    rest of the batch never stops."""
    eng = _engine(chaos=ChaosConfig())
    sup = Supervisor(eng, SupervisorConfig(max_retries=1))
    cb = eng.backend
    for r in _requests(SPECS):
        sup.submit(r)
    while not eng.active.any():
        sup.step()
    victim = int(np.nonzero(eng.active)[0][0])
    cb.inject("decode_step", kind="slot", slots=(victim,))
    while sup.step():
        pass
    st = sup.stats()
    assert _tokens(eng.finished) == _ref()
    assert st["quarantined"] == 1
    assert st["degradation_level"] == 0
    assert eng.stats()["preemptions"] >= 1
    assert eng.alloc.in_use == 0 and eng.alloc.refs == {}


def test_persistent_fault_walks_ladder_to_parity():
    """A batch-wide persistent fault climbs exactly as many rungs as it
    takes to clear, the rungs land in stats()/degradations, and the
    degraded engine still gates bit-parity."""
    eng = _engine(chaos=ChaosConfig(persistent_clears_at=2))
    sup = Supervisor(eng, SupervisorConfig(max_retries=1))
    eng.backend.inject("decode_step", kind="persistent")
    done = sup.run(_requests(SPECS))
    st = sup.stats()
    sup.close()
    assert _tokens(done) == _ref()
    assert st["degradation_level"] == 2
    assert sup.degradations == ["spec_off", "prefix_cache_off"]
    assert DEGRADATION_RUNGS[st["degradation_level"]] == "prefix_cache_off"
    assert eng.alloc.in_use == 0


def test_unclearable_fault_exhausts_supervision():
    """A fault nothing clears must end in SupervisionExhausted — loudly,
    not a spin."""
    eng = _engine(chaos=ChaosConfig(persistent_clears_at=99))
    sup = Supervisor(eng, SupervisorConfig(max_retries=1))
    eng.backend.inject("decode_step", kind="persistent")
    with pytest.raises(SupervisionExhausted, match="ladder"):
        sup.run(_requests(SPECS))
    sup.close()


def test_mita_verify_fault_is_retry_safe():
    """MiTA's landmark drafter is stateless, so a verify-step fault (it
    fires before the dispatch starts) can be retried without corrupting
    the stream — the spec'd supervised run stays bit-identical to
    spec_k=0."""
    base = _ecfg(n_pages=16, sample_device="fused")
    ref = _tokens(_engine(base).run(_requests(SPECS)))
    ecfg = dataclasses.replace(base, spec_k=3)
    eng = _engine(ecfg, chaos=ChaosConfig(seed=2, p_fault=0.3,
                                          transient_len=2,
                                          ops=("verify_step",)))
    sup = Supervisor(eng, SupervisorConfig(max_retries=3))
    done = sup.run(_requests(SPECS))
    assert _tokens(done) == ref
    assert eng.backend.n_injected > 0
    assert eng.alloc.in_use == 0


# --------------------------------------------- admission robustness paths --

def test_deadline_expired_finishes_with_reason():
    eng = _engine()
    sup = Supervisor(eng)
    reqs = _requests(SPECS)
    ok = [sup.submit(dataclasses.replace(
        r, deadline_ms=0.01 if r.rid == 1 else None)) for r in reqs]
    assert all(ok)
    time.sleep(0.005)
    while sup.step():
        pass
    by_rid = {f.rid: f for f in eng.finished}
    assert by_rid[1].reason == "deadline_expired" and by_rid[1].cancelled
    assert {r: f.tokens.tolist() for r, f in by_rid.items()
            if f.reason == "complete"} \
        == {r: t for r, t in _ref().items() if r != 1}
    assert sup.stats()["deadline_expired"] == 1
    assert eng.alloc.in_use == 0


def test_rejection_surfaces_through_supervisor():
    eng = _engine()
    sup = Supervisor(eng)
    huge = Request(rid=0, prompt=np.zeros(50 * W, np.int32),
                   max_new_tokens=4)
    assert sup.submit(huge) is False
    assert eng.finished[0].reason == "rejected"
    assert sup.stats()["rejected"] == 1


def test_allocator_invariant_error_is_never_retried(monkeypatch):
    eng = _engine()
    sup = Supervisor(eng, SupervisorConfig(max_retries=5))
    monkeypatch.setattr(eng, "step", lambda: (_ for _ in ()).throw(
        AllocatorInvariantError("page accounting corrupt")))
    with pytest.raises(AllocatorInvariantError):
        sup.step()
    assert sup.stats()["retries"] == 0 and sup.n_faults == 0


# -------------------------------------------------- pressure & stragglers --

def test_alloc_spikes_drain_via_stall_relief():
    """Spikes grab REAL pages every dispatch; stall relief must release
    them so the trace completes, with parity and zero leaks."""
    eng = _engine(chaos=ChaosConfig(alloc_spike_every=1,
                                    alloc_spike_pages=3,
                                    alloc_spike_len=50))
    sup = Supervisor(eng, SupervisorConfig(stall_steps=3))
    done = sup.run(_requests(SPECS))
    assert _tokens(done) == _ref()
    assert eng.backend.n_spikes >= 1
    assert eng.alloc.in_use == 0 and eng.alloc.refs == {}


def test_straggler_counter_reaches_stats():
    eng = _engine()
    sup = Supervisor(eng)
    for dt in (0.01, 0.01, 0.01, 0.01, 1.0):
        sup.timer.observe(dt)
    assert sup.stats()["stragglers"] == 1


def test_injected_straggler_is_detected():
    """`p_slow` dispatch delays must trip the shared StepTimer EWMA."""
    chaos = ChaosConfig(seed=4, p_slow=0.12, slow_s=0.3,
                        ops=("decode_step",))
    eng = _engine(chaos=chaos)
    sup = Supervisor(eng, SupervisorConfig(straggler_threshold=3.0))
    done = sup.run(_requests(SPECS))
    assert _tokens(done) == _ref()
    assert eng.backend.n_slowed >= 1
    assert sup.stats()["stragglers"] >= 1


# ------------------------------------------------------------ crash recovery --

def test_snapshot_restore_roundtrip_is_bit_exact(tmp_path):
    """Kill mid-trace, restore on a fresh engine from the journal file:
    the union of pre-kill and post-restore streams is bit-identical to
    the uninterrupted run, counters carry over, deadlines re-arm."""
    eng = _engine(chaos=ChaosConfig(seed=1, p_fault=0.25, transient_len=1,
                                    ops=("decode_step",)))
    sup = Supervisor(eng, SupervisorConfig(max_retries=2))
    for r in _requests(SPECS):
        sup.submit(r)
    for _ in range(5):
        if not sup.step():
            break
    path = str(tmp_path / "snap.json")
    sup.save_snapshot(path)
    assert not os.path.exists(path + ".tmp"), "atomic write left its tmp"
    snap = Supervisor.load_snapshot(path)

    eng2 = _engine()
    sup2 = Supervisor(eng2)
    sup2.restore(snap)
    while sup2.step():
        pass
    assert _tokens(eng2.finished) == _ref()
    assert eng2.n_retries == snap["counters"]["retries"]
    assert eng2.alloc.in_use == 0 and eng2.alloc.refs == {}


def test_restore_validation_errors():
    eng = _engine()
    sup = Supervisor(eng)
    for r in _requests(SPECS):
        sup.submit(r)
    sup.step()
    snap = sup.snapshot()

    with pytest.raises(ValueError, match="fresh engine"):
        sup.restore(snap)           # this engine already has work

    bad = dict(snap, backend="nope")
    with pytest.raises(ValueError, match="backend"):
        Supervisor(_engine()).restore(bad)

    if any(row["tokens"] for row in snap["requests"]):
        mono = _engine(_ecfg(prefill_chunk=0))
        with pytest.raises(ValueError, match="chunked prefill"):
            Supervisor(mono).restore(snap)


def test_snapshot_of_drained_engine_restores_finished_only():
    eng = _engine()
    sup = Supervisor(eng)
    sup.run(_requests(SPECS))
    snap = sup.snapshot()
    assert snap["requests"] == []
    eng2 = _engine()
    sup2 = Supervisor(eng2)
    sup2.restore(snap)
    assert not sup2.step()          # nothing to do
    assert _tokens(eng2.finished) == _ref()


# ------------------------------------------------------------- step timer --

def test_step_timer_straggler_detection():
    t = StepTimer(alpha=0.5, threshold=2.0)
    for _ in range(5):
        t.observe(0.1)
    assert not t.is_straggling
    t.observe(1.0)
    assert t.is_straggling
    assert t.n_stragglers == 1
    with t:                         # the context-manager form times too
        pass
    assert t.last is not None and t.last < 1.0


def test_xla_forced_rung_touches_no_environment(monkeypatch):
    """Level 3 keeps its name and notification and changes nothing else:
    the process environment and the engine's paths stay as they were."""
    monkeypatch.delenv("REPRO_PREFILL_IMPL", raising=False)
    env = dict(os.environ)
    eng = _engine(chaos=ChaosConfig(persistent_clears_at=3))
    cfg_before = eng.backend.cfg
    sup = Supervisor(eng, SupervisorConfig(max_retries=1))
    eng.backend.inject("decode_step", kind="persistent")
    done = sup.run(_requests(SPECS))
    sup.close()
    assert sup.degradations == list(DEGRADATION_RUNGS[1:])
    assert sup.stats()["degradation_level"] == 3
    assert dict(os.environ) == env
    assert eng.backend.cfg is cfg_before
    assert _tokens(done) == _ref()


# ------------------------------------------------- the cross-package check --

def _journal(snap):
    """A snapshot without its arrival times."""
    snap = json.loads(json.dumps(snap))
    for row in snap["requests"] + snap["finished"]:
        row.pop("arrival")
    return snap


def _run_pair(chaos_kw, specs=tuple(SPECS), scripted=None, kill_after=None,
              sup_kw=None):
    """The same chaos schedule through the JAX supervisor and engine and
    through the port's.  Returns one dict of observables per package."""
    sup_kw = sup_kw or {}
    jc, jp = _jcell()
    cfg, params = _cell()
    out = []
    for pkg in ("jax", "port"):
        if pkg == "jax":
            ecfg = JEngineConfig(n_slots=2, pages_per_slot=4, n_pages=12,
                                 prefill_chunk=W)
            cb = JChaosBackend(JMiTABackend(jp, jc, ecfg),
                               JChaosConfig(**chaos_kw))
            eng = JServingEngine(jp, jc, ecfg, backend=cb)
            sup = JSupervisor(eng, JSupervisorConfig(**sup_kw))
            reqs = _requests(specs, cls=JRequest)
        else:
            ecfg = _ecfg()
            cb = ChaosBackend(MiTABackend(params, cfg, ecfg, device="cpu"),
                              ChaosConfig(**chaos_kw))
            eng = ServingEngine(params, cfg, ecfg, backend=cb)
            sup = Supervisor(eng, SupervisorConfig(**sup_kw))
            reqs = _requests(specs)
        if scripted is not None:
            cb.inject(*scripted)
        res = {}
        if kill_after is None:
            done = sup.run(reqs)
        else:
            for r in reqs:
                sup.submit(r)
            for _ in range(kill_after):
                sup.step()
            snap = sup.snapshot()
            res["kill_journal"] = _journal(snap)
            if pkg == "jax":
                eng = JServingEngine(jp, jc, ecfg,
                                     backend=JMiTABackend(jp, jc, ecfg))
                sup = JSupervisor(eng)
            else:
                eng = ServingEngine(params, cfg, ecfg, backend=MiTABackend(
                    params, cfg, ecfg, device="cpu"))
                sup = Supervisor(eng)
            sup.restore(json.loads(json.dumps(snap)))
            while sup.step():
                pass
            done = eng.finished
        sup.close()
        st = sup.stats()
        res.update(
            tokens=_tokens(done), injected=cb.n_injected,
            faults_started=cb.n_faults_started, spikes=cb.n_spikes,
            retries=st["retries"], quarantined=st["quarantined"],
            level=st["degradation_level"], rungs=list(sup.degradations),
            journal=_journal(sup.snapshot()),
            leak=(eng.alloc.in_use, dict(eng.alloc.refs)))
        out.append(res)
    return out


SCHEDULES = {
    "transient": dict(chaos_kw=dict(seed=3, p_fault=0.3, transient_len=2,
                                    alloc_spike_every=5, alloc_spike_pages=2,
                                    ops=("decode_step", "prefill_chunks")),
                      sup_kw=dict(max_retries=3)),
    "slot": dict(chaos_kw=dict(seed=5, p_fault=0.3, transient_len=2,
                               p_slot_fault=0.6, alloc_spike_every=5,
                               alloc_spike_pages=2,
                               ops=("decode_step", "prefill_chunks")),
                 sup_kw=dict(max_retries=1, stall_steps=4)),
    "ladder": dict(chaos_kw=dict(persistent_clears_at=3),
                   scripted=("decode_step", "persistent"),
                   sup_kw=dict(max_retries=1)),
    # long enough generations that the kill lands mid-flight
    "kill_restore": dict(chaos_kw=dict(seed=1, p_fault=0.25,
                                       transient_len=1,
                                       ops=("decode_step",)),
                         specs=((W, 12), (2 * W, 14), (W, 10)),
                         kill_after=6, sup_kw=dict(max_retries=2)),
}


@pytest.mark.parametrize("schedule", sorted(SCHEDULES))
def test_chaos_schedule_matches_jax_package(schedule):
    """One ChaosConfig, one trace, both packages: the same faults fire at
    the same calls, the supervisor takes the same decisions, every stream
    and journal is equal, and both pools drain."""
    want, got = _run_pair(**SCHEDULES[schedule])
    assert got == want
    assert got["leak"] == (0, {})
    assert got["tokens"] == _ref(SCHEDULES[schedule].get("specs",
                                                         tuple(SPECS)))
    if schedule == "transient":
        assert got["retries"] > 0 and got["injected"] > 0
    elif schedule == "slot":
        assert got["quarantined"] > 0
    elif schedule == "ladder":
        assert got["level"] == 3 and got["rungs"] == list(
            DEGRADATION_RUNGS[1:])
    else:
        assert any(r["tokens"] for r in got["kill_journal"]["requests"])


# ------------------------------------------------------- torn dispatches --

@functools.lru_cache(maxsize=None)
def _torn_cell(name):
    """(cfg, params, backend class) of the torn-dispatch cells: the MiTA
    cell above, the conformance battery's mamba2 cell (2 layers) and a
    two-super-block hybrid (so that a fault after the first super-block
    leaves written state behind)."""
    key = jax.random.PRNGKey(0)
    if name == "mita":
        cfg, params = _cell()
        return cfg, params, MiTABackend
    if name == "mamba2":
        jc = JModelConfig(n_layers=2, d_model=32, n_heads=1, n_kv=1, d_ff=0,
                          vocab=89, attn=JAttnConfig(window=W,
                                                     backend="full"))
        return (_port_cfg(jc), params_from_jax(jax.device_get(
            jm2.mamba_init(key, jc))), Mamba2Backend)
    jc = JModelConfig(n_layers=6, d_model=64, n_heads=4, n_kv=2, d_ff=128,
                      vocab=89, attn=JAttnConfig(window=W, k=W,
                                                 backend="mita_ref"))
    return (_port_cfg(jc), params_from_jax(jax.device_get(
        jrg.rg_init(key, jc))), RGLRUBackend)


# the layer function each dispatch calls once per layer (per super-block,
# or per RG-LRU layer in the hybrid's chunk prefill)
LAYER_FNS = {("mita", "decode"): (tfm, "block_decode_paged"),
             ("mita", "chunk"): (tfm, "_chunk_block_body"),
             ("mamba2", "decode"): (m2, "mamba_block_decode"),
             ("mamba2", "chunk"): (m2, "_mamba_block_prefill"),
             ("rglru", "decode"): (rg, "_super_block_step"),
             ("rglru", "chunk"): (rg, "_rglru_block_prefill")}
# dispatches whose first layer writes the slots' state in place: a retry
# re-applies it (decode accumulates; the chunk prefills write what they
# rewrite on a retry -- the MiTA chunk sets its pages and summaries, and
# the recurrent chunk runs on a gathered copy that is scattered back only
# at the end -- so their retries happen to be exact)
TEARS = {("mita", "decode"): True, ("mita", "chunk"): False,
         ("mamba2", "decode"): True, ("mamba2", "chunk"): False,
         ("rglru", "decode"): True, ("rglru", "chunk"): False}
TORN_SPECS = [(2 * W, 6), (2 * W, 5)]


class _RaiseOnce:
    """Stands in for a layer function: once armed, its second call (the
    dispatch's first layer has run) raises, then it passes through."""

    def __init__(self, fn):
        self.fn, self.armed, self.calls, self.fired = fn, False, 0, 0

    def __call__(self, *args, **kwargs):
        if self.armed:
            self.calls += 1
            if self.calls == 2:
                self.armed = False
                self.fired += 1
                raise RuntimeError("layer fault mid-dispatch")
        return self.fn(*args, **kwargs)


def _torn_engine(name):
    cfg, params, mk = _torn_cell(name)
    ecfg = EngineConfig(n_slots=2, pages_per_slot=4, n_pages=12,
                        prefill_chunk=W)
    return ServingEngine(params, cfg, ecfg,
                         backend=mk(params, cfg, ecfg, device="cpu"))


def _arm_when_ready(eng, op):
    """Arm ``fault`` for the next dispatch of ``op``: a decode once every
    slot decodes, a chunk prefill once the second prompt starts (its
    second chunk will run alone)."""
    if op == "decode":
        return eng.active.all()
    return bool(eng.prefilling) and eng.prefill_dispatches >= 1


def _drive(step, eng, fault, op, states_after=None) -> int:
    """Submit the trace and step it to the end, arming ``fault`` once.
    Returns the number of the step in which it fired; ``states_after``
    receives a copy of the backend state right after that step."""
    for r in _requests(TORN_SPECS):
        eng.submit(r)
    n = fired_at = 0
    while True:
        if not fault.fired and not fault.armed and _arm_when_ready(eng, op):
            fault.armed = True
            fault.calls = 0
        fired = fault.fired
        more = step()
        n += 1
        if fault.fired > fired:
            fired_at = n
            if states_after is not None:
                states_after.append(_state_leaves(eng.backend.states))
        if not more:
            return fired_at


def _state_leaves(states):
    from repro_torch.core import slotted
    return [x.clone() for x in slotted.tree_leaves(states)]


@functools.lru_cache(maxsize=None)
def _torn_reference(name):
    return _tokens(_torn_engine(name).run(_requests(TORN_SPECS)))


@pytest.mark.parametrize("op", ["decode", "chunk"])
@pytest.mark.parametrize("name", ["mita", "mamba2", "rglru"])
def test_torn_dispatch_is_quarantined_not_retried(monkeypatch, name, op):
    mod, attr = LAYER_FNS[(name, op)]
    fault = _RaiseOnce(getattr(mod, attr))
    monkeypatch.setattr(mod, attr, fault)

    # supervised: quarantined at once, streams equal the fault-free run
    eng = _torn_engine(name)
    sup = Supervisor(eng, SupervisorConfig(max_retries=3))
    _drive(sup.step, eng, fault, op)
    st = sup.stats()
    assert fault.fired == 1
    assert "TornDispatch" in sup.last_fault
    assert st["quarantined"] > 0 and st["retries"] == 0
    assert _tokens(eng.finished) == _torn_reference(name)
    assert eng.alloc.in_use == 0 and eng.alloc.refs == {}

    # bare engine: the fault propagates, naming its live slots
    fault.fired = 0
    eng = _torn_engine(name)
    with pytest.raises(TornDispatch) as info:
        _drive(eng.step, eng, fault, op)
    assert isinstance(info.value.__cause__, RuntimeError)
    assert info.value.slots and not info.value.batchwide


@pytest.mark.parametrize("op", ["decode", "chunk"])
@pytest.mark.parametrize("name", ["mita", "mamba2", "rglru"])
def test_torn_dispatch_control_retry(monkeypatch, name, op):
    """The control: with the no-retry mark removed, the supervisor
    re-runs the torn dispatch.  Where its first layer had written state in
    place, the state after that step differs from the fault-free run's —
    the check above can see a torn dispatch; where the dispatch rewrites
    what it writes, the retry is exact and the state equal."""
    mod, attr = LAYER_FNS[(name, op)]
    fault = _RaiseOnce(getattr(mod, attr))
    monkeypatch.setattr(mod, attr, fault)
    monkeypatch.setattr(TornDispatch, "retryable", True)
    eng = _torn_engine(name)
    sup = Supervisor(eng, SupervisorConfig(max_retries=3))
    after = []
    fired_at = _drive(sup.step, eng, fault, op, states_after=after)
    assert fault.fired == 1
    assert sup.stats()["retries"] == 1 and sup.stats()["quarantined"] == 0

    # the fault-free run, stopped after the same step
    monkeypatch.setattr(mod, attr, fault.fn)
    ref = _torn_engine(name)
    for r in _requests(TORN_SPECS):
        ref.submit(r)
    for _ in range(fired_at):
        ref.step()
    same = all(torch.equal(a, b) for a, b in zip(
        _state_leaves(ref.backend.states), after[0]))
    tokens_same = _tokens(eng.finished) == _torn_reference(name)
    assert (not same or not tokens_same) == TEARS[(name, op)]


# --------------------------------------------------------------- C.13 -----

C13_CFG = dict(n_layers=4, d_model=128, n_heads=4, n_kv=2, d_ff=256,
               vocab=97)
C13_ENGINE = dict(n_slots=2, pages_per_slot=8, n_pages=10, prefill_chunk=16)


def _c13_run(eng_cls, req_cls, params, cfg, ecfg, device=None):
    """A 16-token victim with 40 new tokens, evicted after 12 steps by two
    priority-5 arrivals: (preemptions, its tokens, its unpreempted
    tokens)."""
    rng = np.random.default_rng(0)
    victim = rng.integers(0, cfg.vocab, 16).astype(np.int32)
    hp = rng.integers(0, cfg.vocab, (2, 16)).astype(np.int32)

    def engine():
        return (eng_cls(params, cfg, ecfg) if device is None
                else eng_cls(params, cfg, ecfg, device=device))

    ref = engine().run([req_cls(rid=0, prompt=victim,
                                max_new_tokens=40)])[0].tokens
    eng = engine()
    eng.submit(req_cls(rid=0, prompt=victim, max_new_tokens=40))
    for _ in range(12):
        eng.step()
    for i in range(2):
        eng.submit(req_cls(rid=1 + i, prompt=hp[i], max_new_tokens=24,
                           priority=5))
    while eng.step():
        pass
    done = sorted(eng.finished, key=lambda f: f.rid)
    return done[0].preemptions, np.asarray(done[0].tokens), np.asarray(ref)


def test_c13_bf16_recompute_parts_in_the_reference():
    """ROADMAP C.13 is a property of chunk-prefill recompute in bfloat16
    that the reference shares: on one schedule and one set of weights, the
    JAX engine's preempted victim re-emits its unpreempted stream in
    float32 and parts from it in bfloat16; the port's float32 run of the
    same schedule (the JAX weights) is exact too."""
    parted = []
    for seed in (1,):
        for dt in (jnp.float32, jnp.bfloat16):
            jc = JModelConfig(**C13_CFG, compute_dtype=dt,
                                 attn=JAttnConfig(window=8, k=8,
                                                     backend="mita_ref"))
            jp = jtfm.lm_init(jax.random.PRNGKey(seed), jc)
            n_pre, toks, ref = _c13_run(JServingEngine, JRequest, jp, jc,
                                        JEngineConfig(**C13_ENGINE))
            assert n_pre >= 1
            if dt == jnp.float32:
                np.testing.assert_array_equal(toks, ref)
                tc = ModelConfig(**C13_CFG, attn=AttnConfig(
                    window=8, k=8, backend="mita_ref"))
                t_pre, t_toks, t_ref = _c13_run(
                    ServingEngine, Request,
                    params_from_jax(jax.device_get(jp)), tc,
                    EngineConfig(**C13_ENGINE), "cpu")
                assert t_pre >= 1
                np.testing.assert_array_equal(t_toks, t_ref)
                np.testing.assert_array_equal(t_toks, toks)
            else:
                parted.append(not np.array_equal(toks, ref))
    assert parted == [True], "the reference's bf16 recompute no longer parts"
