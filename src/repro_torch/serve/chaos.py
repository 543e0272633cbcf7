"""Deterministic fault injection for the serving stack (port of
``repro.serve.chaos``).

`ChaosBackend` wraps ANY `DecodeBackend` and fires a seeded, scripted
fault schedule at the protocol boundary so that every failure path the
supervisor claims to handle (`serve.supervisor`) runs in the tests.

Fault taxonomy:

  * **transient** — an intercepted dispatch raises `InjectedFault` for
    ``transient_len`` consecutive calls of that op, then heals; the
    supervisor's retry loop absorbs it.
  * **slot-bound** — one active slot is implicated; the fault persists
    until the supervisor quarantines that slot (`on_quarantine`), which
    models a poisoned request / corrupt slot state.  The victim is
    resurrected through recompute-from-prompt, bit-identically.
  * **persistent** — the op keeps raising until the supervisor climbs the
    degradation ladder to ``persistent_clears_at`` (`on_degrade`), which
    models a feature-specific failure a fallback path avoids.
  * **allocator spike** — every ``alloc_spike_every``-th intercepted call
    grabs up to ``alloc_spike_pages`` pages from the engine's pool
    (`bind_allocator`) and holds them for ``alloc_spike_len`` calls,
    creating real page pressure (preemptions, reserve dips) without any
    fake accounting; `on_stall` / `release_spikes` return them, so a
    drained trace always ends at zero pages in use.
  * **straggler** — a dispatch sleeps ``slow_s`` with probability
    ``p_slow`` before running; the supervisor's `StepTimer` EWMA must
    flag it.

Faults fire BEFORE delegating to the wrapped backend, so a faulted
dispatch never starts on the device: retrying the engine step re-issues
the identical dispatch against unchanged backend state, which is what
makes supervised streams bit-identical to fault-free ones (an exception
from inside a dispatch is another matter: see `backends.TornDispatch`).
The schedule is a pure function of `ChaosConfig` (a seeded ``numpy``
Generator) and the call sequence — same config, same trace, same faults,
draw for draw the reference's.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Optional

import numpy as np

#: ops the injector may intercept (a ChaosConfig.ops subset selects)
CHAOS_OPS = ("prefill_group", "prefill_chunk", "prefill_chunks",
             "decode_step", "draft_steps", "verify_step")


class InjectedFault(RuntimeError):
    """A scripted backend failure.  ``slots`` are the implicated slots
    (what the supervisor may quarantine); ``batchwide``=False marks a
    slot-bound fault where quarantining ``slots`` clears it."""

    def __init__(self, op: str, slots: list, kind: str,
                 batchwide: bool = True):
        super().__init__(f"injected {kind} fault in {op} (slots={slots})")
        self.op = op
        self.slots = list(slots)
        self.kind = kind
        self.batchwide = batchwide


@dataclasses.dataclass(frozen=True)
class ChaosConfig:
    """Seeded fault schedule.  All probabilities are per intercepted
    dispatch; ``p_slot_fault`` + ``p_persistent`` <= 1 split new faults
    into kinds (the remainder is transient).  Only one raising fault is
    live at a time — its lifecycle must resolve (heal / quarantine /
    degrade) before the next can start, which keeps schedules readable
    and every fault's resolution observable."""
    seed: int = 0
    p_fault: float = 0.0            # new-fault probability per dispatch
    ops: tuple = ("decode_step", "prefill_chunks", "prefill_chunk",
                  "prefill_group", "verify_step")
    transient_len: int = 1          # raises per transient fault
    p_persistent: float = 0.0       # fraction of faults that persist
    persistent_clears_at: int = 1   # ladder rung that heals them
    p_slot_fault: float = 0.0       # fraction bound to one slot
    p_slow: float = 0.0             # straggler probability per dispatch
    slow_s: float = 0.0             # injected dispatch delay (seconds)
    alloc_spike_every: int = 0      # 0 = no allocator spikes
    alloc_spike_pages: int = 0      # pages grabbed per spike
    alloc_spike_len: int = 2        # dispatches a spike is held


class ChaosBackend:
    """Delegation wrapper: protocol calls pass through untouched except
    the intercepted ops, which consult the fault schedule first.  The
    supervision hooks (`on_quarantine`/`on_degrade`/`on_stall`) both
    clear matching faults and forward to the wrapped backend."""

    def __init__(self, inner: Any, chaos: ChaosConfig):
        self.inner = inner
        self.chaos = chaos
        self._rng = np.random.default_rng(chaos.seed)
        self._fault: Optional[dict] = None
        self._alloc = None              # engine page allocator, if bound
        self._spike_pages: list[int] = []
        self._spike_ttl = 0
        self._calls = 0
        self.n_injected = 0             # raises fired
        self.n_faults_started = 0       # distinct fault lifecycles
        self.n_spikes = 0
        self.n_slowed = 0

    # --------------------------------------------------------- delegation --

    def __getattr__(self, name: str) -> Any:
        return getattr(self.inner, name)

    def fresh(self) -> Any:
        # warmup scratch engines must compile, not crash: the fresh
        # instance is the bare inner backend, chaos-free
        return self.inner.fresh()

    # ---------------------------------------------------------- lifecycle --

    def bind_allocator(self, alloc: Any) -> None:
        """Give the injector the engine's page allocator so spikes apply
        REAL pool pressure (call after engine construction)."""
        self._alloc = alloc

    def inject(self, op: str, kind: str = "transient",
               slots: tuple = (), raises: Optional[int] = None) -> None:
        """Script ONE fault deterministically, bypassing the RNG draw —
        how tests and the chaos bench stage exact scenarios (e.g. a
        single persistent fault that walks the whole degradation ladder).
        ``raises`` bounds a transient fault's raise count (defaults to
        ``transient_len``); slot/persistent faults resolve through the
        supervision hooks as usual."""
        if op not in CHAOS_OPS:
            raise ValueError(f"unknown op {op!r}; one of {CHAOS_OPS}")
        if kind not in ("transient", "slot", "persistent"):
            raise ValueError(f"unknown fault kind {kind!r}")
        f: dict = {"op": op, "kind": kind, "slots": [int(s) for s in slots]}
        if kind == "transient":
            f["remaining"] = (self.chaos.transient_len if raises is None
                              else int(raises))
        self.n_faults_started += 1
        self._fault = f

    def release_spikes(self) -> None:
        if self._spike_pages and self._alloc is not None:
            self._alloc.release(self._spike_pages)
        self._spike_pages = []
        self._spike_ttl = 0

    def on_quarantine(self, slots: list) -> None:
        f = self._fault
        if (f is not None and f["kind"] == "slot"
                and set(f["slots"]) <= set(int(s) for s in slots)):
            self._fault = None
        self.inner.on_quarantine(slots)

    def on_degrade(self, level: int) -> None:
        f = self._fault
        if (f is not None and f["kind"] == "persistent"
                and level >= self.chaos.persistent_clears_at):
            self._fault = None
        self.inner.on_degrade(level)

    def on_stall(self) -> None:
        self.release_spikes()
        self.inner.on_stall()

    # ----------------------------------------------------------- schedule --

    def _gate(self, op: str, slots: list[int]) -> None:
        """Consult the schedule before dispatching ``op`` over ``slots``;
        raises `InjectedFault` instead of dispatching when a fault is due.
        Runs straggler and allocator-spike side effects either way."""
        cfg = self.chaos
        self._calls += 1
        if cfg.p_slow > 0.0 and self._rng.random() < cfg.p_slow:
            self.n_slowed += 1
            if cfg.slow_s > 0.0:
                time.sleep(cfg.slow_s)
        if self._spike_pages:
            self._spike_ttl -= 1
            if self._spike_ttl <= 0:
                self.release_spikes()
        elif (cfg.alloc_spike_every and self._alloc is not None
              and self._calls % cfg.alloc_spike_every == 0):
            n = cfg.alloc_spike_pages
            while n > 0 and not self._alloc.can_alloc(n):
                n -= 1
            if n > 0:
                self._spike_pages = self._alloc.alloc(n)
                self._spike_ttl = cfg.alloc_spike_len
                self.n_spikes += 1

        f = self._fault
        if f is not None and f["op"] == op:
            if f["kind"] == "transient":
                if f["remaining"] > 0:
                    f["remaining"] -= 1
                    self.n_injected += 1
                    raise InjectedFault(op, f["slots"], "transient")
                self._fault = None          # healed: dispatch proceeds
            elif f["kind"] == "slot":
                # only raises while its slot is in the dispatch — after a
                # quarantine+readmission races, the hook has cleared it
                if set(f["slots"]) & set(slots):
                    self.n_injected += 1
                    raise InjectedFault(op, f["slots"], "slot",
                                        batchwide=False)
            else:                           # persistent
                self.n_injected += 1
                raise InjectedFault(op, f["slots"], "persistent")
        if (self._fault is None and cfg.p_fault > 0.0 and op in cfg.ops
                and self._rng.random() < cfg.p_fault):
            kind_draw = self._rng.random()
            self.n_faults_started += 1
            if slots and kind_draw < cfg.p_slot_fault:
                target = [slots[int(self._rng.integers(len(slots)))]]
                self._fault = {"op": op, "kind": "slot", "slots": target}
                self.n_injected += 1
                raise InjectedFault(op, target, "slot", batchwide=False)
            if kind_draw < cfg.p_slot_fault + cfg.p_persistent:
                self._fault = {"op": op, "kind": "persistent",
                               "slots": slots}
                self.n_injected += 1
                raise InjectedFault(op, slots, "persistent")
            self._fault = {"op": op, "kind": "transient", "slots": slots,
                           "remaining": cfg.transient_len - 1}
            self.n_injected += 1
            raise InjectedFault(op, slots, "transient")

    # --------------------------------------------------- intercepted ops --

    def prefill_group(self, prompts, slots, pages_list):
        self._gate("prefill_group", [int(s) for s in slots])
        return self.inner.prefill_group(prompts, slots, pages_list)

    def prefill_chunk(self, slot, pt_row, toks, t0, n_valid, n_train):
        self._gate("prefill_chunk", [int(slot)])
        return self.inner.prefill_chunk(slot, pt_row, toks, t0, n_valid,
                                        n_train)

    def prefill_chunks(self, slot_ids, toks, job_active, page_table, t0,
                       n_valid, n_train):
        live = [int(s) for s, a in zip(slot_ids, job_active) if a]
        self._gate("prefill_chunks", live)
        return self.inner.prefill_chunks(slot_ids, toks, job_active,
                                         page_table, t0, n_valid, n_train)

    def decode_step(self, tokens_in, t, active, page_table, rid,
                    temperature, sample_idx, key):
        self._gate("decode_step",
                   [int(s) for s in np.nonzero(np.asarray(active))[0]])
        return self.inner.decode_step(tokens_in, t, active, page_table,
                                      rid, temperature, sample_idx, key)

    def draft_steps(self, tokens_in, t, active, page_table, rid,
                    temperature, sample_idx, key, spec_len):
        self._gate("draft_steps",
                   [int(s) for s in np.nonzero(np.asarray(active))[0]])
        return self.inner.draft_steps(tokens_in, t, active, page_table,
                                      rid, temperature, sample_idx, key,
                                      spec_len)

    def verify_step(self, tokens_in, t, active, page_table, rid,
                    temperature, sample_idx, key, spec_len, drafts):
        self._gate("verify_step",
                   [int(s) for s in np.nonzero(np.asarray(active))[0]])
        return self.inner.verify_step(tokens_in, t, active, page_table,
                                      rid, temperature, sample_idx, key,
                                      spec_len, drafts)

    def stats(self) -> dict:
        # schema-transparent: chaos counters live on the wrapper (the
        # bench/tests read them directly), not in STATS_SCHEMA
        return self.inner.stats()


__all__ = ["CHAOS_OPS", "ChaosBackend", "ChaosConfig", "InjectedFault"]
