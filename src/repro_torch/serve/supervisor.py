"""Supervised serving: fault isolation, degradation and crash recovery
(port of ``repro.serve.supervisor``).

`Supervisor` wraps `ServingEngine.step()` with the failure policy the
bare engine deliberately does not have:

  * **Retry with exponential backoff** — a raising step is re-executed up
    to ``max_retries`` times.  Safe for faults that fire before a dispatch
    starts (fault injection does; the engine's per-step mutations up to a
    dispatch are idempotent across re-execution: admission, page growth
    and chunk bookkeeping all advance only on dispatch success).  The
    port's backends update their state in place, so an exception from
    INSIDE a dispatch (`backends.TornDispatch`, ``retryable`` False) is
    never retried: its live slots are quarantined at once.
  * **Quarantine** — when retries are exhausted (or skipped, for a torn
    dispatch) and the fault implicates a strict subset of slots
    (``batchwide`` False, or any exception carrying a ``slots``
    attribute), ONLY those slots are evicted through the engine's
    recompute-from-prompt preemption path — the victims re-admit and emit
    bit-identical tokens; the rest of the batch never stops.  A fault
    signature that comes back after its own quarantine is not retried:
    it climbs one ladder rung (a rung may clear a fault the code path
    causes) and is quarantined again at once, since only a quarantine
    clears a slot-bound fault.
  * **Degradation ladder** — batch-wide persistent faults walk
    ``nominal → spec_off → prefix_cache_off → xla_forced`` one rung per
    escalation, each rung surfaced as ``stats()["degradation_level"]``.
    Every rung preserves bit-parity: speculation is lossless by
    construction and cache hits are bit-exact vs cold prefill.  The
    ``xla_forced`` rung keeps its name, level and notification and
    changes nothing else (see `Supervisor._degrade`).  A spent ladder is
    NOT fatal by itself (a storm of distinct transient faults can spend
    it and still heal); ``max_consecutive_failures`` failed attempts
    without one good step raises `SupervisionExhausted` — which is also
    where a CUDA error that poisons the context ends (every retry fails);
    recovery from it is `restore` from the journal in a new process.
  * **Straggler detection** — every step is timed through the
    `distributed.fault_tolerance.StepTimer` EWMA detector (one
    ``perf_counter`` pair a step, no device sync); trips are counted, not
    acted on.
  * **Stall relief** — ``stall_steps`` consecutive no-progress steps fire
    the backend's `on_stall` hook (a chaos wrapper releases held
    allocator spikes there), so injected resource pressure can never
    livelock the scheduler.

Crash recovery: `snapshot()` journals every in-flight request (prompt +
tokens committed so far) plus the finished list; `restore()` rebuilds
them on a FRESH, identically-configured engine as resume entries — the
same recompute-from-prompt machinery preemption uses, so a killed and
restarted engine continues every stream bit-identically in float32; in
bfloat16 a recomputed stream may part, as a quarantined one may, as in
the reference (ROADMAP C.13).  The journal
holds host integers only.  Snapshots write atomically (tmp + rename).

`AllocatorInvariantError` is never retried: page-accounting corruption
is a scheduler bug, and replaying it would turn an error into state
corruption.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Any, Optional

import numpy as np

from repro_torch.distributed.fault_tolerance import StepTimer
from repro_torch.serve.engine import (AllocatorInvariantError,
                                      FinishedRequest, Request,
                                      ServingEngine, _WaitEntry)

#: the degradation ladder, rung per index (stats()["degradation_level"])
DEGRADATION_RUNGS = ("nominal", "spec_off", "prefix_cache_off",
                     "xla_forced")


class SupervisionExhausted(RuntimeError):
    """Too many consecutive failed step attempts with retries,
    quarantine, and every ladder rung already spent — the supervisor
    gives up loudly rather than spin."""


@dataclasses.dataclass(frozen=True)
class SupervisorConfig:
    """Failure policy knobs.  ``backoff_base_s`` = 0 (default) keeps
    tests and CPU benches fast; production would set a real base.
    ``max_degradation`` caps how far down `DEGRADATION_RUNGS` the ladder
    may walk.  ``max_consecutive_failures`` is the hard give-up bound:
    a storm of DISTINCT transient faults can legitimately spend the
    quarantine/ladder budget (each one heals, the next fires), so a
    spent ladder alone is not fatal — only this many failed attempts
    without a single good step in between is."""
    max_retries: int = 3
    backoff_base_s: float = 0.0
    backoff_cap_s: float = 0.05
    max_degradation: int = len(DEGRADATION_RUNGS) - 1
    max_consecutive_failures: int = 20
    straggler_alpha: float = 0.3
    straggler_threshold: float = 4.0
    stall_steps: int = 8


class Supervisor:
    """Drives a `ServingEngine` under the failure policy above.  The
    engine keeps owning requests/slots/pages; the supervisor owns fault
    handling and increments the engine's robustness counters
    (``retries``/``quarantined``/``degradation_level``) so `stats()`
    stays the one observability surface."""

    def __init__(self, engine: ServingEngine,
                 cfg: SupervisorConfig = SupervisorConfig()):
        self.engine = engine
        self.cfg = cfg
        self.timer = StepTimer(alpha=cfg.straggler_alpha,
                               threshold=cfg.straggler_threshold)
        self.n_faults = 0               # exceptions caught (incl. retried)
        self.degradations: list[str] = []   # rung names, in order taken
        self.last_fault: Optional[str] = None
        self._consecutive = 0           # failures in the current cycle
        self._streak = 0                # failures since last good step
        self._stalled = 0               # no-progress steps in a row
        self._last_quarantine: Optional[tuple] = None  # fault signature
        # give a chaos wrapper real pool pressure to play with
        self._notify("bind_allocator", engine.alloc)

    # ----------------------------------------------------------- plumbing --

    def _notify(self, hook: str, *args: Any) -> None:
        fn = getattr(self.engine.backend, hook, None)
        if fn is not None:
            fn(*args)

    def submit(self, req: Request) -> bool:
        return self.engine.submit(req)

    def cancel(self, rid: int, reason: str = "cancelled") -> bool:
        return self.engine.cancel(rid, reason=reason)

    def stats(self) -> dict:
        s = self.engine.stats()
        s["stragglers"] = self.timer.n_stragglers
        return s

    def close(self) -> None:
        """End of supervision.  The reference restores the environment
        variable its ``xla_forced`` rung sets; no rung of the port touches
        the environment, so there is nothing to restore."""

    # ----------------------------------------------------------- stepping --

    def step(self) -> bool:
        """One SUPERVISED engine iteration: retries, quarantines, and
        degrades until the underlying `engine.step()` completes, then
        returns its result.  Raises `AllocatorInvariantError` immediately
        and `SupervisionExhausted` when the whole policy is spent."""
        eng = self.engine
        while True:
            marker = (eng.steps, eng.prefill_dispatches, len(eng.finished),
                      len(eng.waiting), len(eng.prefilling))
            t0 = time.perf_counter()
            try:
                ok = eng.step()
            except AllocatorInvariantError:
                raise
            except Exception as e:      # noqa: BLE001 — supervised domain
                self._handle_fault(e)
                continue
            self.timer.observe(time.perf_counter() - t0)
            self._consecutive = 0
            self._streak = 0
            self._last_quarantine = None
            progressed = marker != (eng.steps, eng.prefill_dispatches,
                                    len(eng.finished), len(eng.waiting),
                                    len(eng.prefilling))
            if ok and not progressed:
                self._stalled += 1
                if self._stalled >= self.cfg.stall_steps:
                    self._notify("on_stall")
                    self._stalled = 0
            else:
                self._stalled = 0
            if not ok:
                # drained: release anything a fault injector still holds
                self._notify("on_stall")
            return ok

    def _handle_fault(self, e: Exception) -> None:
        eng = self.engine
        self.n_faults += 1
        self.last_fault = repr(e)
        self._consecutive += 1
        self._streak += 1
        if self._streak >= self.cfg.max_consecutive_failures:
            raise SupervisionExhausted(
                f"{self._streak} consecutive failed step attempts with "
                f"quarantine and the degradation ladder "
                f"{self.degradations} already spent: {e!r}") from e
        slots = sorted({int(s) for s in getattr(e, "slots", []) or []})
        occupied = [s for s in slots
                    if s in eng.slot_req or s in eng.prefilling]
        # a torn dispatch over live slots may have half-updated their
        # state: re-running it could change their tokens, so it is never
        # retried (with no live slot left, the engine has unwound it)
        torn = not getattr(e, "retryable", True) and bool(occupied)
        batchwide = bool(getattr(e, "batchwide", True))
        sig = (type(e).__name__, getattr(e, "op", None), tuple(slots))
        isolate = torn or (bool(occupied) and not batchwide)
        # a slot-bound signature that came back after its own quarantine
        # is not retried: retries did not clear it the last time
        repeat = isolate and sig == self._last_quarantine
        if not torn and not repeat \
                and self._consecutive <= self.cfg.max_retries:
            eng.n_retries += 1
            delay = min(
                self.cfg.backoff_base_s * (2 ** (self._consecutive - 1)),
                self.cfg.backoff_cap_s)
            if delay > 0:
                time.sleep(delay)
            return
        self._consecutive = 0
        if isolate:
            # a repeated signature also climbs a rung, and is quarantined
            # all the same: only a quarantine clears a slot-bound fault
            # (ROADMAP C.9: the reference retries a NEW slot fault that
            # shares the last one's signature and sends it to the ladder
            # alone, which clears nothing, until the ladder is spent or
            # SupervisionExhausted)
            if repeat:
                self._degrade()
            # fault domain is a strict slot subset: evict ONLY those
            # slots through the preemption path (decoding victims carry
            # their emitted tokens and resurrect bit-identically; mid-
            # prefill victims restart having emitted nothing)
            for s in occupied:
                eng._preempt(s)
            eng.n_quarantined += len(occupied)
            self._last_quarantine = sig
            self._notify("on_quarantine", occupied)
            return
        if not self._degrade():
            # ladder spent: keep retrying — a storm of distinct transient
            # faults heals on its own, and `max_consecutive_failures`
            # bounds a genuinely stuck fault (checked above)
            return

    def _ladder_spent(self) -> bool:
        cap = min(self.cfg.max_degradation, len(DEGRADATION_RUNGS) - 1)
        return self.engine.degradation_level >= cap

    def _degrade(self) -> bool:
        """Climb one ladder rung; False when already at the cap.  Every
        rung narrows capability, never correctness — each mode is pinned
        bit-identical to the mode above it by the tests.

        ``xla_forced`` (level 3): in the reference it moves the chunk
        prefill to its XLA path, the kernels' bit-exact oracle.  The port
        has no such path: its plain PyTorch versions match the CUDA
        kernels within a tolerance only, so swapping them in would be a
        fallback that hides the kernel and breaks parity with the
        fault-free stream.  The rung keeps its name, level, stats and
        `on_degrade` notification (which clears a chaos wrapper's
        persistent faults at that level) and changes nothing else: no
        path and no environment variable."""
        eng = self.engine
        if self._ladder_spent():
            return False
        level = eng.degradation_level + 1
        eng.degradation_level = level
        rung = DEGRADATION_RUNGS[level]
        if rung == "spec_off":
            eng.ecfg = dataclasses.replace(eng.ecfg, spec_k=0)
        elif rung == "prefix_cache_off":
            if eng.cache is not None:
                while eng.cache.evict_one():
                    pass
                eng.cache = None
        self.degradations.append(rung)
        self._notify("on_degrade", level)
        return True

    def run(self, requests: list[Request],
            realtime: bool = False) -> list[FinishedRequest]:
        """Supervised version of `ServingEngine.run`: same drive loop,
        every step supervised, injector holdings drained at the end."""
        eng = self.engine
        pending = sorted(requests, key=lambda r: r.arrival)
        start = time.perf_counter()
        already_done = len(eng.finished)
        idx = 0
        while (idx < len(pending) or eng.waiting or eng.prefilling
               or eng.active.any()):
            now = time.perf_counter() - start
            while idx < len(pending) and (
                    not realtime or pending[idx].arrival <= now):
                self.submit(pending[idx])
                idx += 1
            progressed = self.step()
            if not progressed and idx < len(pending):
                if realtime:
                    time.sleep(max(0.0,
                                   pending[idx].arrival
                                   - (time.perf_counter() - start)))
        self._notify("on_stall")
        return sorted(eng.finished[already_done:], key=lambda f: f.rid)

    # ------------------------------------------------------ crash recovery --

    def snapshot(self) -> dict:
        """Journal of everything needed to resume this engine's streams
        bit-identically on a fresh process: per in-flight request its
        prompt, scheduling fields, and the tokens committed so far (in
        admission order — decoding slots, then prefilling, then waiting),
        plus the finished list and the shed/robustness counters.  Device
        state is deliberately absent: recompute-from-prompt rebuilds it
        bit-exactly, which is the whole premise of the engine's
        preemption machinery."""
        eng = self.engine

        def req_row(req: Request, tokens: list) -> dict:
            return {"rid": int(req.rid),
                    "prompt": np.asarray(req.prompt).tolist(),
                    "max_new_tokens": int(req.max_new_tokens),
                    "temperature": float(req.temperature),
                    "arrival": float(req.arrival),
                    "priority": int(req.priority),
                    "deadline_ms": (None if req.deadline_ms is None
                                    else float(req.deadline_ms)),
                    "tokens": [int(x) for x in tokens]}

        rows = []
        for slot in sorted(eng.slot_req, key=lambda s: eng.slot_seq[s]):
            rows.append(req_row(eng.slot_req[slot], eng.slot_out[slot]))
        for slot in sorted(eng.prefilling, key=lambda s: eng.slot_seq[s]):
            entry = eng.prefilling[slot].entry
            rows.append(req_row(entry.req,
                                entry.resume[0] if entry.resume else []))
        for entry in eng.waiting:
            rows.append(req_row(entry.req,
                                entry.resume[0] if entry.resume else []))
        fins = [{"rid": int(f.rid), "tokens": f.tokens.tolist(),
                 "arrival": float(f.arrival), "cancelled": bool(f.cancelled),
                 "reason": f.reason, "preemptions": int(f.preemptions)}
                for f in eng.finished]
        return {"version": 1, "backend": eng.backend.name,
                "requests": rows, "finished": fins,
                "counters": {"rejected": eng.n_rejected,
                             "deadline_expired": eng.n_deadline_expired,
                             "retries": eng.n_retries,
                             "quarantined": eng.n_quarantined,
                             "degradation_level": eng.degradation_level}}

    def save_snapshot(self, path: str) -> None:
        """Atomic journal write — tmp then rename, so a crash mid-save
        leaves the previous snapshot intact (`checkpoint/manager.py`)."""
        tmp = f"{path}.tmp"
        with open(tmp, "w") as f:
            json.dump(self.snapshot(), f)
        os.replace(tmp, path)

    @staticmethod
    def load_snapshot(path: str) -> dict:
        with open(path) as f:
            return json.load(f)

    def restore(self, snap: dict) -> None:
        """Rebuild a snapshot's streams on THIS supervisor's engine —
        which must be fresh (nothing in flight) and configured
        identically to the snapshotted one (same params / model config /
        EngineConfig / sample key): resumed tokens re-enter through the
        recompute-from-prompt path, whose bit-exactness is only defined
        against the same compiled programs and sampling keys.  Requests
        with committed tokens need chunked mode (``prefill_chunk`` > 0),
        exactly like preemption resume.  Deadlines restart their clock
        at restore time."""
        eng = self.engine
        if eng.waiting or eng.prefilling or eng.slot_req or eng.finished:
            raise ValueError("restore() needs a fresh engine: this one "
                             "already has requests in flight or finished")
        if snap.get("backend") != eng.backend.name:
            raise ValueError(
                f"snapshot was taken on the {snap.get('backend')!r} "
                f"backend; this engine runs {eng.backend.name!r}")
        now = time.perf_counter()
        for row in snap["requests"]:
            tokens = row["tokens"]
            if tokens and not eng.ecfg.prefill_chunk:
                raise ValueError(
                    "snapshot holds mid-decode requests; restoring them "
                    "needs chunked prefill (prefill_chunk > 0) — the "
                    "recompute-from-prompt resume path")
            req = Request(rid=row["rid"],
                          prompt=np.asarray(row["prompt"], np.int32),
                          max_new_tokens=row["max_new_tokens"],
                          temperature=row["temperature"],
                          arrival=row["arrival"],
                          priority=row["priority"],
                          deadline_ms=row["deadline_ms"])
            eng._inflight.add(req.rid)
            eng._seq += 1
            entry = _WaitEntry(req=req, seq=eng._seq)
            if tokens:
                entry.resume = (list(tokens), [0.0] * len(tokens),
                                (0.0, 0.0))
            eng._enqueue(entry)
            if req.deadline_ms is not None:
                eng._deadline[req.rid] = now + req.deadline_ms / 1e3
        for f in snap["finished"]:
            eng.finished.append(FinishedRequest(
                rid=f["rid"], tokens=np.asarray(f["tokens"], np.int32),
                arrival=f["arrival"], admitted=0.0, first_token=0.0,
                finished=0.0, preemptions=f["preemptions"],
                cancelled=f["cancelled"], reason=f["reason"]))
        c = snap.get("counters", {})
        eng.n_rejected = c.get("rejected", 0)
        eng.n_deadline_expired = c.get("deadline_expired", 0)
        eng.n_retries = c.get("retries", 0)
        eng.n_quarantined = c.get("quarantined", 0)
        eng.degradation_level = c.get("degradation_level", 0)


__all__ = ["DEGRADATION_RUNGS", "Supervisor", "SupervisorConfig",
           "SupervisionExhausted"]
