"""Continuous-batching serving engine (port of ``repro.serve.engine``,
monolithic-prefill path).

The scheduler is plain host Python: admission, the priority queue, page
accounting, sampling bookkeeping, deadlines and stats; every device
operation goes through a `DecodeBackend` (`repro_torch.serve.backends`).
Per engine step the backend is asked for at most two dispatches:

  * ``prefill_group`` — monolithic prefill of an admission group (same
    prompt length, power-of-two group size) packed into its slots;
  * ``decode_step``   — ONE fused step for the whole slot batch regardless
    of per-request progress (positions, page tables and activity are data).

Greedy tokens are exact w.r.t. the backend's static reference: a request
decoded here emits the tokens it would emit in a fixed batch.  Chunked
prefill with preemption, the prefix cache and speculative decoding are the
next slice (ROADMAP B.3); `EngineConfig` rejects them.
"""

from __future__ import annotations

import bisect
import dataclasses
import time
from typing import Any, Optional

import numpy as np

from repro_torch.serve import backends as _backends


class AllocatorInvariantError(RuntimeError):
    """Page accounting corruption: double-free, duplicate release, retain
    of a free page, or an allocation not guarded by `can_alloc`."""


@dataclasses.dataclass(eq=False)
class Request:
    """One generation job: ``prompt`` [n] int32 (n >= 1); ``max_new_tokens``
    >= 1 counts every emitted token including the first.  ``priority``:
    higher is admitted first.  Requests compare by identity."""
    rid: int
    prompt: np.ndarray
    max_new_tokens: int
    temperature: float = 0.0
    arrival: float = 0.0            # seconds since trace start
    priority: int = 0
    deadline_ms: Optional[float] = None


@dataclasses.dataclass
class FinishedRequest:
    """``arrival`` is trace-relative; the other stamps are absolute
    `time.perf_counter` values.  ``reason`` is one of `FINISH_REASONS`."""
    rid: int
    tokens: np.ndarray
    arrival: float
    admitted: float
    first_token: float
    finished: float
    token_times: list[float] = dataclasses.field(default_factory=list)
    cancelled: bool = False
    reason: str = "complete"


FINISH_REASONS = ("complete", "cancelled", "deadline_expired", "rejected")


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Slot/page budget and scheduling knobs (the reference's fields).
    ``prefill_chunk``, ``spec_k`` and ``prefix_cache`` must stay off until
    the next slice ports them."""
    n_slots: int = 8
    n_pages: int = 64
    pages_per_slot: int = 8
    finalize: str = "external"      # external | inline
    prefill_chunk: int = 0
    reserve_pages: int = 0
    sample_device: str = "host"     # host | fused
    prefix_cache: bool = False
    spec_k: int = 0

    def __post_init__(self):
        for name, on in (("prefill_chunk > 0", self.prefill_chunk > 0),
                         ("spec_k > 0", self.spec_k > 0),
                         ("prefix_cache=True", self.prefix_cache)):
            if on:
                raise NotImplementedError(
                    f"EngineConfig {name} is not ported yet: chunked "
                    "prefill, preemption, the prefix cache and speculative "
                    "decoding come in the next slice of the port, with the "
                    "chunk-prefill kernel (ROADMAP B.3)")


class _PageAllocator:
    """Ref-counted free-list over the shared pool.

    A page leaves the free list with one reference (`alloc`); other holders
    `retain` it and every holder `release`s it; it returns to the free list
    when the last reference drops.  Releasing a free page, or one page
    twice in one call, raises.  ``reserve`` pages are only served to
    ``reserved=True`` allocations (decode appends)."""

    def __init__(self, n_pages: int, reserve: int = 0):
        self.n_pages = n_pages
        self.reserve = reserve
        self.free: list[int] = list(range(n_pages))
        self.refs: dict[int, int] = {}
        self.high_water = 0
        self.reserve_dips = 0

    @property
    def in_use(self) -> int:
        return self.n_pages - len(self.free)

    def refcount(self, page: int) -> int:
        return self.refs.get(page, 0)

    @property
    def shared_pages(self) -> int:
        return sum(1 for c in self.refs.values() if c > 1)

    def can_alloc(self, n: int, reserved: bool = False) -> bool:
        avail = len(self.free) if reserved else len(self.free) - self.reserve
        return n <= avail

    def alloc(self, n: int, reserved: bool = False) -> list[int]:
        if not self.can_alloc(n, reserved):
            raise AllocatorInvariantError("page pool exhausted")
        if reserved and len(self.free) - n < self.reserve:
            self.reserve_dips += 1
        pages, self.free = self.free[:n], self.free[n:]
        for p in pages:
            self.refs[p] = 1
        self.high_water = max(self.high_water, self.in_use)
        return pages

    def retain(self, pages: list[int]) -> None:
        for p in pages:
            if self.refs.get(p, 0) < 1:
                raise AllocatorInvariantError(
                    f"retain of page {p} which is not allocated")
        for p in pages:
            self.refs[p] += 1

    def release(self, pages: list[int]) -> None:
        """Drop one reference per page; validates the whole batch first so
        a raising call never half-applies."""
        if len(set(pages)) != len(pages):
            raise AllocatorInvariantError(
                f"release with duplicate page ids: {sorted(pages)}")
        for p in pages:
            if self.refs.get(p, 0) < 1:
                raise AllocatorInvariantError(
                    f"double-free: page {p} has no live reference")
        for p in pages:
            self.refs[p] -= 1
            if self.refs[p] == 0:
                del self.refs[p]
                self.free.append(p)


@dataclasses.dataclass(eq=False)
class _WaitEntry:
    """Queue entry ordered by (priority desc, submit order)."""
    req: Request
    seq: int

    @property
    def key(self):
        return (-self.req.priority, self.seq)


class ServingEngine:
    """Admit/retire requests each step; keep the fused decode batch full."""

    def __init__(self, params: Any, cfg: Any,
                 ecfg: EngineConfig = EngineConfig(),
                 backend: Optional[Any] = None, device=None):
        if ecfg.finalize not in ("external", "inline"):
            raise ValueError(f"unknown finalize mode {ecfg.finalize!r}")
        if ecfg.n_pages - ecfg.reserve_pages < ecfg.pages_per_slot:
            raise ValueError("pool minus reserve smaller than one slot's "
                             "max context — admission could deadlock")
        if ecfg.reserve_pages < 0:
            raise ValueError("reserve_pages must be >= 0")
        if ecfg.sample_device not in ("host", "fused"):
            raise ValueError(f"unknown sample_device {ecfg.sample_device!r}")
        self.backend = (backend if backend is not None
                        else _backends.resolve(params, cfg, ecfg, device))
        self.params = params
        self.cfg = cfg
        self.ecfg = ecfg
        self.w = self.backend.window

        s, m = ecfg.n_slots, ecfg.pages_per_slot
        self.alloc = _PageAllocator(ecfg.n_pages, ecfg.reserve_pages)
        self.page_table = np.zeros((s, m), np.int32)
        self.t = np.zeros(s, np.int32)
        self.active = np.zeros(s, bool)
        self.tokens_in = np.zeros(s, np.int32)
        self.slot_rid = np.zeros(s, np.int32)
        self.slot_temp = np.zeros(s, np.float32)
        self.sample_idx = np.zeros(s, np.int32)
        self.free_slots: list[int] = list(range(s))
        self.slot_req: dict[int, Request] = {}
        self.slot_pages: dict[int, list[int]] = {}
        self.slot_out: dict[int, list[int]] = {}
        self.slot_times: dict[int, list[float]] = {}
        self.slot_meta: dict[int, tuple[float, float]] = {}
        self.waiting: list[_WaitEntry] = []
        self.finished: list[FinishedRequest] = []
        self.steps = 0
        self.prefill_dispatches = 0
        self._seq = 0
        self._inflight: set[int] = set()
        self.n_rejected = 0
        self.n_deadline_expired = 0
        self._deadline: dict[int, float] = {}
        self.reject_reasons: dict[int, str] = {}

    # ------------------------------------------------------------ plumbing --

    def _sample(self, logits: np.ndarray, req: Request, index: int) -> int:
        return _backends.sample_host(logits, req.rid, index, req.temperature)

    def pages_needed(self, req: Request) -> int:
        return self.backend.pages_needed(len(req.prompt)
                                         + req.max_new_tokens)

    def stats(self) -> dict[str, Any]:
        """Scheduler counters merged with the backend's; every key of
        `backends.STATS_SCHEMA` (features of later slices read 0)."""
        s = {"backend": self.backend.name, "steps": self.steps,
             "chunks": 0, "prefill_dispatches": self.prefill_dispatches,
             "preemptions": 0, "pages_high_water": self.alloc.high_water,
             "reserve_dips": self.alloc.reserve_dips,
             "prefix_cache_hits": 0, "prefix_cache_misses": 0,
             "pages_shared": 0, "prefix_tokens_reused": 0,
             "prefix_cache_pages": 0, "prefix_cache_evictions": 0,
             "spec_drafted": 0, "spec_accepted": 0, "spec_rollbacks": 0,
             "rejected": self.n_rejected,
             "deadline_expired": self.n_deadline_expired,
             "retries": 0, "quarantined": 0, "degradation_level": 0}
        s.update(self.backend.stats())
        return s

    # ----------------------------------------------------------- scheduler --

    def submit(self, req: Request) -> bool:
        """Queue a request (True) or shed it (False, with a ``rejected``
        FinishedRequest) when no admission path can ever serve it.
        Malformed submissions raise ValueError."""
        if len(req.prompt) < 1 or req.max_new_tokens < 1:
            raise ValueError("need a non-empty prompt and ≥ 1 new token")
        if req.rid in self._inflight:
            raise ValueError(f"request id {req.rid} is already in flight")
        try:
            self._validate_servable(req)
        except ValueError as e:
            self._reject(req, str(e))
            return False
        self._inflight.add(req.rid)
        self._seq += 1
        bisect.insort(self.waiting, _WaitEntry(req=req, seq=self._seq),
                      key=lambda e: e.key)
        if req.deadline_ms is not None:
            self._deadline[req.rid] = (time.perf_counter()
                                       + req.deadline_ms / 1e3)
        return True

    def _validate_servable(self, req: Request) -> None:
        if self.pages_needed(req) > self.ecfg.pages_per_slot:
            raise ValueError(
                f"request {req.rid} needs {self.pages_needed(req)} pages; a "
                f"slot owns {self.ecfg.pages_per_slot} "
                f"(max context {self.ecfg.pages_per_slot * self.w})")
        self.backend.validate_prompt(len(req.prompt), "monolithic")

    def _reject(self, req: Request, why: str) -> None:
        self.n_rejected += 1
        self.reject_reasons[req.rid] = why
        self.finished.append(FinishedRequest(
            rid=req.rid, tokens=np.zeros(0, np.int32), arrival=req.arrival,
            admitted=0.0, first_token=0.0, finished=time.perf_counter(),
            reason="rejected"))

    def _emit(self, slot: int, tok: int, now: float) -> None:
        self.slot_out[slot].append(tok)
        self.slot_times[slot].append(now)

    def _retire(self, slot: int, now: float, cancelled: bool = False,
                reason: Optional[str] = None) -> None:
        if reason is None:
            reason = "cancelled" if cancelled else "complete"
        req = self.slot_req.pop(slot)
        out = self.slot_out.pop(slot)
        times = self.slot_times.pop(slot)
        admitted, ttft = self.slot_meta.pop(slot)
        self.alloc.release(self.slot_pages.pop(slot))
        self.active[slot] = False
        self.t[slot] = 0
        self.page_table[slot] = 0     # unused entries must stay in-bounds
        self.slot_temp[slot] = 0.0
        self.free_slots.append(slot)
        self.backend.invalidate()
        self._inflight.discard(req.rid)
        self.finished.append(FinishedRequest(
            rid=req.rid, tokens=np.asarray(out, np.int32),
            arrival=req.arrival, admitted=admitted, first_token=ttft,
            finished=now, token_times=times, cancelled=cancelled,
            reason=reason))

    def cancel(self, rid: int, reason: str = "cancelled") -> bool:
        """Kill an in-flight request, waiting or decoding, releasing its
        slot and pages at once.  Returns False if ``rid`` is not in
        flight."""
        now = time.perf_counter()
        for entry in self.waiting:
            if entry.req.rid == rid:
                self.waiting.remove(entry)
                self._inflight.discard(rid)
                self.finished.append(FinishedRequest(
                    rid=rid, tokens=np.zeros(0, np.int32),
                    arrival=entry.req.arrival, admitted=0.0,
                    first_token=0.0, finished=now, cancelled=True,
                    reason=reason))
                return True
        for slot, req in self.slot_req.items():
            if req.rid == rid:
                self._retire(slot, now, cancelled=True, reason=reason)
                return True
        return False

    def _expire_deadlines(self) -> None:
        if not self._deadline:
            return
        now = time.perf_counter()
        for rid, expiry in list(self._deadline.items()):
            if rid not in self._inflight:
                del self._deadline[rid]
            elif now >= expiry:
                del self._deadline[rid]
                if self.cancel(rid, reason="deadline_expired"):
                    self.n_deadline_expired += 1

    # ----------------------------------------------------------- admission --

    def _admit_grouped(self, now: float) -> None:
        """Priority-then-FCFS admission with same-length grouping: the
        head-of-line request picks the prompt length; other waiting
        requests of that length ride along in ONE prefill dispatch.  The
        full page budget is claimed up front, so nothing needs preemption."""
        while self.waiting and self.free_slots:
            head = self.waiting[0].req
            if not self.alloc.can_alloc(self.pages_needed(head)):
                return
            n = len(head.prompt)
            budget = (len(self.alloc.free) - self.alloc.reserve
                      - self.pages_needed(head))
            group = [self.waiting[0]]
            for e in self.waiting[1:]:
                if len(group) >= len(self.free_slots):
                    break
                if len(e.req.prompt) == n and \
                        self.pages_needed(e.req) <= budget:
                    group.append(e)
                    budget -= self.pages_needed(e.req)
            group = group[: 1 << (len(group).bit_length() - 1)]
            for e in group:
                self.waiting.remove(e)
            slots = [self.free_slots.pop() for _ in group]
            pages_list = [self.alloc.alloc(self.pages_needed(e.req))
                          for e in group]
            try:
                logits = self.backend.prefill_group(
                    np.stack([e.req.prompt for e in group]).astype(np.int32),
                    slots, pages_list)
            except Exception:
                # fault-atomic admission: unwind the claimed pages/slots and
                # requeue the group before re-raising
                for slot, pages in zip(slots, pages_list):
                    self.alloc.release(pages)
                    self.free_slots.append(slot)
                self.backend.invalidate()
                for e in group:
                    bisect.insort(self.waiting, e, key=lambda x: x.key)
                raise
            for i, (entry, slot, pages) in enumerate(
                    zip(group, slots, pages_list)):
                req = entry.req
                self.slot_req[slot] = req
                self.slot_pages[slot] = pages
                self.slot_out[slot] = []
                self.slot_times[slot] = []
                self.page_table[slot] = 0
                self.page_table[slot, : len(pages)] = pages
                self.t[slot] = n
                self.active[slot] = True
                self.slot_rid[slot] = req.rid
                self.slot_temp[slot] = req.temperature
                self.backend.slot_filled(slot, n)
                first = self._sample(logits[i], req, 0)
                self.sample_idx[slot] = 1
                self.slot_meta[slot] = (now, time.perf_counter())
                self._emit(slot, first, time.perf_counter())
                self.tokens_in[slot] = first
                if req.max_new_tokens == 1:
                    self._retire(slot, time.perf_counter())
            self.backend.invalidate()

    # ---------------------------------------------------------------- step --

    def step(self) -> bool:
        """One iteration: expire deadlines, admit, then one fused decode
        step for the active batch.  False when there is nothing to do."""
        self._expire_deadlines()
        self._admit_grouped(time.perf_counter())
        if not self.active.any():
            return bool(self.waiting)
        fused = self.ecfg.sample_device == "fused"
        out = self.backend.decode_step(
            self.tokens_in, self.t, self.active, self.page_table,
            self.slot_rid, self.slot_temp, self.sample_idx)
        self.steps += 1
        now = time.perf_counter()
        for slot in np.nonzero(self.active)[0]:
            req = self.slot_req[slot]
            tok = (int(out[slot]) if fused
                   else self._sample(out[slot], req, len(self.slot_out[slot])))
            self._emit(slot, tok, now)
            self.t[slot] += 1
            self.sample_idx[slot] += 1
            self.tokens_in[slot] = tok
            if len(self.slot_out[slot]) >= req.max_new_tokens:
                self._retire(slot, now)
        return True

    def run(self, requests: list[Request],
            realtime: bool = False) -> list[FinishedRequest]:
        """Drive a trace; returns the requests finished during this call.
        ``realtime`` honours arrival offsets on the wall clock."""
        pending = sorted(requests, key=lambda r: r.arrival)
        start = time.perf_counter()
        already_done = len(self.finished)
        idx = 0
        while idx < len(pending) or self.waiting or self.active.any():
            now = time.perf_counter() - start
            while idx < len(pending) and (
                    not realtime or pending[idx].arrival <= now):
                self.submit(pending[idx])
                idx += 1
            progressed = self.step()
            if not progressed and idx < len(pending) and realtime:
                time.sleep(max(0.0, pending[idx].arrival
                               - (time.perf_counter() - start)))
        return sorted(self.finished[already_done:], key=lambda f: f.rid)
