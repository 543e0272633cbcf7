"""Continuous-batching serving engine (port of ``repro.serve.engine``).

The scheduler is plain host Python: admission, the priority queue,
preemption, chunked-prefill pacing, page accounting, the prefix cache,
sampling bookkeeping, deadlines and stats; every device operation goes
through a `DecodeBackend` (`repro_torch.serve.backends`).  Per engine step
the backend is asked for at most two dispatches:

  * ``prefill_group``  — monolithic prefill of an admission group (same
    prompt length, power-of-two group size) packed into its slots
    (``prefill_chunk`` = 0);
  * ``prefill_chunks`` — ONE call advancing every prefilling slot by one
    chunk (``prefill_chunk`` > 0, batched mode): long prompts admit
    incrementally, interleaved with the decode batch; in per-job mode
    (the reference's legacy baseline) ``prefill_chunk`` advances only the
    best-keyed job, and a prompt the backend's chunk program cannot start
    goes through ``prefill_group`` instead;
  * ``decode_step``    — ONE fused step for the whole slot batch regardless
    of per-request progress (positions, page tables and activity are data).

Chunked mode also enables priority preemption: under page pressure the
lowest-priority victim is evicted (its pages released) and later rebuilt
by chunk-prefilling prompt + generated-so-far (recompute-from-prompt), and
the optional radix prefix cache (`serve.prefix_cache`).

With ``spec_k`` > 0 the decode step becomes one speculative round: the
backend drafts up to ``spec_k`` tokens per slot (``draft_steps``),
re-derives them plus one correction with its exact decode rule
(``verify_step``), and the engine commits the longest draft prefix the
verification reproduced plus the first corrected token, rewinding the
backend past the commit point (``rollback``).

Fault handling is not the engine's: `serve.supervisor.Supervisor` wraps
`step` with retries, per-slot quarantine (through `_preempt`), the
degradation ladder and a snapshot / restore journal, and counts them in
``n_retries`` / ``n_quarantined`` / ``degradation_level``, which `stats`
reports.

Greedy tokens are exact w.r.t. the backend's static reference: a request
decoded here emits the tokens it would emit in a fixed batch, preempted or
not.  Tempered tokens are keyed by (request id, token index), so they do
not depend on batching either; speculative streams are bit-identical to
``spec_k = 0`` at any temperature.
"""

from __future__ import annotations

import bisect
import dataclasses
import time
from typing import Any, Optional

import numpy as np

from repro_torch import prng
from repro_torch.serve import backends as _backends


class AllocatorInvariantError(RuntimeError):
    """Page accounting corruption: double-free, duplicate release, retain
    of a free page, or an allocation not guarded by `can_alloc`.  A
    scheduler bug, not a workload condition: the supervisor re-raises it
    instead of retrying."""


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
    preemptions: int = 0
    cancelled: bool = False
    reason: str = "complete"


FINISH_REASONS = ("complete", "cancelled", "deadline_expired", "rejected")


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Slot/page budget and scheduling knobs (the reference's fields).

    ``prefill_chunk`` = 0 keeps monolithic prefill (full page budget up
    front, no preemption); > 0 (a multiple of the backend's window)
    enables chunked prefill AND priority preemption, one dispatch a step:
    ``prefill_mode="batched"`` advances every prefilling slot in it,
    ``"per-job"`` only the best-keyed job.
    ``reserve_pages`` may only be claimed by decode appends.
    ``prefix_cache`` (chunked mode only) keeps a radix cache of committed
    window-aligned prompt prefixes.  ``spec_k`` > 0 turns on lossless
    speculative decoding (requires ``sample_device="fused"`` and a backend
    with ``supports_speculation``); ``spec_mode`` picks the backend's
    drafting strategy ("auto": its native one)."""
    n_slots: int = 8
    n_pages: int = 64
    pages_per_slot: int = 8
    finalize: str = "external"      # external | inline
    prefill_chunk: int = 0
    reserve_pages: int = 0
    sample_device: str = "host"     # host | fused
    prefill_mode: str = "batched"   # batched | per-job (chunk dispatch)
    prefix_cache: bool = False
    spec_k: int = 0                 # speculative tokens per round (0 = off)
    spec_mode: str = "auto"         # backend drafting strategy


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
    """Queue entry ordered by (priority desc, submit order).  ``resume``
    holds (tokens, times, meta) of a preempted request awaiting its
    recompute; ``snapshot`` is the backend's `preempt_snapshot` payload;
    ``evictions`` counts its preemptions; ``first_admit`` stamps its FIRST
    admission, which a re-admitted victim keeps."""
    req: Request
    seq: int
    resume: Optional[tuple] = None
    snapshot: Any = None
    evictions: int = 0
    first_admit: Optional[float] = None

    @property
    def key(self):
        return (-self.req.priority, self.seq)


@dataclasses.dataclass(eq=False)
class _PrefillJob:
    """A request mid chunked prefill: owns a slot and a growing page set,
    but is not in the decode batch until its last chunk lands."""
    entry: _WaitEntry
    toks: np.ndarray                # prompt [+ generated-so-far] to pack
    n_train: int                    # original prompt length (semantics)
    admit_time: float
    done: int = 0                   # tokens packed so far (next chunk's t0)


class ServingEngine:
    """Admit/evict requests each step; keep the fused decode batch full."""

    def __init__(self, params: Any, cfg: Any,
                 ecfg: EngineConfig = EngineConfig(),
                 sample_key=None, backend: Optional[Any] = None,
                 device=None):
        if ecfg.finalize not in ("external", "inline"):
            raise ValueError(f"unknown finalize mode {ecfg.finalize!r}")
        if ecfg.n_pages - ecfg.reserve_pages < ecfg.pages_per_slot:
            raise ValueError("pool minus reserve smaller than one slot's "
                             "max context — admission could deadlock")
        if ecfg.reserve_pages < 0:
            raise ValueError("reserve_pages must be >= 0")
        if ecfg.sample_device not in ("host", "fused"):
            raise ValueError(f"unknown sample_device {ecfg.sample_device!r}")
        if ecfg.prefill_mode not in ("batched", "per-job"):
            raise ValueError(f"unknown prefill_mode {ecfg.prefill_mode!r}")
        if ecfg.prefix_cache and not ecfg.prefill_chunk:
            raise ValueError("prefix_cache requires chunked prefill "
                             "(prefill_chunk > 0): cache hits resume the "
                             "chunk program at the first unshared chunk")
        if ecfg.spec_k < 0:
            raise ValueError("spec_k must be >= 0")
        self.backend = (backend if backend is not None
                        else _backends.resolve(params, cfg, ecfg, device))
        if ecfg.spec_k:
            if ecfg.sample_device != "fused":
                raise ValueError(
                    "speculative decoding samples inside the verify step "
                    "(spec_k > 0 requires sample_device='fused')")
            if not getattr(self.backend, "supports_speculation", False):
                raise ValueError(
                    f"the {self.backend.name!r} backend does not support "
                    "speculative decoding (spec_k > 0)")
        self.params = params
        self.cfg = cfg
        self.ecfg = ecfg
        self.w = self.backend.window
        if ecfg.prefill_chunk and (ecfg.prefill_chunk < 0
                                   or ecfg.prefill_chunk % self.w):
            raise ValueError("prefill_chunk must be a positive multiple of "
                             f"the backend window ({self.w})")
        self._key = prng.PRNGKey(0) if sample_key is None else sample_key

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
        self.slot_entry: dict[int, _WaitEntry] = {}
        self.slot_pages: dict[int, list[int]] = {}
        self.slot_out: dict[int, list[int]] = {}
        self.slot_times: dict[int, list[float]] = {}
        self.slot_meta: dict[int, tuple[float, float]] = {}
        self.slot_seq: dict[int, int] = {}    # admission recency (victims)
        self.slot_npre: dict[int, int] = {}   # preemptions suffered so far
        self.prefilling: dict[int, _PrefillJob] = {}
        self.waiting: list[_WaitEntry] = []
        self.finished: list[FinishedRequest] = []
        self.steps = 0
        self.n_preemptions = 0
        self.n_chunks = 0
        self.prefill_dispatches = 0
        self._seq = 0
        self._inflight: set[int] = set()

        # prefix cache (opt-in; off for backends with nothing page-resident
        # to reuse) and its counters, zero when disabled
        self.cache = None
        if ecfg.prefix_cache and getattr(self.backend,
                                         "supports_prefix_cache", False):
            from repro_torch.serve.prefix_cache import RadixPrefixCache
            self.cache = RadixPrefixCache(self.alloc, self.w)
        self.n_prefix_hits = 0
        self.n_prefix_misses = 0
        self.n_pages_shared = 0
        self.n_prefix_tokens_reused = 0
        self.prefix_hits: dict[int, int] = {}  # rid -> tokens reused

        # speculative-decoding counters (zero when spec_k == 0)
        self.n_spec_drafted = 0           # draft tokens proposed
        self.n_spec_accepted = 0          # draft tokens verification kept
        self.n_spec_rollbacks = 0         # rounds that rejected a draft

        # robustness counters (`serve.supervisor` increments retries /
        # quarantined / degradation_level; rejections and deadline kills
        # are the engine's own admission-control outcomes)
        self.n_rejected = 0
        self.n_deadline_expired = 0
        self.n_retries = 0                # supervised step re-executions
        self.n_quarantined = 0            # slots evicted by fault isolation
        self.degradation_level = 0        # supervisor ladder rung (0 = full)
        self._deadline: dict[int, float] = {}
        self.reject_reasons: dict[int, str] = {}

    # ------------------------------------------------------------ plumbing --

    def _sample(self, logits, req: Request, index: int) -> int:
        return _backends.sample_host(logits, req.rid, index,
                                     req.temperature, self._key)

    def pages_needed(self, req: Request) -> int:
        return self.backend.pages_needed(len(req.prompt)
                                         + req.max_new_tokens)

    def stats(self) -> dict[str, Any]:
        """Scheduler counters merged with the backend's; every key of
        `backends.STATS_SCHEMA`."""
        s = {"backend": self.backend.name, "steps": self.steps,
             "chunks": self.n_chunks,
             "prefill_dispatches": self.prefill_dispatches,
             "preemptions": self.n_preemptions,
             "pages_high_water": self.alloc.high_water,
             "reserve_dips": self.alloc.reserve_dips,
             "prefix_cache_hits": self.n_prefix_hits,
             "prefix_cache_misses": self.n_prefix_misses,
             "pages_shared": self.n_pages_shared,
             "prefix_tokens_reused": self.n_prefix_tokens_reused,
             "prefix_cache_pages": (self.cache.n_pages
                                    if self.cache is not None else 0),
             "prefix_cache_evictions": (self.cache.evictions
                                        if self.cache is not None else 0),
             "spec_drafted": self.n_spec_drafted,
             "spec_accepted": self.n_spec_accepted,
             "spec_rollbacks": self.n_spec_rollbacks,
             "rejected": self.n_rejected,
             "deadline_expired": self.n_deadline_expired,
             "retries": self.n_retries,
             "quarantined": self.n_quarantined,
             "degradation_level": self.degradation_level}
        s.update(self.backend.stats())
        return s

    def warmup(self, prompt_lens: list[int]) -> None:
        """Run every path the serving loop can take for the given prompt
        lengths once on a scratch engine (this engine's pool and scheduler
        state are untouched): the decode step, the chunk program (per-job
        mode: one job at a time; batched mode: one row width per power of
        two, submitted together so that they prefill concurrently) and
        each monolithic prefill group size.  On the card this builds the
        kernels and warms the libraries before the first request."""
        scratch = ServingEngine(self.params, self.cfg, self.ecfg,
                                backend=self.backend.fresh())
        k_max = 1 if (self.ecfg.prefill_chunk
                      and self.ecfg.prefill_mode == "per-job") \
            else self.ecfg.n_slots
        if self.ecfg.prefill_chunk and self.ecfg.prefill_mode == "batched":
            # no path depends on the prompt length in batched chunked mode
            prompt_lens = [max(prompt_lens)] if prompt_lens else []
        for n in sorted(set(prompt_lens)):
            # probes claim the minimal page budget a real request of this
            # length would, so warmup never rejects a servable length
            gen = 2 if self.backend.pages_needed(n + 2) \
                <= self.ecfg.pages_per_slot else 1
            sizes, k = [], 1
            while k <= k_max:
                sizes.append(k)
                k *= 2
            if sizes[-1] != k_max:
                sizes.append(k_max)
            for k in sizes:
                scratch.run([Request(rid=-1 - i, prompt=np.zeros(n, np.int32),
                                     max_new_tokens=gen) for i in range(k)])

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
        self._enqueue(_WaitEntry(req=req, seq=self._seq))
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
        n = len(req.prompt)
        batched = self.ecfg.prefill_mode == "batched"
        if not self.ecfg.prefill_chunk:
            self.backend.validate_prompt(n, "monolithic")
        elif self.backend.chunkable(n, batched):
            self.backend.validate_prompt(n, "chunked")
        elif batched:
            # batched chunked mode has no monolithic route: shed now
            raise ValueError(
                f"prompt length {n} is not servable: the "
                f"{self.backend.name} backend cannot start it through the "
                "batched chunk program (use prefill_mode='per-job' or "
                "monolithic prefill)")
        else:
            self.backend.validate_prompt(n, "monolithic")

    def _reject(self, req: Request, why: str) -> None:
        self.n_rejected += 1
        self.reject_reasons[req.rid] = why
        self.finished.append(FinishedRequest(
            rid=req.rid, tokens=np.zeros(0, np.int32), arrival=req.arrival,
            admitted=0.0, first_token=0.0, finished=time.perf_counter(),
            reason="rejected"))

    def _enqueue(self, entry: _WaitEntry) -> None:
        bisect.insort(self.waiting, entry, key=lambda e: e.key)

    def _emit(self, slot: int, tok: int, now: float) -> None:
        self.slot_out[slot].append(tok)
        self.slot_times[slot].append(now)

    def _retire(self, slot: int, now: float, cancelled: bool = False,
                reason: Optional[str] = None) -> None:
        if reason is None:
            reason = "cancelled" if cancelled else "complete"
        req = self.slot_req.pop(slot)
        self.slot_entry.pop(slot)
        out = self.slot_out.pop(slot)
        times = self.slot_times.pop(slot)
        admitted, ttft = self.slot_meta.pop(slot)
        self.alloc.release(self.slot_pages.pop(slot))
        self.slot_seq.pop(slot)
        npre = self.slot_npre.pop(slot)
        self.active[slot] = False
        self.t[slot] = 0
        self.page_table[slot] = 0     # unused entries must stay in-bounds
        self.slot_temp[slot] = 0.0
        self.free_slots.append(slot)
        self.backend.retire(slot)
        self.backend.invalidate()
        self._inflight.discard(req.rid)
        self.finished.append(FinishedRequest(
            rid=req.rid, tokens=np.asarray(out, np.int32),
            arrival=req.arrival, admitted=admitted, first_token=ttft,
            finished=now, token_times=times, preemptions=npre,
            cancelled=cancelled, reason=reason))

    def cancel(self, rid: int, reason: str = "cancelled") -> bool:
        """Kill an in-flight request in any state (waiting, preempted and
        waiting, mid chunked prefill, decoding), releasing its slot and
        page references at once; the FinishedRequest carries the tokens
        already emitted.  Returns False if ``rid`` is not in flight."""
        now = time.perf_counter()
        for entry in self.waiting:
            if entry.req.rid == rid:
                self.waiting.remove(entry)
                out, times, meta = entry.resume or \
                    ([], [], (entry.first_admit or 0.0, 0.0))
                self._inflight.discard(rid)
                self.finished.append(FinishedRequest(
                    rid=rid, tokens=np.asarray(out, np.int32),
                    arrival=entry.req.arrival, admitted=meta[0],
                    first_token=meta[1], finished=now,
                    token_times=list(times), preemptions=entry.evictions,
                    cancelled=True, reason=reason))
                return True
        for slot, job in self.prefilling.items():
            if job.entry.req.rid != rid:
                continue
            entry = job.entry
            del self.prefilling[slot]
            self.alloc.release(self.slot_pages.pop(slot))
            self.slot_seq.pop(slot)
            self.page_table[slot] = 0
            self.free_slots.append(slot)
            self.backend.retire(slot)
            self.backend.invalidate()
            self._inflight.discard(rid)
            out, times, meta = entry.resume or \
                ([], [], (job.admit_time, 0.0))
            self.finished.append(FinishedRequest(
                rid=rid, tokens=np.asarray(out, np.int32),
                arrival=entry.req.arrival, admitted=meta[0],
                first_token=meta[1], finished=now, token_times=list(times),
                preemptions=entry.evictions, cancelled=True, reason=reason))
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

    # ---------------------------------------------------------- preemption --

    def _pick_victim(self, below: Optional[int] = None) -> Optional[int]:
        """Lowest-priority occupied slot, ties toward the most recently
        admitted (its recompute loses the least work).  ``below`` keeps
        only strictly lower priorities (admission never thrashes equals)."""
        cands = [(job.entry.req.priority, self.slot_seq[s], s)
                 for s, job in self.prefilling.items()]
        cands += [(req.priority, self.slot_seq[s], s)
                  for s, req in self.slot_req.items()]
        if below is not None:
            cands = [c for c in cands if c[0] < below]
        if not cands:
            return None
        cands.sort(key=lambda c: (c[0], -c[1]))
        return cands[0][2]

    def _preempt(self, slot: int) -> None:
        """Evict ``slot``: release its pages and requeue its request.  A
        decoding victim keeps its emitted tokens and stamps and is rebuilt
        by recompute-from-prompt; a prefilling victim restarts."""
        self.n_preemptions += 1
        self.alloc.release(self.slot_pages.pop(slot))
        self.page_table[slot] = 0
        self.slot_seq.pop(slot)
        job = self.prefilling.pop(slot, None)
        if job is not None:
            entry = job.entry
        else:
            entry = self.slot_entry.pop(slot)
            self.slot_req.pop(slot)
            out = self.slot_out.pop(slot)
            times = self.slot_times.pop(slot)
            meta = self.slot_meta.pop(slot)
            self.slot_npre.pop(slot)
            entry.resume = (out, times, meta)
            entry.snapshot = self.backend.preempt_snapshot(slot)
            self.active[slot] = False
            self.t[slot] = 0
            self.slot_temp[slot] = 0.0
            self.backend.invalidate()
        entry.evictions += 1
        self.free_slots.append(slot)
        self._enqueue(entry)

    def _reclaim_cache(self, pages: int, reserved: bool = False) -> None:
        """Drop cached prefix nodes (LRU leaf first) until ``pages`` are
        allocatable or the cache is empty — before any live victim."""
        if self.cache is None:
            return
        while (not self.alloc.can_alloc(pages, reserved)
               and self.cache.evict_one()):
            pass

    def _preempt_for(self, priority: int, pages: int,
                     need_slot: bool = False) -> None:
        """Evict strictly-lower-priority victims until ``pages`` are
        allocatable (and a slot is free, if asked) or none remain."""
        self._reclaim_cache(pages)
        while ((need_slot and not self.free_slots)
               or not self.alloc.can_alloc(pages)):
            victim = self._pick_victim(below=priority)
            if victim is None:
                return
            self._preempt(victim)
            self._reclaim_cache(pages)

    # ----------------------------------------------------------- admission --

    def _admit(self, now: float) -> None:
        if self.ecfg.prefill_chunk:
            self._admit_chunked(now)
        else:
            self._admit_grouped(now)

    def _entry_total(self, entry: _WaitEntry) -> int:
        """Tokens the prefill of this entry packs: the prompt, plus (for a
        preempted victim) everything it emitted short of the last token,
        which re-enters through decode."""
        n_train = len(entry.req.prompt)
        return n_train if entry.resume is None \
            else n_train + len(entry.resume[0]) - 1

    def _match_prefix(self, entry: _WaitEntry) -> list:
        """Cached nodes this entry can attach: the longest cached prefix of
        a window-aligned prompt, quantised DOWN to a chunk boundary (every
        remaining chunk then covers the span a cold run's would, so the
        hit is exact), leaving at least one token to prefill."""
        if self.cache is None:
            return []
        n_train = len(entry.req.prompt)
        if n_train % self.w:
            return []
        if self.ecfg.prefill_mode == "per-job" \
                and not self.backend.chunkable(n_train, batched=False):
            return []               # the monolithic route packs from zero
        limit = min(n_train, self._entry_total(entry) - 1) // self.w
        if limit <= 0:
            return []
        nodes = self.cache.match(entry.req.prompt, limit)
        chunk_w = self.ecfg.prefill_chunk // self.w
        return nodes[: (len(nodes) // chunk_w) * chunk_w]

    def _first_chunk_pages(self, entry: _WaitEntry,
                           shared_pages: int = 0) -> int:
        """NEW pages the first prefill dispatch of this entry needs beyond
        ``shared_pages`` attached from the prefix cache: one chunk's worth,
        or the whole prompt when, in per-job mode, the backend's chunk
        program cannot start it and it goes through the monolithic path."""
        n_train = len(entry.req.prompt)
        if self.ecfg.prefill_mode == "per-job" \
                and not self.backend.chunkable(n_train, batched=False):
            return self.backend.pages_needed(n_train)
        t0 = shared_pages * self.w
        first = min(self.ecfg.prefill_chunk, self._entry_total(entry) - t0)
        return self.backend.pages_needed(t0 + first) - shared_pages

    def _admit_chunked(self, now: float) -> None:
        """Chunked admission: one request at a time, first-chunk pages
        only.  A higher-priority arrival preempts the lowest strictly-lower
        victim when slots or pages run short.  With the prefix cache on,
        matched pages attach by reference and the job starts at the first
        unshared chunk."""
        while self.waiting:
            entry = self.waiting[0]
            nodes = self._match_prefix(entry)
            first = self._first_chunk_pages(entry, len(nodes))
            if not self.free_slots or not self.alloc.can_alloc(first):
                self._preempt_for(entry.req.priority, first, need_slot=True)
                # relief may have evicted matched cache nodes: re-match
                nodes = self._match_prefix(entry)
                first = self._first_chunk_pages(entry, len(nodes))
                if not self.free_slots or not self.alloc.can_alloc(first):
                    return
            self.waiting.pop(0)
            slot = self.free_slots.pop()
            toks = np.asarray(entry.req.prompt, np.int32)
            if entry.resume is not None:
                toks = np.concatenate(
                    [toks, np.asarray(entry.resume[0][:-1], np.int32)])
            if entry.first_admit is None:
                entry.first_admit = now
            shared = len(nodes) * self.w
            self.prefilling[slot] = _PrefillJob(
                entry=entry, toks=toks, n_train=len(entry.req.prompt),
                admit_time=entry.first_admit, done=shared)
            self.backend.alloc_slot(slot)
            shared_pages = [nd.page for nd in nodes]
            if shared_pages:
                self.alloc.retain(shared_pages)
                self.backend.attach_prefix(slot,
                                           [nd.payload for nd in nodes])
                self.n_prefix_hits += 1
                self.n_pages_shared += len(shared_pages)
                self.n_prefix_tokens_reused += shared
                self.prefix_hits[entry.req.rid] = shared
            elif self.cache is not None:
                self.n_prefix_misses += 1
                self.prefix_hits.setdefault(entry.req.rid, 0)
            # claim the first dispatch's pages now, so concurrent
            # admissions never overcommit the same free pages
            pages = shared_pages + self.alloc.alloc(first)
            self.slot_pages[slot] = pages
            self.page_table[slot] = 0
            self.page_table[slot, : len(pages)] = pages
            self.backend.invalidate()
            self._seq += 1
            self.slot_seq[slot] = self._seq

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
            for slot in slots:
                self.backend.alloc_slot(slot)
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
                    self.backend.retire(slot)
                self.backend.invalidate()
                for e in group:
                    self._enqueue(e)
                raise
            for i, (entry, slot, pages) in enumerate(
                    zip(group, slots, pages_list)):
                req = entry.req
                self.slot_req[slot] = req
                self.slot_entry[slot] = entry
                self.slot_pages[slot] = pages
                self.slot_out[slot] = []
                self.slot_times[slot] = []
                self.slot_npre[slot] = 0
                self._seq += 1
                self.slot_seq[slot] = self._seq
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

    # ------------------------------------------------------ chunked prefill --

    def _grow_pages(self, slot: int, target: int) -> bool:
        """Grow ``slot`` to ``target`` pages for its next prefill dispatch.
        Under pressure the globally worst occupant (lowest priority, then
        most recently admitted) is evicted until the allocation fits; if
        this job IS the worst occupant while others wait on it, it yields.
        The strict order (priority, admission seq) rules out livelock
        between equal-priority jobs."""
        delta = target - len(self.slot_pages[slot])
        if delta <= 0:
            return True
        self._reclaim_cache(delta)
        while not self.alloc.can_alloc(delta):
            victim = self._pick_victim()
            if victim is None or victim == slot:
                break
            self._preempt(victim)
            self._reclaim_cache(delta)
        if not self.alloc.can_alloc(delta):
            occupied = len(self.prefilling) + len(self.slot_req)
            if occupied > 1 and self._pick_victim() == slot:
                self._preempt(slot)
            return False
        pages = self.alloc.alloc(delta)
        base = len(self.slot_pages[slot])
        for i, p in enumerate(pages):
            self.page_table[slot, base + i] = p
        self.slot_pages[slot].extend(pages)
        self.backend.invalidate()
        return True

    def _advance_prefill(self, now: float) -> None:
        """ONE prefill dispatch per engine step: batched mode advances
        every prefilling job one chunk, per-job mode the best-keyed job."""
        if not self.prefilling:
            return
        if self.ecfg.prefill_mode == "batched":
            self._advance_prefill_batched()
        else:
            self._advance_prefill_per_job()

    def _advance_prefill_per_job(self) -> None:
        """Advance the best-keyed prefilling job by one dispatch: a chunk,
        or the monolithic path for a prompt the chunk program cannot start
        (a prompt that is not window-aligned)."""
        slot, job = min(self.prefilling.items(),
                        key=lambda kv: kv[1].entry.key)
        n_total = len(job.toks)
        if job.done == 0 and not self.backend.chunkable(job.n_train,
                                                        batched=False):
            n = job.n_train
            if not self._grow_pages(slot, self.backend.pages_needed(n)):
                return
            logits = self.backend.prefill_group(
                job.toks[None, :n].astype(np.int32), [slot],
                [self.slot_pages[slot]])
            job.done = n
            self.prefill_dispatches += 1
            if job.done == n_total:
                self._finish_prefill(slot, job, logits[0])
            return
        chunk = self.ecfg.prefill_chunk
        t0 = job.done
        nv = min(chunk, n_total - t0)
        if not self._grow_pages(slot, self.backend.pages_needed(t0 + nv)):
            return
        toks = np.zeros(chunk, np.int32)
        toks[:nv] = job.toks[t0:t0 + nv]
        logits = self.backend.prefill_chunk(
            slot, self.page_table[slot], toks, t0, nv, job.n_train)
        self.n_chunks += 1
        self.prefill_dispatches += 1
        job.done = t0 + nv
        if job.done == n_total:
            self._finish_prefill(slot, job, logits)

    def _advance_prefill_batched(self) -> None:
        """ONE dispatch advances every prefilling job one chunk.  Jobs that
        cannot claim their next pages sit this step out (and may have
        yielded in `_grow_pages`); growth runs best-key first."""
        chunk = self.ecfg.prefill_chunk
        advancing: list[tuple[int, _PrefillJob, int]] = []
        for slot, job in sorted(self.prefilling.items(),
                                key=lambda kv: kv[1].entry.key):
            if self.prefilling.get(slot) is not job:
                continue              # evicted while an earlier job grew
            nv = min(chunk, len(job.toks) - job.done)
            if not self._grow_pages(slot,
                                    self.backend.pages_needed(job.done + nv)):
                continue
            if self.prefilling.get(slot) is job:
                advancing.append((slot, job, nv))
        if not advancing:
            return
        # rows are jobs, padded to a power-of-two width with DISTINCT idle
        # slot ids (inactive rows pass their slot's state through)
        p_w = min(1 << (len(advancing) - 1).bit_length(), self.ecfg.n_slots)
        used = {s for s, _, _ in advancing}
        pads = [s for s in range(self.ecfg.n_slots) if s not in used]
        slot_ids = [s for s, _, _ in advancing] + pads[: p_w - len(advancing)]
        toks = np.zeros((p_w, chunk), np.int32)
        job_active = np.zeros(p_w, bool)
        t0s = np.zeros(p_w, np.int32)
        nvs = np.zeros(p_w, np.int32)
        ntr = np.ones(p_w, np.int32)
        for i, (slot, job, nv) in enumerate(advancing):
            toks[i, :nv] = job.toks[job.done:job.done + nv]
            job_active[i] = True
            t0s[i] = job.done
            nvs[i] = nv
            ntr[i] = job.n_train
        logits = self.backend.prefill_chunks(
            slot_ids, toks, job_active, self.page_table[slot_ids], t0s, nvs,
            ntr)
        self.n_chunks += len(advancing)
        self.prefill_dispatches += 1
        for i, (slot, job, nv) in enumerate(advancing):
            job.done += nv
            if job.done == len(job.toks):
                self._finish_prefill(slot, job, logits[i])

    def _finish_prefill(self, slot: int, job: _PrefillJob,
                        logits: np.ndarray) -> None:
        """Last chunk landed: move the slot into the decode batch.  Fresh
        requests sample their first token from the final chunk's logits;
        preempted ones restore their emitted tokens and continue."""
        entry = job.entry
        req = entry.req
        del self.prefilling[slot]
        n_total = len(job.toks)
        self.slot_req[slot] = req
        self.slot_entry[slot] = entry
        self.t[slot] = n_total
        self.active[slot] = True
        self.backend.slot_filled(slot, n_total, snapshot=entry.snapshot)
        entry.snapshot = None
        self.backend.invalidate()
        if self.cache is not None and job.n_train % self.w == 0:
            # commit this prompt's windows (each new node retains its page;
            # the summary rows are snapshotted only if nodes are added)
            m = job.n_train // self.w
            self.cache.insert(
                job.toks, m, self.slot_pages[slot][:m],
                lambda: self.backend.prefix_snapshot(slot, m))
        self.slot_npre[slot] = entry.evictions
        self.slot_rid[slot] = req.rid
        self.slot_temp[slot] = req.temperature
        if entry.resume is None:
            self.slot_out[slot] = []
            self.slot_times[slot] = []
            first = self._sample(logits, req, 0)
            self.sample_idx[slot] = 1
            self.slot_meta[slot] = (job.admit_time, time.perf_counter())
            self._emit(slot, first, time.perf_counter())
            self.tokens_in[slot] = first
            if req.max_new_tokens == 1:
                self._retire(slot, time.perf_counter())
        else:
            out, times, meta = entry.resume
            entry.resume = None
            self.slot_out[slot] = list(out)
            self.slot_times[slot] = list(times)
            self.slot_meta[slot] = meta
            self.sample_idx[slot] = len(out)
            self.tokens_in[slot] = out[-1]

    def _ensure_append_pages(self) -> None:
        """Every active slot owns the page its next append lands in.
        Appends may dip into the reserve; if the pool is dry the
        lowest-priority slot is preempted (possibly the appender)."""
        for slot in np.nonzero(self.active)[0]:
            slot = int(slot)
            while (self.active[slot]
                   and int(self.t[slot]) // self.w
                   >= len(self.slot_pages[slot])):
                need_idx = len(self.slot_pages[slot])
                self._reclaim_cache(1, reserved=True)
                while not self.alloc.can_alloc(1, reserved=True):
                    victim = self._pick_victim()
                    if victim is None:
                        break
                    self._preempt(victim)
                    self._reclaim_cache(1, reserved=True)
                    if victim == slot:
                        break
                if not self.active[slot]:
                    break             # preempted as a victim this pass
                page = self.alloc.alloc(1, reserved=True)[0]
                # an append writes its page in place, so it must never be
                # shared: fresh pages carry one reference and append pages
                # never enter the prefix cache
                if self.alloc.refcount(page) != 1:
                    raise AllocatorInvariantError(
                        f"append page {page} is shared")
                self.slot_pages[slot].append(page)
                self.page_table[slot, need_idx] = page
                self.backend.invalidate()

    # ---------------------------------------------------- speculative round --

    def _spec_round(self, now: float) -> None:
        """One draft/verify/commit round for the whole active batch.

        Per-slot draft length = min(spec_k, remaining - 1, the backend's
        draft horizon), floored at 0 — a zero-length slot still runs verify
        position 0 and commits one token, so every request retires after
        exactly the tokens the non-speculative engine emits.  The commit
        rule is the lossless one: keep the longest draft prefix the exact
        decode rule reproduced token for token, plus its first correction;
        the backend rewinds the rejected suffix."""
        k = self.ecfg.spec_k
        act = [int(s) for s in np.nonzero(self.active)[0]]
        remaining = np.zeros_like(self.t)
        for slot in act:
            remaining[slot] = (self.slot_req[slot].max_new_tokens
                               - len(self.slot_out[slot]))
        horizon = np.asarray(self.backend.draft_horizon(self.t))
        spec_len = np.where(
            self.active,
            np.minimum(np.minimum(k, remaining - 1), horizon),
            0).astype(np.int32)
        spec_len = np.maximum(spec_len, 0)

        drafts = self.backend.draft_steps(
            self.tokens_in, self.t, self.active, self.page_table,
            self.slot_rid, self.slot_temp, self.sample_idx, self._key,
            spec_len)
        verify = self.backend.verify_step(
            self.tokens_in, self.t, self.active, self.page_table,
            self.slot_rid, self.slot_temp, self.sample_idx, self._key,
            spec_len, drafts)

        commits = np.ones(len(self.t), np.int32)
        for slot in act:
            sl = int(spec_len[slot])
            j = 0
            while j < sl and drafts[j, slot] == verify[j, slot]:
                j += 1
            commits[slot] = j + 1
            self.n_spec_drafted += sl
            self.n_spec_accepted += j
            self.n_spec_rollbacks += int(j < sl)
        self.backend.rollback(commits, self.active)

        for slot in act:
            req = self.slot_req[slot]
            c = int(commits[slot])
            for i in range(c):
                self._emit(slot, int(verify[i, slot]), now)
            self.t[slot] += c
            self.sample_idx[slot] += c
            self.tokens_in[slot] = int(verify[c - 1, slot])
            if len(self.slot_out[slot]) >= req.max_new_tokens:
                self._retire(slot, now)
        # positions moved by per-slot amounts: the device copies are stale
        self.backend.invalidate()

    # ---------------------------------------------------------------- step --

    def step(self) -> bool:
        """One iteration: expire deadlines, admit, advance prefill (one
        dispatch), ensure append pages, then one fused decode step — or,
        with ``spec_k`` > 0, one speculative round — for the active batch.
        False when there is nothing left to do."""
        self._expire_deadlines()
        now = time.perf_counter()
        self._admit(now)
        self._advance_prefill(now)
        if self.ecfg.prefill_chunk:
            self._ensure_append_pages()
        if not self.active.any():
            return bool(self.waiting or self.prefilling)
        if self.ecfg.spec_k:
            self._spec_round(time.perf_counter())
            self.steps += 1
            return True
        fused = self.ecfg.sample_device == "fused"
        out = self.backend.decode_step(
            self.tokens_in, self.t, self.active, self.page_table,
            self.slot_rid, self.slot_temp, self.sample_idx, self._key)
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
        while (idx < len(pending) or self.waiting or self.prefilling
               or self.active.any()):
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
