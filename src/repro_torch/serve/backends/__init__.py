"""Serving backends: the `DecodeBackend` protocol behind the scheduler
(port of ``repro.serve.backends``).

The engine owns requests, slots, pages and time; a backend owns the model
parameters, the per-slot decode state and every device operation.  This
port carries the protocol surface the engine calls in its monolithic and
chunked modes:

  * ``pages_needed(n)``, ``chunkable(n, batched)``,
    ``validate_prompt(n, path)``;
  * ``prefill_group(...)`` (monolithic), ``prefill_chunks(...)``
    (batched chunked prefill) and ``prefill_chunk(...)`` (per-job chunked
    prefill), ``decode_step(...)``;
  * the slot lifecycle: ``alloc_slot``, ``slot_filled(slot, n,
    snapshot=None)``, ``retire``, ``preempt_snapshot``, ``invalidate``;
  * the prefix cache: ``supports_prefix_cache``, ``prefix_snapshot``,
    ``attach_prefix``;
  * ``stats()`` and ``static_reference(...)`` (the oracle the engine's
    greedy tokens must equal), ``fresh()`` (a zeroed twin);
  * speculation: ``supports_speculation``, ``draft_horizon(t)``,
    ``draft_steps(...)`` (cheap drafts [k, S] that change no state),
    ``verify_step(...)`` (the exact decode rule over the k + 1 positions
    [input, drafts...], tokens [k + 1, S]) and ``rollback(commits,
    active)`` (state back to ``commits`` tokens past the round's start);
  * supervision notifications, no-op by default: ``on_quarantine(slots)``,
    ``on_degrade(level)`` and ``on_stall()``.  `serve.supervisor` fires
    them on fault isolation, a degradation-ladder rung and a scheduler
    stall; fault-injection wrappers (`serve.chaos`) key fault lifecycles
    off them.

Torn dispatches.  The port's backends update their state in place, layer
by layer (the reference's programs are functional: a failed one leaves
its state as it was).  An exception that escapes from inside a dispatch
body (`torn_guard`: ``prefill_group``, ``prefill_chunk``,
``prefill_chunks``, ``decode_step``, ``draft_steps``, ``verify_step``)
may have left the live slots' state half updated, so re-running the
dispatch could silently compute different tokens.  The guard re-raises it
as `TornDispatch`, which names the dispatch's live slots, is not
batch-wide and may not be retried: the supervisor quarantines those slots
at once, and recompute-from-prompt rebuilds them (every port backend's
``preempt_snapshot`` is None; exactly in float32; in bfloat16 a
recomputed stream may part from the uninterrupted one, as in the
reference, ROADMAP C.13).

`for_arch` serves the dense, moe and vlm families
(`backends.mita.MiTABackend`, paged MiTA pools) and the recurrent ones (`backends.recurrent`: ``ssm`` on
`Mamba2Backend`, ``hybrid`` on `RGLRUBackend`); `resolve` gives a bare
`ModelConfig` the MiTA backend and refuses the rest, as the reference.
"""

from __future__ import annotations

import functools
import inspect
from typing import Any, Callable

import numpy as np
import torch

from repro_torch import prng
from repro_torch.core.mita_decode import window_aligned

ENGINE_STAT_KEYS = frozenset({
    "backend", "steps", "chunks", "prefill_dispatches", "preemptions",
    "pages_high_water", "reserve_dips", "prefix_cache_hits",
    "prefix_cache_misses", "pages_shared", "prefix_tokens_reused",
    "prefix_cache_pages", "prefix_cache_evictions",
    "spec_drafted", "spec_accepted", "spec_rollbacks",
    "rejected", "deadline_expired", "retries", "quarantined",
    "degradation_level",
})
BACKEND_STAT_KEYS = frozenset({
    "decode_dispatches", "prefill_kernel_fallbacks",
    "paged_kernel_fallbacks", "finalize_kernel_fallbacks",
})
STATS_SCHEMA = ENGINE_STAT_KEYS | BACKEND_STAT_KEYS


class TornDispatch(RuntimeError):
    """A backend dispatch raised part way through: the state of ``slots``
    (its live slots) may be partly updated.  ``retryable`` False tells the
    supervisor to quarantine them instead of re-running the dispatch; the
    original exception is ``__cause__``.  A CUDA error that poisons the
    context (an illegal address) fails every later dispatch as well; the
    supervisor then ends in `SupervisionExhausted`, and recovery is
    `Supervisor.restore` from the journal in a new process."""

    kind = "torn"
    batchwide = False
    retryable = False

    def __init__(self, op: str, slots: list):
        super().__init__(f"{op} raised mid-dispatch (slots={slots}); their "
                         "state may be partly updated")
        self.op = op
        self.slots = list(slots)


def dispatch_slots(op: str, args: dict) -> list[int]:
    """The live slots of protocol dispatch ``op``, from its arguments by
    name: the admission group, the chunked slot, the active prefill rows,
    or the active decode slots."""
    if op == "prefill_group":
        return [int(s) for s in args["slots"]]
    if op == "prefill_chunk":
        return [int(args["slot"])]
    if op == "prefill_chunks":
        return [int(s) for s, a in zip(args["slot_ids"], args["job_active"])
                if a]
    return [int(s) for s in np.nonzero(np.asarray(args["active"]))[0]]


def torn_guard(fn: Callable) -> Callable:
    """Wrap a dispatch method so that an exception escaping its body
    surfaces as `TornDispatch` over its live slots (one already raised by
    a nested dispatch passes through unchanged)."""
    sig = inspect.signature(fn)

    @functools.wraps(fn)
    def guarded(self, *args, **kwargs):
        try:
            return fn(self, *args, **kwargs)
        except TornDispatch:
            raise
        except Exception as e:
            bound = sig.bind(self, *args, **kwargs).arguments
            raise TornDispatch(fn.__name__,
                               dispatch_slots(fn.__name__, bound)) from e
    return guarded


def sample_host(logits, rid: int, index: int, temperature: float,
                key) -> int:
    """THE host sampling rule, shared by the engine and every backend's
    `static_reference`: greedy first-index argmax, or a categorical keyed
    by ``fold_in(fold_in(key, rid), index)`` with the 1e-6 temperature
    floor of the device sampler (`models.transformer.sample_tokens`).

    ``logits``: [V] on the host, a numpy array or a CPU tensor in the
    compute dtype.  The divisor is a Python float, weakly typed in the
    reference, so it takes the logits' dtype: bfloat16 logits stay
    bfloat16 through the division and the argmax (the device sampler
    divides by a float32 array instead; the two may part in bfloat16 as
    they do in the reference)."""
    lg = torch.as_tensor(logits)
    if temperature <= 0.0:
        return int(prng.argmax_first(lg))
    k = prng.fold_in(prng.fold_in(torch.as_tensor(key).cpu(), rid), index)
    div = torch.tensor(max(temperature, 1e-6), dtype=lg.dtype)
    return int(prng.categorical(k, lg / div))


class BackendBase:
    """Shared defaults: window-quantised page math, no-op lifecycle hooks.
    Subclasses set ``name`` and ``window`` and implement prefill/decode."""

    name = "backend"
    supports_prefix_cache = False
    supports_speculation = False

    def __init__(self, params: Any, cfg: Any, ecfg: Any):
        self.params = params
        self.model_cfg = cfg
        self.ecfg = ecfg
        self.decode_dispatches = 0
        self._dirty = True

    def pages_needed(self, n_tokens: int) -> int:
        return window_aligned(n_tokens, self.window) // self.window

    def chunkable(self, n_train: int, batched: bool) -> bool:
        return True

    def validate_prompt(self, n: int, path: str) -> None:
        pass

    def alloc_slot(self, slot: int) -> None:
        pass

    def slot_filled(self, slot: int, n_tokens: int,
                    snapshot: Any = None) -> None:
        pass

    def retire(self, slot: int) -> None:
        pass

    def preempt_snapshot(self, slot: int) -> Any:
        return None

    def prefix_snapshot(self, slot: int, n_windows: int) -> list:
        raise NotImplementedError(
            f"{self.name} backend does not support the prefix cache")

    def attach_prefix(self, slot: int, payloads: list) -> None:
        raise NotImplementedError(
            f"{self.name} backend does not support the prefix cache")

    # --- speculative decoding (EngineConfig.spec_k > 0) ------------------
    # A backend sets `supports_speculation = True` and implements the
    # triple; the engine never calls it on a backend that does not.

    def draft_horizon(self, t: np.ndarray) -> np.ndarray:
        """Per-slot cap on draftable tokens past position ``t``.  Default:
        no backend-internal boundary."""
        return np.full_like(np.asarray(t), np.iinfo(np.int32).max)

    def draft_steps(self, tokens_in, t, active, page_table, rid,
                    temperature, sample_idx, key, spec_len) -> np.ndarray:
        raise NotImplementedError(
            f"{self.name} backend does not support speculative decoding")

    def verify_step(self, tokens_in, t, active, page_table, rid,
                    temperature, sample_idx, key, spec_len,
                    drafts) -> np.ndarray:
        raise NotImplementedError(
            f"{self.name} backend does not support speculative decoding")

    def rollback(self, commits: np.ndarray, active: np.ndarray) -> None:
        raise NotImplementedError(
            f"{self.name} backend does not support speculative decoding")

    def invalidate(self) -> None:
        self._dirty = True

    # --- supervision hooks (serve.supervisor) ----------------------------
    # No-op by default: the supervisor notifies the backend of fault-
    # isolation events so that wrappers (serve.chaos) can key fault
    # lifecycles off them — quarantine clears slot-bound faults, a ladder
    # rung clears persistent ones, a stall drains held resources.

    def on_quarantine(self, slots: list) -> None:
        pass

    def on_degrade(self, level: int) -> None:
        pass

    def on_stall(self) -> None:
        pass

    def stats(self) -> dict:
        # nothing falls back to a plain path on the card, so the fallback
        # counters of the schema are always 0
        return {"decode_dispatches": self.decode_dispatches,
                "prefill_kernel_fallbacks": 0,
                "paged_kernel_fallbacks": 0,
                "finalize_kernel_fallbacks": 0}


def resolve(params: Any, cfg: Any, ecfg: Any, device=None) -> BackendBase:
    """Default backend for a bare `ModelConfig`: the paged MiTA backend.
    Recurrent architectures carry no marker on `ModelConfig` alone: they
    are built by `for_arch` (the registry's family decides)."""
    attn = getattr(getattr(cfg, "attn", None), "backend", None)
    if attn in ("mita", "mita_ref"):
        from repro_torch.serve.backends.mita import MiTABackend
        return MiTABackend(params, cfg, ecfg, device=device)
    raise ValueError(
        f"no default serving backend for attention backend {attn!r}: "
        "ServingEngine drives MiTA paged decode caches unless a backend is "
        "passed; ssm/hybrid architectures serve through "
        "serve.backends.for_arch (constant-size recurrent slot states)")


def for_arch(arch: Any, params: Any, ecfg: Any, device=None) -> BackendBase:
    """Backend for a registry `ArchConfig`: any ported architecture with a
    decode state serves through the same scheduler."""
    if arch.family in ("dense", "moe", "vlm"):
        from repro_torch.serve.backends.mita import MiTABackend
        return MiTABackend(params, arch.model, ecfg, device=device)
    if arch.family == "ssm":
        from repro_torch.serve.backends.recurrent import Mamba2Backend
        return Mamba2Backend(params, arch.model, ecfg, device=device)
    if arch.family == "hybrid":
        from repro_torch.serve.backends.recurrent import RGLRUBackend
        return RGLRUBackend(params, arch.model, ecfg, device=device)
    raise ValueError(f"family {arch.family!r} has no serving backend "
                     "(ROADMAP A.12)")


__all__ = ["BackendBase", "resolve", "for_arch", "sample_host",
           "TornDispatch", "dispatch_slots", "torn_guard",
           "ENGINE_STAT_KEYS", "BACKEND_STAT_KEYS", "STATS_SCHEMA"]
