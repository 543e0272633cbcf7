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
    active)`` (state back to ``commits`` tokens past the round's start).

`for_arch` serves the dense family (`backends.mita.MiTABackend`, paged
MiTA pools) and the recurrent ones (`backends.recurrent`: ``ssm`` on
`Mamba2Backend`, ``hybrid`` on `RGLRUBackend`); `resolve` gives a bare
`ModelConfig` the MiTA backend and refuses the rest, as the reference.
"""

from __future__ import annotations

from typing import Any

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
    if arch.family == "dense":
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
           "ENGINE_STAT_KEYS", "BACKEND_STAT_KEYS", "STATS_SCHEMA"]
