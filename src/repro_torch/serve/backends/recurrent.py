"""Recurrent serving backends: Mamba2 (SSD) and RecurrentGemma (RG-LRU)
(port of ``repro.serve.backends.recurrent``).

The compression end of the paper's fast-weight spectrum: the decode state
is a CONSTANT-size module per request (SSD state + conv tail; RG-LRU
state + conv tail + a bounded per-slot attention cache for the hybrid's
attention layers), so a slot is an index into the state's slot axis and
there is no paging.  The scheduler's pages stay admission-control
currency: `pages_needed` still meters the context budget.

What runs per engine step:

  * ``decode_step`` — one step for the whole slot batch; per-slot
    positions, activity and sampling inputs are data, and only active
    slots' states change (the others keep their bits);
  * ``prefill_chunks`` / ``prefill_chunk`` — the model's chunk prefill
    (`*_prefill_chunk`: bulk projections, per-token recurrences with the
    decode step's arithmetic) for a row-packed subset of slots, gathered
    and scattered back (`core.slotted`); rows with n_valid 0 pass through
    bit for bit.  Recompute-from-prompt preemption re-runs the chunks over
    prompt + emitted tokens;
  * ``prefill_group`` — the same chunk program over the window-aligned
    prompt, one call per admission group (monolithic mode).

The hybrid's attention caches finalise inline (the chunk prefill and the
decode step are then one per-token function).  Everything runs under
``torch.inference_mode`` and updates the states in place.

`static_reference` is a structurally different program: a time-major loop
of the full decode step over the prompt, then single-token decode, so the
engine's parity checks test the slot gathers, masks and chunking.

Speculation (``spec_k`` > 0): ``self`` mode drafts by running the exact
decode step k times (its state commits: every draft verifies, one more
step samples the correction); ``stress`` mode proposes synthetic,
mostly wrong drafts on the host, verifies them teacher-forced from a
snapshot and rolls back by replaying the committed prefix from it.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from repro_torch import prng
from repro_torch.core import slotted
from repro_torch.core.mita_decode import window_aligned
from repro_torch.models import mamba2 as m2
from repro_torch.models import rglru as rg
from repro_torch.models.transformer import sample_tokens
from repro_torch.serve.backends import (BackendBase, sample_host,
                                        torn_guard)
from repro_torch.serve.backends.mita import _params_device


class _RecurrentBackend(BackendBase):
    """Shared `DecodeBackend` implementation; subclasses name the model's
    state init, decode step and chunk prefill."""

    family = ""
    supports_speculation = True

    def __init__(self, params: Any, cfg: Any, ecfg: Any, device=None):
        super().__init__(params, cfg, ecfg)
        mode = getattr(ecfg, "spec_mode", "auto")
        self.spec_mode = "self" if mode == "auto" else mode
        if getattr(ecfg, "spec_k", 0) and self.spec_mode not in ("self",
                                                                 "stress"):
            raise ValueError(
                f"recurrent backends speculate by self-drafting through "
                f"the decode step (spec_mode='self') or by the synthetic "
                f"rollback-exercising 'stress' mode (got {mode!r})")
        self.device = (torch.device(device) if device is not None
                       else _params_device(params))
        # inline landmark finalize for the hybrid's attention caches: the
        # chunk prefill and the decode step are then one per-token function
        self.cfg = dataclasses.replace(
            cfg, attn=dataclasses.replace(cfg.attn, external_finalize=False))
        self.window = cfg.attn.window
        self.capacity = ecfg.pages_per_slot * self.window
        self.states = self._init_states(ecfg.n_slots)
        self._snap = self._stress = self._verify_toks = None

    def fresh(self) -> "_RecurrentBackend":
        return type(self)(self.params, self.model_cfg, self.ecfg,
                          device=self.device)

    # ------------------------------------------------- model entry points --

    def _init_states(self, n_slots: int):
        raise NotImplementedError

    def _step(self, states, tok, t: np.ndarray, commit: Optional[np.ndarray]):
        """One decode step of the model at host positions ``t`` [S] for the
        slots in ``commit`` (None: all).  Returns logits [S, V]."""
        raise NotImplementedError

    def _chunk(self, states, toks, t0: np.ndarray, n_valid: np.ndarray):
        raise NotImplementedError

    def _dev(self, x, dtype=torch.int32):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=self.device)

    # ------------------------------------------------------ slot lifecycle --

    def alloc_slot(self, slot: int) -> None:
        # the chunk prefill accumulates into the slot's state from zero: a
        # retired occupant's state must not leak into the new request
        with torch.inference_mode():
            slotted.zero_slot(self.states, int(slot))

    # ----------------------------------------------------------- prefill --

    def _prefill_rows(self, slot_ids, toks, t0, n_valid) -> torch.Tensor:
        ids = self._dev(slot_ids, torch.int64)
        with torch.inference_mode():
            sub = slotted.gather_slots(self.states, ids)
            logits, sub = self._chunk(sub, self._dev(toks),
                                      np.asarray(t0, np.int32),
                                      np.asarray(n_valid, np.int32))
            slotted.scatter_slots(self.states, ids, sub)
            return logits.cpu()

    @torn_guard
    def prefill_group(self, prompts: np.ndarray, slots: list[int],
                      pages_list: list[list[int]]) -> torch.Tensor:
        del pages_list                  # constant-size states: no pages
        k, n = prompts.shape
        toks = np.zeros((k, window_aligned(n, self.window)), np.int32)
        toks[:, :n] = prompts
        return self._prefill_rows(slots, toks, np.zeros(k, np.int32),
                                  np.full(k, n, np.int32))

    @torn_guard
    def prefill_chunk(self, slot: int, pt_row: np.ndarray, toks: np.ndarray,
                      t0: int, n_valid: int, n_train: int) -> torch.Tensor:
        return self.prefill_chunks(
            [slot], np.asarray(toks)[None], np.ones(1, bool),
            np.asarray(pt_row)[None], np.array([t0], np.int32),
            np.array([n_valid], np.int32), np.array([n_train], np.int32))[0]

    @torn_guard
    def prefill_chunks(self, slot_ids: list[int], toks: np.ndarray,
                       job_active: np.ndarray, page_table: np.ndarray,
                       t0: np.ndarray, n_valid: np.ndarray,
                       n_train: np.ndarray) -> torch.Tensor:
        # no pages, and no train/decode boundary: the chunk IS the decode
        # update, so recomputed generated positions are exact by design
        del page_table, n_train
        nv = np.where(job_active, n_valid, 0).astype(np.int32)
        return self._prefill_rows(slot_ids, toks, t0, nv)

    # ------------------------------------------------------------- decode --

    def _sample(self, logits, rid, si, temperature, key):
        return sample_tokens(logits, rid, si, temperature, key)

    @torn_guard
    def decode_step(self, tokens_in: np.ndarray, t: np.ndarray,
                    active: np.ndarray, page_table: np.ndarray,
                    rid: np.ndarray, temperature: np.ndarray,
                    sample_idx: np.ndarray, key) -> Any:
        """One step.  Fused sampling returns [S] int32 tokens (numpy); host
        sampling the [S, V] logits as a CPU tensor."""
        del page_table                  # constant-size states: no pages
        with torch.inference_mode():
            logits = self._step(self.states, self._dev(tokens_in),
                                np.asarray(t), np.asarray(active, bool))
            self.decode_dispatches += 1
            if self.ecfg.sample_device == "fused":
                return self._sample(logits, rid, sample_idx, temperature,
                                    key).cpu().numpy()
            return logits.cpu()

    # -------------------------------------------------------- speculation --

    def _scan(self, toks: np.ndarray, t, active, rid, si, temperature, key,
              n_steps, feed_back: bool) -> np.ndarray:
        """Decode steps over positions 0 .. len(toks) - 1 for the slots with
        ``i < n_steps``, each sampling with (rid, si + i).  ``feed_back``:
        each sampled token is the next input (the self-drafting scan, an
        inactive slot's token passing through); else ``toks`` is the input
        stream (teacher-forced).  Returns the sampled tokens [n, S]."""
        t = np.asarray(t).astype(np.int64)
        si = np.asarray(si).astype(np.int32)
        active = np.asarray(active, bool)
        tok = np.asarray(toks[0], np.int32)
        outs = []
        for i in range(len(toks)):
            ac_i = active & (i < np.asarray(n_steps))
            if not feed_back:
                tok = np.asarray(toks[i], np.int32)
            logits = self._step(self.states, self._dev(tok), t, ac_i)
            out = self._sample(logits, rid, si, temperature, key).cpu() \
                .numpy().astype(np.int32)
            if feed_back:
                out = np.where(ac_i, out, tok).astype(np.int32)
                tok = out
            outs.append(out)
            t = t + ac_i
            si = si + ac_i
        return np.stack(outs)

    @torn_guard
    def draft_steps(self, tokens_in: np.ndarray, t: np.ndarray,
                    active: np.ndarray, page_table: np.ndarray,
                    rid: np.ndarray, temperature: np.ndarray,
                    sample_idx: np.ndarray, key,
                    spec_len: np.ndarray) -> np.ndarray:
        del page_table
        k = self.ecfg.spec_k
        if self.spec_mode == "stress":
            # synthetic host-side proposals, deliberately (mostly) wrong: no
            # dispatch here, and verify / rollback see real mismatches
            off = np.arange(1, k + 1, dtype=np.int32)[:, None]
            return ((np.asarray(tokens_in, np.int32)[None] + off)
                    % self.cfg.vocab)
        tokens_in = np.asarray(tokens_in, np.int32)
        with torch.inference_mode():
            drafts = self._scan(np.repeat(tokens_in[None], k, 0), t, active,
                                rid, sample_idx, temperature, key, spec_len,
                                feed_back=True)
        self.decode_dispatches += 1
        return drafts

    @torn_guard
    def verify_step(self, tokens_in: np.ndarray, t: np.ndarray,
                    active: np.ndarray, page_table: np.ndarray,
                    rid: np.ndarray, temperature: np.ndarray,
                    sample_idx: np.ndarray, key, spec_len: np.ndarray,
                    drafts: np.ndarray) -> np.ndarray:
        del page_table
        tokens_in = np.asarray(tokens_in, np.int32)
        t = np.asarray(t)
        spec_len = np.asarray(spec_len)
        sample_idx = np.asarray(sample_idx)
        if self.spec_mode == "stress":
            # snapshot, then teacher-force [input, drafts...]; rollback
            # restores the snapshot and replays the committed prefix with
            # the inputs stashed here
            with torch.inference_mode():
                self._snap = slotted.tree_map(torch.clone, self.states)
                self._stress = (tokens_in, t, np.asarray(rid),
                                np.asarray(temperature), sample_idx, key)
                toks = np.concatenate([tokens_in[None], np.asarray(drafts)])
                self._verify_toks = self._scan(
                    toks, t, active, rid, sample_idx, temperature, key,
                    spec_len + 1, feed_back=False)
            self.decode_dispatches += 1
            return self._verify_toks
        # self mode: the draft scan ran the exact decode rule and committed
        # its state, so the drafts verify themselves; one more step at
        # t + spec_len samples the correction token
        s = len(tokens_in)
        rows = np.maximum(spec_len - 1, 0)
        tok_v = np.where(spec_len > 0,
                         np.asarray(drafts)[rows, np.arange(s)], tokens_in)
        corr = self.decode_step(tok_v.astype(np.int32), t + spec_len, active,
                                None, rid, temperature,
                                sample_idx + spec_len, key)
        verify = np.concatenate(
            [np.asarray(drafts), np.zeros((1, s), np.int32)], 0)
        verify[spec_len, np.arange(s)] = corr
        return verify

    def rollback(self, commits: np.ndarray, active: np.ndarray) -> None:
        if self.spec_mode == "self":
            return                      # the drafted state IS the decode state
        tokens_in, t, rid, temp, sample_idx, key = self._stress
        n = np.where(np.asarray(active), np.asarray(commits), 0)
        # the committed prefix of the verify scan consumed exactly
        # [input, verify[0 .. c - 2]]: replaying it from the snapshot gives
        # the states of decoding those tokens one step at a time
        toks = np.concatenate([tokens_in[None], self._verify_toks[:-1]], 0)
        with torch.inference_mode():
            self.states = self._snap
            self._scan(toks, t, active, rid, sample_idx, temp, key, n,
                       feed_back=False)
        self.decode_dispatches += 1
        self._snap = self._verify_toks = self._stress = None

    # ------------------------------------------------------------- oracle --

    def static_reference(self, prompts: np.ndarray, max_new: int,
                         temperature: float = 0.0,
                         rids: Optional[list[int]] = None,
                         sample_key=None, record_gaps: bool = False):
        """Time-major loop of the full decode step over the prompt, then
        single-token decode; every lane independent of the others.  Greedy
        by default; with ``temperature`` > 0 the keys derive from (rid,
        token index) as the engine's sampler derives them.  Returns tokens
        [B, max_new] int32; ``record_gaps`` adds the gap between the two
        largest logits each token was picked from ([max_new, B]: a
        near-tie marks where float reduction order may flip a token)."""
        b, n = prompts.shape
        if sample_key is None:
            sample_key = prng.PRNGKey(0)
        rids = list(rids) if rids is not None else list(range(b))
        out = [[] for _ in range(b)]
        gaps = []
        with torch.inference_mode():
            states = self._init_states(b)
            for pos in range(n):
                logits = self._step(states, self._dev(prompts[:, pos]),
                                    np.full(b, pos), None)
            for i in range(max_new):
                if i:
                    logits = self._step(states, self._dev(
                        [o[-1] for o in out]), np.full(b, n + i - 1), None)
                lg = logits.cpu()
                if record_gaps:
                    top2 = torch.topk(lg.float(), 2, dim=-1).values
                    gaps.append((top2[:, 0] - top2[:, 1]).numpy())
                for row in range(b):
                    out[row].append(sample_host(lg[row], rids[row], i,
                                                temperature, sample_key))
        toks = np.asarray(out, np.int32)
        return (toks, np.stack(gaps)) if record_gaps else toks


class Mamba2Backend(_RecurrentBackend):
    """SSD decode state per slot: h [H, P, S] + conv tail (the taxonomy's
    compressed fast-weight module as a servable backend)."""

    name = family = "mamba2"

    def _init_states(self, n_slots: int):
        return m2.mamba_slot_states(self.cfg, n_slots, device=self.device)

    def _step(self, states, tok, t, commit):
        c = None if commit is None else self._dev(commit, torch.bool)
        logits, _ = m2.mamba_decode_step(self.params, states, tok, None,
                                         self.cfg, commit=c)
        return logits

    def _chunk(self, states, toks, t0, n_valid):
        return m2.mamba_prefill_chunk(self.params, states, toks, t0,
                                      self._dev(n_valid), self.cfg)


class RGLRUBackend(_RecurrentBackend):
    """RecurrentGemma hybrid: RG-LRU recurrences + a bounded per-slot MiTA
    attention cache advanced at per-slot positions
    (`models.transformer.attention_decode_slots`)."""

    name = family = "rglru"

    def _init_states(self, n_slots: int):
        return rg.rg_slot_states(self.cfg, n_slots, self.capacity,
                                 device=self.device)

    def _step(self, states, tok, t, commit):
        w = self.window
        ac = np.ones(len(t), bool) if commit is None else commit
        due = bool((ac & ((np.asarray(t) + 1) % w == 0)).any())
        c = None if commit is None else self._dev(commit, torch.bool)
        logits, _ = rg.rg_slot_decode_step(self.params, states, tok,
                                           self._dev(t), self.cfg, commit=c,
                                           due_hint=due)
        return logits

    def _chunk(self, states, toks, t0, n_valid):
        return rg.rg_prefill_chunk(self.params, states, toks, t0, n_valid,
                                   self.cfg)
