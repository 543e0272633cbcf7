"""Paged MiTA serving backend (port of ``repro.serve.backends.mita``).

Owns the stacked per-layer paged pools (`core.mita_decode.PagedMiTAState`),
the per-slot finalised-landmark count ``m_done`` and the device copies of
the scheduler tensors.  Per engine step it runs at most:

  * `prefill_group`  — monolithic prefill of an admission group, packed
    into the group's slots and pages (``prefill_chunk`` = 0);
  * `prefill_chunks` — one chunk for every prefilling slot in one call
    (batched chunked prefill: the chunk-prefill CUDA kernel on the card),
    or `prefill_chunk` — one chunk of one slot (the per-job mode, plain
    PyTorch as the reference's per-job op is plain XLA);
  * `decode_step`    — one fused step for the whole slot batch; in external
    finalize mode the window-boundary finalize runs inside it for the
    slots that are due, decided on the host (``due`` is known there) so
    no layer waits on a device flag;
  * or, with speculation, `draft_steps` (landmark-branch-only drafts,
    read-only), `verify_step` (the decode step at every drafted position)
    and `rollback` (the query sums back to the last committed position).

All of it runs under ``torch.inference_mode``.  The pools update in place.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from repro_torch import prng
from repro_torch.core import mita_decode as mdec
from repro_torch.kernels.ops import default_block_q
from repro_torch.models import transformer as tfm
from repro_torch.models.modules import ModelConfig
from repro_torch.serve.backends import (BackendBase, sample_host,
                                        torn_guard)


def _params_device(params) -> torch.device:
    leaf = params
    while isinstance(leaf, dict):
        leaf = next(iter(leaf.values()))
    return leaf.device


class MiTABackend(BackendBase):
    """Paged MiTA decode caches behind the `DecodeBackend` protocol."""

    name = "mita"
    supports_prefix_cache = True
    supports_speculation = True

    def __init__(self, params: Any, cfg: ModelConfig, ecfg: Any,
                 device=None):
        super().__init__(params, cfg, ecfg)
        if cfg.attn.backend not in ("mita", "mita_ref"):
            raise ValueError("MiTABackend drives MiTA decode caches "
                             f"(got attention backend {cfg.attn.backend!r})")
        mode = getattr(ecfg, "spec_mode", "auto")
        if getattr(ecfg, "spec_k", 0) and mode not in ("auto", "landmark"):
            raise ValueError(
                f"MiTABackend speculates by self-drafting against the "
                f"compressed landmark branch (spec_mode='landmark'; got "
                f"{mode!r})")
        self._q_stack = None                  # verify -> rollback handoff
        self.device = (torch.device(device) if device is not None
                       else _params_device(params))
        self.cfg = dataclasses.replace(
            cfg, attn=dataclasses.replace(
                cfg.attn, external_finalize=ecfg.finalize == "external"))
        self.window = cfg.attn.window
        s = ecfg.n_slots
        self.states = tfm.init_paged_states(self.cfg, s, ecfg.n_pages,
                                            ecfg.pages_per_slot,
                                            device=self.device)
        self.m_done = np.zeros(s, np.int32)   # finalised landmarks per slot
        self._t_dev = self._pt_dev = self._ac_dev = None

    def fresh(self) -> "MiTABackend":
        """A new instance with zeroed state and the same configuration."""
        return type(self)(self.params, self.cfg, self.ecfg,
                          device=self.device)

    # ------------------------------------------------------------ sizing --

    def chunkable(self, n_train: int, batched: bool) -> bool:
        """The batched chunk program serves any prompt (the n//m landmark
        quirk is per-slot data); the per-job program needs window-aligned
        prompts (the engine routes the rest through `prefill_group`)."""
        return batched or n_train % self.window == 0

    def validate_prompt(self, n: int, path: str) -> None:
        """Reject prompt lengths the prefill cannot serve, before any
        scheduler state changes: the landmark pooling needs
        n % (n // w) == 0 and the monolithic sorted routed branch needs
        whole query blocks (N*s % block_q == 0) — the same checks the
        reference makes by tracing the prefill."""
        a = self.cfg.attn
        m = max(1, n // a.window)
        if path != "monolithic":
            if n % m:
                raise ValueError(
                    f"prompt length {n} is not servable by the chunked "
                    f"prefill path (window {a.window}): the training-path "
                    "landmark pooling needs n % (n // window) == 0")
            return
        if n % m:
            raise ValueError(
                f"prompt length {n} is not servable by the {a.backend!r} "
                f"prefill path (window {a.window}): sequence length {n} "
                f"not divisible by m={m}")
        if a.backend == "mita" and a.impl == "sorted" and a.expert_span:
            s = min(a.s, m)
            bq = min(a.block_q or default_block_q(), a.window * s, n * s)
            if (n * s) % bq:
                raise ValueError(
                    f"prompt length {n} is not servable by the 'mita' "
                    f"prefill path (window {a.window}): N*s={n * s} not "
                    f"divisible by block_q={bq}")

    # ----------------------------------------------------------- prefill --

    @torn_guard
    def prefill_group(self, prompts: np.ndarray, slots: list[int],
                      pages_list: list[list[int]]) -> np.ndarray:
        k, n = prompts.shape
        cap = mdec.window_aligned(n, self.window)
        n_pg = cap // self.window
        with torch.inference_mode():
            toks = torch.as_tensor(prompts, dtype=torch.int32,
                                   device=self.device)
            logits, pre = tfm.lm_prefill(self.params, toks, self.cfg, cap)
            for i in range(k):
                pre_i = type(pre)(*(x[:, i:i + 1] if x.ndim >= 2 else x
                                    for x in pre))
                pages = torch.as_tensor(pages_list[i][:n_pg],
                                        dtype=torch.int64,
                                        device=self.device)
                tfm.pack_prefill_into_states(self.states, pre_i, slots[i],
                                             pages, self.cfg)
            return logits.cpu()

    @torn_guard
    def prefill_chunk(self, slot: int, pt_row: np.ndarray, toks: np.ndarray,
                      t0: int, n_valid: int, n_train: int) -> np.ndarray:
        """Per-job mode: one chunk of one slot (`models.transformer.
        lm_prefill_chunk`).  Returns its logits [V] at the last valid
        position."""
        dev = self.device
        with torch.inference_mode():
            logits, self.states = tfm.lm_prefill_chunk(
                self.params, self.states,
                torch.as_tensor(np.asarray(toks), dtype=torch.int32,
                                device=dev), int(slot),
                torch.as_tensor(np.asarray(pt_row), dtype=torch.int32,
                                device=dev), int(t0), int(n_valid),
                int(n_train), self.cfg)
            return logits.cpu()

    @torn_guard
    def prefill_chunks(self, slot_ids: list[int], toks: np.ndarray,
                       job_active: np.ndarray, page_table: np.ndarray,
                       t0: np.ndarray, n_valid: np.ndarray,
                       n_train: np.ndarray) -> np.ndarray:
        """One chunk for every row (rows are jobs; padding rows carry
        distinct idle slot ids and ``job_active`` False).  Returns the
        rows' logits [P, V] at their last valid position."""
        dev = self.device

        def up(x, dt=torch.int32):
            return torch.as_tensor(np.asarray(x), dtype=dt, device=dev)

        with torch.inference_mode():
            logits, self.states = tfm.lm_prefill_chunks(
                self.params, self.states, up(toks),
                up(job_active, torch.bool), up(page_table), up(slot_ids),
                up(t0), up(n_valid), up(n_train), self.cfg)
            return logits.cpu()

    # ------------------------------------------------------ slot lifecycle --

    def slot_filled(self, slot: int, n_tokens: int,
                    snapshot: Any = None) -> None:
        self.m_done[slot] = n_tokens // self.window
        self._dirty = True

    def preempt_snapshot(self, slot: int) -> Any:
        # recompute-from-prompt rebuilds the paged state exactly (the chunk
        # program replicates decode-time landmark availability past the
        # original prompt): nothing to save
        return None

    # --------------------------------------------------------- prefix cache --

    def prefix_snapshot(self, slot: int, n_windows: int) -> list:
        """Host copies of the slot's first ``n_windows`` per-window summary
        rows: one (lm_q, lm_v, expert_idx, expert_valid) tuple per window,
        each [L, Hkv, ...].  Expert rows are GLOBAL pool rows into the
        prefix's own pages, valid for every later holder of those pages."""
        st = self.states
        with torch.inference_mode():
            rows = [x[:, slot, :, :n_windows].clone().cpu()
                    for x in (st.lm_q, st.lm_v, st.expert_idx,
                              st.expert_valid)]
        return [tuple(x[:, :, i].clone() for x in rows)
                for i in range(n_windows)]

    def attach_prefix(self, slot: int, payloads: list) -> None:
        """Make ``slot`` look as if it had chunk-prefilled the cached
        windows itself: summary rows installed (rows past the prefix
        zeroed), ``pre_lm_q`` mirroring ``lm_q`` (aligned prompts share
        one landmark grid) and both query sums zeroed (a window-aligned
        resume point closes every window)."""
        st = self.states
        n = len(payloads)
        with torch.inference_mode():
            for dst, j in ((st.lm_q, 0), (st.lm_v, 1), (st.expert_idx, 2),
                           (st.expert_valid, 3), (st.pre_lm_q, 0)):
                dst[:, slot].zero_()
                if n:
                    dst[:, slot, :, :n] = torch.stack(
                        [p[j] for p in payloads], dim=2).to(
                            device=dst.device, dtype=dst.dtype)
            st.q_sum[:, slot].zero_()
            st.pre_q_sum[:, slot].zero_()

    # ------------------------------------------------------------- decode --

    @torn_guard
    def decode_step(self, tokens_in: np.ndarray, t: np.ndarray,
                    active: np.ndarray, page_table: np.ndarray,
                    rid: np.ndarray, temperature: np.ndarray,
                    sample_idx: np.ndarray, key) -> Any:
        """One fused step.  Fused sampling returns [S] int32 tokens (numpy);
        host sampling the [S, V] logits as a CPU tensor in the compute
        dtype, so tempered host sampling divides in that dtype."""
        dev = self.device
        if self._dirty:
            self._t_dev = torch.as_tensor(t, dtype=torch.int32, device=dev)
            self._pt_dev = torch.as_tensor(page_table, dtype=torch.int32,
                                           device=dev)
            self._ac_dev = torch.as_tensor(active, dtype=torch.bool,
                                           device=dev)
            self._dirty = False
        w = self.window
        due = None
        if self.cfg.attn.external_finalize:
            due = active & (t % w == 0) & (t // w > self.m_done)
            self.m_done = np.where(due, t // w, self.m_done)
        fused = self.ecfg.sample_device == "fused"
        sample = (rid, sample_idx, temperature, key) if fused else None
        with torch.inference_mode():
            out, self.states = tfm.lm_paged_decode_step(
                self.params, self.states,
                torch.as_tensor(tokens_in, dtype=torch.int32, device=dev),
                self._t_dev, self._pt_dev, self._ac_dev, self.cfg, due=due,
                sample=sample)
            self._t_dev = self._t_dev + self._ac_dev.to(torch.int32)
            self.decode_dispatches += 1
            return out.cpu().numpy() if fused else out.cpu()

    # -------------------------------------------------------- speculation --

    def draft_horizon(self, t: np.ndarray) -> np.ndarray:
        """Stop drafting short of the next landmark finalize, so that it can
        only fire at verify position 0 (which always commits): a rejected
        draft then never needs a landmark/expert/``m_done`` rollback, and
        every speculative append stays inside the slot's current page.
        With ``r = t % window``: external finalize fires when a position
        hits a window boundary; inline finalize fires one position earlier
        (it closes window ``(t+1) // w`` after the append), so at
        ``r == w - 1`` the round degenerates to plain decode."""
        r = np.asarray(t) % self.window
        if self.cfg.attn.external_finalize:
            return np.where(r != 0, self.window - r - 1, self.window - 1)
        return np.where(r < self.window - 1, self.window - 2 - r, 0)

    @torn_guard
    def draft_steps(self, tokens_in: np.ndarray, t: np.ndarray,
                    active: np.ndarray, page_table: np.ndarray,
                    rid: np.ndarray, temperature: np.ndarray,
                    sample_idx: np.ndarray, key,
                    spec_len: np.ndarray) -> np.ndarray:
        """Drafts [n, S] against the finalised landmark tiles only (the page
        table is unused), n = the longest ``spec_len`` of an active slot
        (<= spec_k; no forward at all when it is 0).  The landmark count
        is frozen at the round's start: the host ``m_done`` in external
        mode (the position-0 finalize lands in the verify step), ``t // w``
        inline."""
        dev = self.device
        ac = np.asarray(active) & (np.asarray(spec_len) > 0)
        n_pos = int(np.asarray(spec_len)[ac].max(initial=0))
        if n_pos == 0:
            return np.zeros((0, len(ac)), np.int32)
        m_cnt = (self.m_done.copy() if self.cfg.attn.external_finalize
                 else np.asarray(t) // self.window)
        with torch.inference_mode():
            drafts = tfm.lm_landmark_draft(
                self.params, self.states,
                torch.as_tensor(tokens_in, dtype=torch.int32, device=dev),
                torch.as_tensor(t, dtype=torch.int32, device=dev), ac,
                torch.as_tensor(m_cnt, dtype=torch.int32, device=dev),
                self.cfg, n_pos, rid, sample_idx, temperature, key)
        self.decode_dispatches += 1
        return drafts.cpu().numpy()

    @torn_guard
    def verify_step(self, tokens_in: np.ndarray, t: np.ndarray,
                    active: np.ndarray, page_table: np.ndarray,
                    rid: np.ndarray, temperature: np.ndarray,
                    sample_idx: np.ndarray, key, spec_len: np.ndarray,
                    drafts: np.ndarray) -> np.ndarray:
        """Teacher-forced verify: the exact fused decode step (finalize,
        kernels and sampling included) over the positions [input,
        drafts...], one `lm_paged_decode_step` call per position at the
        same slot batch, so its streams are those of plain decode.  At
        position ``i`` only slots with ``i <= spec_len`` are active, and
        only they advance ``t`` and the sample index.  Positions past
        every slot's ``spec_len`` are skipped: they change no state and
        their tokens are never committed.  A copy of ``q_sum`` is kept
        after every position for `rollback` (the pools update in place,
        so a view would be overwritten).  Returns tokens [n, S], n <=
        spec_k + 1."""
        dev = self.device
        t = np.asarray(t).astype(np.int32)
        active = np.asarray(active, bool)
        spec_len = np.asarray(spec_len)
        si = np.asarray(sample_idx).astype(np.int32)
        w = self.window
        m_done = self.m_done.copy()
        toks = np.concatenate([np.asarray(tokens_in, np.int32)[None],
                               np.asarray(drafts, np.int32)], 0)
        n_pos = int(spec_len[active].max(initial=0)) + 1
        pt = torch.as_tensor(page_table, dtype=torch.int32, device=dev)
        out, q_stack = [], []
        with torch.inference_mode():
            for i in range(n_pos):
                ac_i = active & (i <= spec_len)
                due = None
                if self.cfg.attn.external_finalize:
                    due = ac_i & (t % w == 0) & (t // w > m_done)
                    m_done = np.where(due, t // w, m_done)
                tok_i, self.states = tfm.lm_paged_decode_step(
                    self.params, self.states,
                    torch.as_tensor(toks[i], device=dev),
                    torch.as_tensor(t, device=dev), pt,
                    torch.as_tensor(ac_i, device=dev), self.cfg, due=due,
                    sample=(rid, si, temperature, key))
                out.append(tok_i)
                q_stack.append(self.states.q_sum.clone())
                t = t + ac_i
                si = si + ac_i
            self.m_done = m_done
            self._q_stack = torch.stack(q_stack)   # [n, L, S, Hkv, d]
            self.decode_dispatches += 1
            return torch.stack(out).cpu().numpy()

    def rollback(self, commits: np.ndarray, active: np.ndarray) -> None:
        """Rewind the running query sums to the copy taken after the last
        committed verify position: ``q_stack[commits - 1]`` per slot
        (commits >= 1; inactive slots pass 1, whose copy equals their
        untouched sums since the verify steps mask them)."""
        commits = np.where(np.asarray(active), np.asarray(commits), 1)
        idx = torch.as_tensor(commits - 1, dtype=torch.int64,
                              device=self.device)
        with torch.inference_mode():
            slots = torch.arange(len(commits), device=self.device)
            picked = self._q_stack[idx, :, slots]      # [S, L, Hkv, d]
            self.states.q_sum.copy_(picked.transpose(0, 1))
        self._q_stack = None

    # ------------------------------------------------------------- oracle --

    def static_reference(self, prompts: np.ndarray, max_new: int,
                         temperature: float = 0.0,
                         rids: Optional[list[int]] = None,
                         sample_key=None) -> np.ndarray:
        """Static fixed-batch baseline at the slot capacity — the oracle
        the engine's tokens are held to.  Greedy delegates to
        `launch.serve.static_generate`; ``temperature`` > 0 drives the same
        static steps one by one but samples with the engine's
        (rid, index)-keyed host rule (`serve.backends.sample_host`, key
        ``sample_key``, default ``PRNGKey(0)``)."""
        from repro_torch.launch.serve import static_generate
        capacity = self.ecfg.pages_per_slot * self.window
        toks = torch.as_tensor(prompts, dtype=torch.int32, device=self.device)
        if temperature <= 0.0:
            with torch.inference_mode():
                gen, _ = static_generate(self.params, self.cfg, toks,
                                         max_new, capacity=capacity)
            return gen
        if sample_key is None:
            sample_key = prng.PRNGKey(0)
        b, n = prompts.shape
        rids = list(rids) if rids is not None else list(range(b))
        w = self.window
        cap = mdec.window_aligned(capacity, w)
        with torch.inference_mode():
            logits, states = tfm.lm_prefill(self.params, toks, self.cfg, cap)
            logits = logits.cpu()
            out = [[sample_host(logits[row], rids[row], 0, temperature,
                                sample_key)] for row in range(b)]
            m_done = n // w
            for i in range(1, max_new):
                pos = n + i - 1
                if self.cfg.attn.external_finalize and pos % w == 0 \
                        and pos // w > m_done:
                    states = tfm.lm_finalize_states(states, self.cfg)
                    m_done = pos // w
                tok = torch.as_tensor([o[-1] for o in out], dtype=torch.int32,
                                      device=self.device)
                logits, states = tfm.lm_decode_step(self.params, states, tok,
                                                    pos, self.cfg)
                logits = logits.cpu()
                for row in range(b):
                    out[row].append(sample_host(logits[row], rids[row], i,
                                                temperature, sample_key))
        return np.asarray(out, np.int32)
