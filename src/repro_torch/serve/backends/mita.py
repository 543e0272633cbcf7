"""Paged MiTA serving backend (port of ``repro.serve.backends.mita``).

Owns the stacked per-layer paged pools (`core.mita_decode.PagedMiTAState`),
the per-slot finalised-landmark count ``m_done`` and the device copies of
the scheduler tensors.  Per engine step it runs at most:

  * `prefill_group`  — monolithic prefill of an admission group, packed
    into the group's slots and pages (``prefill_chunk`` = 0);
  * `prefill_chunks` — one chunk for every prefilling slot in one call
    (batched chunked prefill: the chunk-prefill CUDA kernel on the card);
  * `decode_step`    — one fused step for the whole slot batch; in external
    finalize mode the window-boundary finalize runs inside it for the
    slots that are due, decided on the host (``due`` is known there) so
    no layer waits on a device flag.

All of it runs under ``torch.inference_mode``.  The pools update in place.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.core import mita_decode as mdec
from repro_torch.kernels.ops import default_block_q
from repro_torch.models import transformer as tfm
from repro_torch.models.modules import ModelConfig
from repro_torch.serve.backends import BackendBase


def _params_device(params) -> torch.device:
    leaf = params
    while isinstance(leaf, dict):
        leaf = next(iter(leaf.values()))
    return leaf.device


class MiTABackend(BackendBase):
    """Paged MiTA decode caches behind the `DecodeBackend` protocol."""

    name = "mita"
    supports_prefix_cache = True

    def __init__(self, params: Any, cfg: ModelConfig, ecfg: Any,
                 device=None):
        super().__init__(params, cfg, ecfg)
        if cfg.attn.backend not in ("mita", "mita_ref"):
            raise ValueError("MiTABackend drives MiTA decode caches "
                             f"(got attention backend {cfg.attn.backend!r})")
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

    # ------------------------------------------------------------ sizing --

    def chunkable(self, n_train: int, batched: bool) -> bool:
        """The batched chunk program serves any prompt (the n//m landmark
        quirk is per-slot data); the per-job program (not ported) would
        need window-aligned prompts."""
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
            return logits.float().cpu().numpy()

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
            return logits.float().cpu().numpy()

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

    def decode_step(self, tokens_in: np.ndarray, t: np.ndarray,
                    active: np.ndarray, page_table: np.ndarray,
                    rid: np.ndarray, temperature: np.ndarray,
                    sample_idx: np.ndarray) -> np.ndarray:
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
        with torch.inference_mode():
            out, self.states = tfm.lm_paged_decode_step(
                self.params, self.states,
                torch.as_tensor(tokens_in, dtype=torch.int32, device=dev),
                self._t_dev, self._pt_dev, self._ac_dev, self.cfg, due=due,
                temperature=temperature if fused else None)
            self._t_dev = self._t_dev + self._ac_dev.to(torch.int32)
            self.decode_dispatches += 1
            return (out.cpu().numpy() if fused
                    else out.float().cpu().numpy())

    # ------------------------------------------------------------- oracle --

    def static_reference(self, prompts: np.ndarray, max_new: int,
                         temperature: float = 0.0,
                         rids: Optional[list[int]] = None) -> np.ndarray:
        """Static fixed-batch baseline at the slot capacity — the oracle
        the engine's greedy tokens are held to."""
        from repro_torch.launch.serve import static_generate
        capacity = self.ecfg.pages_per_slot * self.window
        with torch.inference_mode():
            gen, _ = static_generate(
                self.params, self.cfg,
                torch.as_tensor(prompts, dtype=torch.int32,
                                device=self.device),
                max_new, temperature=temperature, capacity=capacity)
        return gen
