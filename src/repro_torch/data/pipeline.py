"""Deterministic, host-sharded, stateless-resumable data pipeline (port of
``repro.data.pipeline``; numpy only, equal to the reference array for
array).

  * **Stateless resumability** -- a batch is a pure function of (seed,
    step, host_index): restart-from-checkpoint needs only the step
    counter, no iterator state.
  * **Host sharding** -- each host materializes only its slice of the
    global batch (``host_index / host_count``).
  * **Structured synthetic text** -- a Zipf-Markov stream with realistic
    token statistics, learnable, so loss curves fall.
  * **Prefetch** -- `SyntheticLMStream` keeps ``prefetch`` batches ready
    in a background thread.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Iterator

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int = 1024
    seq_len: int = 256
    global_batch: int = 8
    seed: int = 0
    host_index: int = 0
    host_count: int = 1
    prefetch: int = 2


def _rng_for(cfg: DataConfig, step: int) -> np.random.Generator:
    return np.random.Generator(np.random.Philox(
        key=cfg.seed, counter=np.array([0, 0, 0, step], dtype=np.uint64)))


def synthetic_batch(cfg: DataConfig, step: int) -> dict[str, np.ndarray]:
    """Markov-Zipf token stream; deterministic in (seed, step, host)."""
    rng = _rng_for(cfg, step)
    if cfg.global_batch % cfg.host_count:
        raise ValueError("global_batch must divide by host_count")
    local_b = cfg.global_batch // cfg.host_count
    all_tokens = _markov_zipf(rng, cfg.global_batch, cfg.seq_len + 1,
                              cfg.vocab)
    lo = cfg.host_index * local_b
    tokens = all_tokens[lo: lo + local_b]
    return {"tokens": tokens[:, :-1].astype(np.int32),
            "labels": tokens[:, 1:].astype(np.int32)}


def _markov_zipf(rng, b: int, n: int, vocab: int) -> np.ndarray:
    """Cheap structured stream: next token = f(prev) with Zipf-ish mixing."""
    base = rng.zipf(1.5, size=(b, n)).astype(np.int64)
    drift = np.cumsum(rng.integers(0, 7, size=(b, n)), axis=1)
    return ((base + drift) % vocab).astype(np.int64)


def synthetic_image_embeds(cfg: DataConfig, step: int, n_patches: int,
                           d_model: int) -> np.ndarray:
    """[local_b, n_patches, d_model] float32 normal image embeddings."""
    rng = _rng_for(cfg, step + 1_000_003)
    local_b = cfg.global_batch // cfg.host_count
    return rng.standard_normal((local_b, n_patches, d_model),
                               dtype=np.float32)


def synthetic_audio_embeds(cfg: DataConfig, step: int, t_enc: int,
                           d_model: int) -> np.ndarray:
    """[local_b, t_enc, d_model] float32 frames, smoothed over time by a
    width-5 box filter ("spectrogram-like")."""
    rng = _rng_for(cfg, step + 2_000_003)
    local_b = cfg.global_batch // cfg.host_count
    x = rng.standard_normal((local_b, t_enc, d_model), dtype=np.float32)
    kernel = np.ones(5, dtype=np.float32) / 5.0
    return np.apply_along_axis(
        lambda r: np.convolve(r, kernel, mode="same"), 1, x)


class SyntheticLMStream:
    """Prefetching iterator over `synthetic_batch`, resumable at any step:
    yields (step, batch).  `close` stops and joins the worker thread."""

    def __init__(self, cfg: DataConfig, start_step: int = 0):
        self.cfg = cfg
        self._step = start_step
        self._q: queue.Queue = queue.Queue(maxsize=max(1, cfg.prefetch))
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        step = self._step
        while not self._stop.is_set():
            batch = synthetic_batch(self.cfg, step)
            while not self._stop.is_set():
                try:
                    self._q.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def __iter__(self) -> Iterator[tuple[int, dict]]:
        return self

    def __next__(self):
        return self._q.get()

    def close(self):
        self._stop.set()
        self._thread.join(timeout=2)
