"""Deterministic synthetic token stream (port of the numpy-only part of
``repro.data.pipeline``): a batch is a pure function of (seed, step,
host_index), a Zipf-Markov stream with realistic token statistics."""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int = 1024
    seq_len: int = 256
    global_batch: int = 8
    seed: int = 0
    host_index: int = 0
    host_count: int = 1


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
