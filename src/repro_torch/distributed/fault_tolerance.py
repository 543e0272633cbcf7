"""Straggler detection (port of ``repro.distributed.fault_tolerance``).

Only `StepTimer` is ported: the serving supervisor
(`repro_torch.serve.supervisor`) times every engine step with it.  The
reference's checkpoint/restart loop (``run_with_restarts``) needs a
checkpoint manager and waits for the training slice.

The timer is host code and adds no device sync: on the card an engine
step already ends in one (its tokens come back as numpy), so its wall
time is the step's real time.
"""

from __future__ import annotations

import time
from typing import Optional


class StepTimer:
    """EWMA step timer with straggler detection.

    A step slower than ``threshold`` x the EWMA of the steps before it is
    a straggler; ``n_stragglers`` counts them."""

    def __init__(self, alpha: float = 0.1, threshold: float = 3.0):
        self.alpha = alpha
        self.threshold = threshold
        self.ewma: Optional[float] = None
        self._prev_ewma: Optional[float] = None   # EWMA before the last obs
        self.last: Optional[float] = None
        self._t0: Optional[float] = None
        self.n_stragglers = 0           # observations past the threshold

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.observe(time.perf_counter() - self._t0)
        return False

    def observe(self, dt: float):
        self.last = dt
        self._prev_ewma = self.ewma
        self.ewma = dt if self.ewma is None else \
            (1 - self.alpha) * self.ewma + self.alpha * dt
        if self.is_straggling:
            self.n_stragglers += 1

    @property
    def is_straggling(self) -> bool:
        """Compare the last step against the EWMA of *prior* steps — an
        outlier must not be allowed to raise its own baseline."""
        return (self._prev_ewma is not None and self.last is not None
                and self.last > self.threshold * self._prev_ewma)


__all__ = ["StepTimer"]
