"""Restart-from-checkpoint and straggler detection (port of
``repro.distributed.fault_tolerance``).

  1. **Checkpoint/restart** -- `run_with_restarts` wraps the train loop:
     a step that raises restores the latest checkpoint (step 0's, which
     it writes first, before any other) and replays from there.  The data pipeline is stateless-resumable (`repro_torch.data`)
     and the training entry point runs deterministic algorithms on the
     card, so replayed steps are bit-identical.  In-process retry is for
     failures that leave the process sound.  A CUDA error that poisons
     the context (an illegal address, a device-side assert) fails every
     later call in the process, so every retry fails too, as ROADMAP
     C.12 says for serving: recovery from it is a new process that
     resumes from the checkpoint (``launch.train --resume``).
  2. **Straggler detection** -- `StepTimer` keeps an EWMA of step wall
     time; a step slower than ``threshold`` x the EWMA is a straggler.
     The serving supervisor (`repro_torch.serve.supervisor`) times every
     engine step with it, the train driver every train step.

The timer is host code and adds no device sync: an engine step already
ends in one (its tokens come back as numpy), and so does a train step
that reads its loss.

  3. **Elastic re-placement** -- `elastic_retarget` re-places a tree
     onto another mesh (fewer ranks after a failure, say).  It works
     because checkpoints hold full arrays and placements are derived from
     the tree's paths and shapes (`distributed.sharding.param_specs`),
     not stored with it.
"""

from __future__ import annotations

import logging
import time
from typing import Any, Callable, Optional

from torch.distributed.tensor import distribute_tensor

from repro_torch.checkpoint.manager import CheckpointManager, full_value
from repro_torch.distributed.sharding import (axis_sizes, map_with_path,
                                              placements, spec_for_param)

log = logging.getLogger("repro_torch.ft")


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


def run_with_restarts(step_fn: Callable[[int, Any], Any],
                      init_state: Any,
                      ckpt: CheckpointManager,
                      n_steps: int,
                      ckpt_every: int = 50,
                      max_restarts: int = 3) -> Any:
    """Drive ``step_fn(step, state) -> state`` with restart-on-failure.

    On exception: restore the latest checkpoint and replay from there.
    Where the directory holds none, ``init_state`` is saved as step 0
    first: a train step updates its parameters and moments in place
    (`launch.steps.train_step` donates them), so after a failure
    ``init_state`` holds a later, or half-updated, state.  Determinism of
    the data pipeline and of the step makes the replay exact.  Past
    ``max_restarts`` the exception propagates.
    """
    state = init_state
    start = 0
    latest = ckpt.latest_step()
    if latest is not None:
        start, state = ckpt.restore(state)
        log.info("resumed from step %d", start)
    else:
        ckpt.save(0, state)

    restarts = 0
    step = start
    while step < n_steps:
        try:
            state = step_fn(step, state)
            step += 1
            if step % ckpt_every == 0:
                ckpt.save(step, state)
        except Exception as e:  # noqa: BLE001 -- any step failure
            restarts += 1
            if restarts > max_restarts:
                raise
            log.warning("step %d failed (%s); restart %d/%d",
                        step, e, restarts, max_restarts)
            ckpt.wait()
            step, state = ckpt.restore(state)
    ckpt.wait()
    return state


def elastic_retarget(tree: Any, new_mesh) -> Any:
    """Re-place a tree onto ``new_mesh`` by the standard parameter rules:
    each leaf (a DTensor on any mesh, or a plain tensor holding the whole
    value) is gathered to its full value and every rank keeps its shard
    of it as ``param_specs(tree, new_mesh)`` places it.  Values stay
    bit-equal; nothing is sent but the gathers of DTensor leaves."""
    msize = axis_sizes(new_mesh).get("model", 1)

    def place(path, x):
        spec = spec_for_param(path, x.dim(), tuple(x.shape), msize)
        return distribute_tensor(full_value(x), new_mesh,
                                 placements(spec, new_mesh),
                                 src_data_rank=None)

    return map_with_path(place, tree)


__all__ = ["StepTimer", "run_with_restarts", "elastic_retarget"]
