"""Fault tolerance (port of ``repro.distributed``): restart from a
checkpoint, and the step timer that the serving supervisor shares with the
training harness."""

from repro_torch.distributed.fault_tolerance import (StepTimer,
                                                     run_with_restarts)

__all__ = ["StepTimer", "run_with_restarts"]
