"""Distribution and fault tolerance (port of ``repro.distributed``): the
sharding rules, restart from a checkpoint, elastic re-placement onto
another mesh, and the step timer that the serving supervisor shares with
the training harness."""

from repro_torch.distributed.fault_tolerance import (StepTimer,
                                                     elastic_retarget,
                                                     run_with_restarts)

__all__ = ["StepTimer", "elastic_retarget", "run_with_restarts"]
