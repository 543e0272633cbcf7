"""Fault tolerance (port of ``repro.distributed``): the step timer that
the serving supervisor shares with the training harness."""

from repro_torch.distributed.fault_tolerance import StepTimer

__all__ = ["StepTimer"]
