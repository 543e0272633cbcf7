"""Continuous-batching serving (port of ``repro.serve``).

  * `Request` / `FinishedRequest`, `EngineConfig` and `ServingEngine` —
    the scheduler, its knobs and its request types;
  * `backends` — the `DecodeBackend` protocol, the paged MiTA backend and
    the recurrent ones (Mamba2, RG-LRU);
  * `Supervisor` / `SupervisorConfig` — fault isolation around the
    engine: retry with backoff, per-slot quarantine, the degradation
    ladder, straggler detection and snapshot / restore crash recovery
    (`serve.supervisor`);
  * `ChaosBackend` / `ChaosConfig` / `InjectedFault` — the seeded fault
    injector that drives every one of those paths (`serve.chaos`);
  * `AllocatorInvariantError` — page-accounting corruption; never
    retried, never shed.
"""

from repro_torch.serve import backends
from repro_torch.serve.chaos import ChaosBackend, ChaosConfig, InjectedFault
from repro_torch.serve.engine import (AllocatorInvariantError, EngineConfig,
                                      FinishedRequest, Request,
                                      ServingEngine)
from repro_torch.serve.supervisor import (DEGRADATION_RUNGS, Supervisor,
                                          SupervisorConfig,
                                          SupervisionExhausted)

__all__ = ["AllocatorInvariantError", "ChaosBackend", "ChaosConfig",
           "DEGRADATION_RUNGS", "EngineConfig", "FinishedRequest",
           "InjectedFault", "Request", "ServingEngine", "Supervisor",
           "SupervisorConfig", "SupervisionExhausted", "backends"]
