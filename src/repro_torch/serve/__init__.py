"""Continuous-batching serving (port of ``repro.serve``): the engine, its
configuration and request types, and the `DecodeBackend` protocol."""

from repro_torch.serve import backends
from repro_torch.serve.engine import (AllocatorInvariantError, EngineConfig,
                                      FinishedRequest, Request,
                                      ServingEngine)

__all__ = ["AllocatorInvariantError", "EngineConfig", "FinishedRequest",
           "Request", "ServingEngine", "backends"]
