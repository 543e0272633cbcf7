"""Optimizer (port of ``repro.optim``): AdamW with a cosine schedule."""

from repro_torch.optim.adamw import (AdamWState, OptConfig, adamw_init,
                                     adamw_update, adamw_update_,
                                     clip_by_global_norm, cosine_schedule,
                                     global_norm)

__all__ = ["AdamWState", "OptConfig", "adamw_init", "adamw_update",
           "adamw_update_", "clip_by_global_norm", "cosine_schedule",
           "global_norm"]
