"""Device defaults and numeric switches shared by the whole port.

* ``DEFAULT_DEVICE`` is ``"cuda"``: entry points run on the card unless a
  caller asks for the CPU explicitly (the tests do).
* TF32 is switched off when the package is imported, so float32 matrix
  products on the card stay full float32, as the JAX reference computes.
* ``NEG_INF`` is the masking constant of the reference (``finfo(f32).min``,
  not ``-inf``): every masked logit carries it, and the ``where`` guards in
  `core.combine` turn ``exp(NEG_INF - m)`` into exact zeros.
"""

from __future__ import annotations

import torch

DEFAULT_DEVICE = "cuda"
NEG_INF = float(torch.finfo(torch.float32).min)

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The device an entry point runs on: ``device`` or the default (cuda).
    Raises when cuda is asked for and no card is present — nothing falls
    back to the CPU silently."""
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but torch.cuda is not "
                           "available; pass device='cpu' to run on the CPU")
    return dev
