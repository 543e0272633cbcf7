"""Device defaults and numeric switches shared by the whole port.

* ``DEFAULT_DEVICE`` is ``"cuda"``: entry points run on the card unless a
  caller asks for the CPU explicitly (the tests do).
* TF32 is switched off when the package is imported, so float32 matrix
  products on the card stay full float32, as the JAX reference computes.
* `cpu_log_ready` works around a first-call inaccuracy of the CPU's
  ``torch.log``.
* `fma32` is a float32 fused multiply-add, for arithmetic that must round
  as the reference's fused code does.
* ``NEG_INF`` is the masking constant of the reference (``finfo(f32).min``,
  not ``-inf``): every masked logit carries it, and the ``where`` guards in
  `core.combine` turn ``exp(NEG_INF - m)`` into exact zeros.
"""

from __future__ import annotations

import functools

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


@functools.cache
def cpu_log_ready() -> bool:
    """On the CPU, torch.log takes float32 and float64 through MKL's vector
    math.  The first call in a process that splits over threads was seen
    to compute one thread's share less accurately (errors up to 1e-4), so
    two runs of the same computation in two processes could differ; a
    single-element call first avoids it.  Sampling (`prng.gumbel`) and
    training (`launch.steps.train_step`) call this before their logs."""
    for dt in (torch.float32, torch.float64):
        torch.log(torch.ones(1, dtype=dt))
    return True


def fma32(a: torch.Tensor, b, c) -> torch.Tensor:
    """float32 ``a * b + c`` rounded once, as a fused multiply-add (XLA's
    CPU code fuses a multiply into the add that consumes it; PyTorch
    rounds twice).  The product of two float32 is exact in float64, the
    float64 sum is rounded to odd (its last bit set where the sum was
    inexact), and round-to-odd at 53 bits followed by rounding to 24 bits
    is the correctly rounded result."""
    s = a.double() * torch.as_tensor(b, device=a.device).double()
    c = torch.as_tensor(c, device=a.device).double().expand_as(s)
    t = s + c
    bp = t - s
    err = (s - (t - bp)) + (c - bp)          # t + err == s + c exactly
    even = (t.view(torch.int64) & 1) == 0
    toward = torch.nextafter(t, torch.where(err > 0, torch.inf, -torch.inf))
    return torch.where((err != 0) & even, toward, t).float()
