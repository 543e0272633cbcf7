"""PyTorch port of the MiTA serving path (H100 / CUDA).

Mirrors the layout of the JAX package ``repro`` module for module, so each
port can be read beside its reference.  The package imports ``torch``,
numpy and the standard library only.  Entry points run on ``cuda`` unless
the caller passes ``device="cpu"``; on the card every kernel-backed
operation launches its hand-written CUDA kernel (``repro_torch/csrc``),
and on the CPU it runs the plain PyTorch version kept beside it.
"""

from repro_torch.device import DEFAULT_DEVICE, NEG_INF, resolve_device

__all__ = ["DEFAULT_DEVICE", "NEG_INF", "resolve_device"]
