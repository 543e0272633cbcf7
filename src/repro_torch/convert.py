"""Carry weights and decode states from the JAX package to the port.

The input is what ``jax.device_get`` returns: nested dicts / NamedTuples
of numpy arrays.  This module imports numpy and torch only.  Layouts and
dtypes are kept leaf for leaf (stacked layer axis 0, [S, Hkv, G, d],
pools [R + 1, Hkv, d]); bfloat16 arrays (``ml_dtypes``) are reinterpreted
bit for bit.  Parameter trees of every ported family (the LM's
``blocks``, mamba2's ``blocks``, the hybrid's stacked ``supers``) go
through `params_from_jax`; the recurrent families' slot states through
`mamba_state_from_jax` and `rg_state_from_jax`; whisper's decoder state
through `whisper_state_from_jax`.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.core.mita_decode import (FullDecodeState, MiTADecodeState,
                                         PagedMiTAState)
from repro_torch.models.mamba2 import MambaState
from repro_torch.models.rglru import RGLRUState, RGSuperState
from repro_torch.models.whisper import WhisperDecState


def array_to_torch(a, device="cpu") -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.uint16).copy())
        return t.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.ascontiguousarray(a).copy()).to(device)


def tensor_to_numpy(t: torch.Tensor) -> np.ndarray:
    """float32 numpy for bfloat16 tensors (numpy has no bfloat16), the
    tensor's own dtype otherwise."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()


def params_from_jax(tree: Any, device="cpu") -> Any:
    """JAX param pytree (numpy leaves) -> the same nesting of tensors."""
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device) for k, v in tree.items()}
    return array_to_torch(tree, device)


def _state(cls, st, device):
    return cls(*(array_to_torch(getattr(st, f), device) for f in cls._fields))


def paged_state_from_jax(st, device="cpu") -> PagedMiTAState:
    """A (possibly layer-stacked) JAX ``PagedMiTAState``."""
    return _state(PagedMiTAState, st, device)


def decode_state_from_jax(st, device="cpu") -> MiTADecodeState:
    """A (possibly layer-stacked) JAX ``MiTADecodeState``."""
    return _state(MiTADecodeState, st, device)


def full_state_from_jax(st, device="cpu") -> FullDecodeState:
    return _state(FullDecodeState, st, device)


def mamba_state_from_jax(st, device="cpu") -> MambaState:
    """A (layer-stacked) JAX ``MambaState``."""
    return _state(MambaState, st, device)


def rg_state_from_jax(st, device="cpu") -> RGSuperState:
    """A (super-block-stacked) JAX ``RGSuperState``: two RG-LRU states and
    the attention layer's MiTA or full-attention cache (slot form)."""
    attn = (MiTADecodeState if hasattr(st.attn, "lm_q")
            else FullDecodeState)
    return RGSuperState(rec1=_state(RGLRUState, st.rec1, device),
                        rec2=_state(RGLRUState, st.rec2, device),
                        attn=_state(attn, st.attn, device))


def whisper_state_from_jax(st, device="cpu") -> WhisperDecState:
    """A JAX ``WhisperDecState``: the layer-stacked self-attention caches
    (MiTA or full attention) and the cross K/V.  Each layer gets its own
    storage, where the reference's layers may share one broadcast
    array."""
    cls = (MiTADecodeState if hasattr(st.self_state, "lm_q")
           else FullDecodeState)
    return WhisperDecState(self_state=_state(cls, st.self_state, device),
                           xk=array_to_torch(st.xk, device),
                           xv=array_to_torch(st.xv, device))


def to_numpy(tree: Any) -> Any:
    """Tensors (in dicts / tuples / NamedTuples) -> numpy, for comparing
    with the reference."""
    if isinstance(tree, torch.Tensor):
        return tensor_to_numpy(tree)
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(to_numpy(x) for x in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_numpy(x) for x in tree)
    return tree
