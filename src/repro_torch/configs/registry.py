"""Architecture registry (port of ``repro.configs.registry``).

Only the configurations the port serves are ported: the dense qwen3-0.6b,
tinyllama-1.1b (head dim 64, 32 heads over 4 KV heads), stablelm-1.6b
(head dim 64, MHA) and qwen3-32b (held to the reference at the smoke size
only: its float32 weights do not fit one card), the moe deepseek-moe-16b
(full size on one card) and dbrx-132b (smoke size only), the vlm
internvl2-76b's LM backbone (smoke size only), the ssm mamba2-370m, the
hybrid recurrentgemma-9b and the encdec whisper-tiny (driven through
`models.whisper`; it has no serving backend).  Each lives in its own
module (``repro_torch.configs.<id>``, dashes -> underscores) exporting
``ARCH``.
``ARCHS`` lists the ten in the reference's order, `get_arch` loads one
(``backend=`` overrides its attention backend, as the reference's does),
`arch_params` builds any of them, ``smoke_variant`` is the reduced
same-family config the CPU tests use.  ``SHAPES`` is the reference's grid
of input shapes (the cells of `launch.steps.build_cell`), and
`ArchConfig.shape_supported` its applicability policy.
"""

from __future__ import annotations

import dataclasses
import importlib

import torch

from repro_torch.models.modules import ModelConfig

ARCHS = [
    "internvl2-76b", "deepseek-moe-16b", "dbrx-132b", "tinyllama-1.1b",
    "qwen3-0.6b", "qwen3-32b", "stablelm-1.6b", "recurrentgemma-9b",
    "mamba2-370m", "whisper-tiny",
]


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str        # train | prefill | decode
    seq: int
    batch: int


SHAPES = {
    "train_4k": ShapeSpec("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524_288, 1),
}


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    arch_id: str
    family: str                     # dense | moe | vlm | ssm | hybrid | encdec
    model: ModelConfig
    n_img_tokens: int = 0           # vlm: embeddings over the first P
    t_enc: int = 0                  # encdec: encoder frames (whisper: 1500)
    dec_len: int = 0                # encdec: decoder length (whisper: 448)
    notes: str = ""

    def shape_supported(self, shape: ShapeSpec) -> tuple[bool, str]:
        """(supported, note) of the reference's shape policy: whisper has
        no 500k decode, and decodes at its native 448 where a decode
        shape asks for more."""
        if self.family == "encdec":
            if shape.name == "long_500k":
                return False, ("whisper decoder max context is 448 by "
                               "construction; 500k decode is not defined "
                               "for this family (DESIGN.md)")
            if shape.kind == "decode":
                return True, ("substituted: decoder-native decode (cap 448) "
                              "with a 32k-scale encoder memory is not "
                              "defined either; we lower native decode")
        return True, ""


def get_arch(arch_id: str, *, smoke: bool = False,
             backend: str | None = None) -> ArchConfig:
    try:
        mod = importlib.import_module(
            "repro_torch.configs."
            + arch_id.replace("-", "_").replace(".", "_"))
    except ModuleNotFoundError as e:
        raise ValueError(f"architecture {arch_id!r} is not ported") from e
    arch: ArchConfig = mod.ARCH
    if smoke:
        arch = smoke_variant(arch)
    if backend is not None:
        arch = dataclasses.replace(
            arch, model=dataclasses.replace(
                arch.model,
                attn=dataclasses.replace(arch.model.attn, backend=backend)))
    return arch


def arch_params(arch: ArchConfig, gen: torch.Generator, device="cuda"):
    """Random parameters of ``arch``, drawn from ``gen``: the one place a
    family resolves to its init function."""
    if arch.family in ("dense", "moe", "vlm"):
        from repro_torch.models import transformer as tfm
        return tfm.lm_init(gen, arch.model, device)
    if arch.family == "ssm":
        from repro_torch.models.mamba2 import mamba_init
        return mamba_init(gen, arch.model, device)
    if arch.family == "hybrid":
        from repro_torch.models.rglru import rg_init
        return rg_init(gen, arch.model, device)
    raise ValueError(f"family {arch.family!r} has no servable parameter "
                     "constructor (whisper's enc-dec model is built by "
                     "models.whisper.whisper_init)")


def production_dtypes(cfg: ModelConfig) -> ModelConfig:
    return dataclasses.replace(cfg, param_dtype=torch.float32,
                               compute_dtype=torch.bfloat16, remat=True)


def smoke_variant(arch: ArchConfig) -> ArchConfig:
    """Reduced same-family config: small widths/depth/vocab, f32, no
    remat."""
    m = arch.model
    sm = dataclasses.replace(
        m,
        n_layers=min(m.n_layers, 6 if arch.family == "hybrid" else 2),
        d_model=128,
        n_heads=4,
        n_kv=max(1, min(m.n_kv, 2 if m.n_kv < m.n_heads else 4)),
        head_dim=32,
        d_ff=64 if m.n_experts else 256,
        vocab=251,
        n_experts=min(m.n_experts, 8),
        moe_top_k=min(m.moe_top_k, 2),
        n_shared_experts=min(m.n_shared_experts, 1),
        attn=dataclasses.replace(m.attn, window=16, k=16, block_q=16,
                                 enc_window=16 if m.attn.enc_window else 0),
        param_dtype=torch.float32,
        compute_dtype=torch.float32,
        remat=False,
    )
    return dataclasses.replace(arch, model=sm,
                               n_img_tokens=min(arch.n_img_tokens, 16),
                               t_enc=min(arch.t_enc, 64),
                               dec_len=min(arch.dec_len, 32))
