"""internvl2-76b — InternViT + InternLM2 [arXiv:2404.16821; unverified].

VLM: the transformer BACKBONE only (InternLM2-70B-class decoder); the ViT
frontend is a stub: callers supply precomputed patch embeddings, which
overwrite the first ``n_img_tokens`` positions (`models.transformer`'s
``extra_embeds`` / ``image_embeds``).  Held to the reference at the smoke
size only: 76 B float32 parameters do not fit one card.
"""

from repro_torch.configs.registry import ArchConfig, production_dtypes
from repro_torch.models.modules import AttnConfig, ModelConfig

ARCH = ArchConfig(
    arch_id="internvl2-76b",
    family="vlm",
    model=production_dtypes(ModelConfig(
        name="internvl2-76b",
        n_layers=80, d_model=8192, n_heads=64, n_kv=8,
        d_ff=28672, vocab=128256, rope_theta=1e6,
        attn=AttnConfig(backend="mita", window=128, k=128, s=1),
    )),
    n_img_tokens=256,
)
