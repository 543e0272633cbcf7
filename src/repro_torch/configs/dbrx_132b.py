"""dbrx-132b — 16 experts top-4, fine-grained [hf:databricks/dbrx-base;
unverified].  Held to the reference at the smoke size only: its 131.6 B
float32 parameters do not fit one card."""

from repro_torch.configs.registry import ArchConfig, production_dtypes
from repro_torch.models.modules import AttnConfig, ModelConfig

ARCH = ArchConfig(
    arch_id="dbrx-132b",
    family="moe",
    model=production_dtypes(ModelConfig(
        name="dbrx-132b",
        n_layers=40, d_model=6144, n_heads=48, n_kv=8,
        d_ff=10752, vocab=100352, rope_theta=5e5,
        n_experts=16, moe_top_k=4, n_shared_experts=0,
        attn=AttnConfig(backend="mita", window=128, k=128, s=1),
    )),
)
