"""stablelm-1.6b — [hf:stabilityai/stablelm-2-1_6b; unverified].  MHA
(kv == heads).  (Deviation: RMSNorm instead of LayerNorm — DESIGN.md.)"""

from repro_torch.configs.registry import ArchConfig, production_dtypes
from repro_torch.models.modules import AttnConfig, ModelConfig

ARCH = ArchConfig(
    arch_id="stablelm-1.6b",
    family="dense",
    model=production_dtypes(ModelConfig(
        name="stablelm-1.6b",
        n_layers=24, d_model=2048, n_heads=32, n_kv=32,
        d_ff=5632, vocab=100352, rope_theta=1e4,
        attn=AttnConfig(backend="mita", window=128, k=128, s=1),
    )),
)
