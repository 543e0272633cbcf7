"""qwen3-32b — qk_norm, GQA [hf:Qwen/Qwen3-8B; hf].  head_dim=128."""

from repro_torch.configs.registry import ArchConfig, production_dtypes
from repro_torch.models.modules import AttnConfig, ModelConfig

ARCH = ArchConfig(
    arch_id="qwen3-32b",
    family="dense",
    model=production_dtypes(ModelConfig(
        name="qwen3-32b",
        n_layers=64, d_model=5120, n_heads=64, n_kv=8, head_dim=128,
        d_ff=25600, vocab=151936, rope_theta=1e6, qk_norm=True,
        attn=AttnConfig(backend="mita", window=128, k=128, s=1),
    )),
)
