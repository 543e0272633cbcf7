"""qwen3-0.6b — qk_norm, GQA [hf:Qwen/Qwen3-8B; hf].
head_dim=128 (Qwen3 uses a fixed 128 head dim, decoupled from d_model)."""

from repro_torch.configs.registry import ArchConfig, production_dtypes
from repro_torch.models.modules import AttnConfig, ModelConfig

ARCH = ArchConfig(
    arch_id="qwen3-0.6b",
    family="dense",
    model=production_dtypes(ModelConfig(
        name="qwen3-0.6b",
        n_layers=28, d_model=1024, n_heads=16, n_kv=8, head_dim=128,
        d_ff=3072, vocab=151936, rope_theta=1e6, qk_norm=True,
        tie_embeddings=True,
        attn=AttnConfig(backend="mita", window=128, k=128, s=1),
    )),
)
