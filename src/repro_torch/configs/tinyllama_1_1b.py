"""tinyllama-1.1b — llama2-arch small [arXiv:2401.02385; hf]."""

from repro_torch.configs.registry import ArchConfig, production_dtypes
from repro_torch.models.modules import AttnConfig, ModelConfig

ARCH = ArchConfig(
    arch_id="tinyllama-1.1b",
    family="dense",
    model=production_dtypes(ModelConfig(
        name="tinyllama-1.1b",
        n_layers=22, d_model=2048, n_heads=32, n_kv=4,
        d_ff=5632, vocab=32000, rope_theta=1e4,
        attn=AttnConfig(backend="mita", window=128, k=128, s=1),
    )),
)
