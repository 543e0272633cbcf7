"""deepseek-moe-16b — fine-grained MoE, 2 shared + 64 routed top-6
[arXiv:2401.06066; hf].  (Deviation: the reference model's first layer is a
dense FFN; here all layers are MoE — recorded in DESIGN.md.)"""

from repro_torch.configs.registry import ArchConfig, production_dtypes
from repro_torch.models.modules import AttnConfig, ModelConfig

ARCH = ArchConfig(
    arch_id="deepseek-moe-16b",
    family="moe",
    model=production_dtypes(ModelConfig(
        name="deepseek-moe-16b",
        n_layers=28, d_model=2048, n_heads=16, n_kv=16,
        d_ff=1408, vocab=102400, rope_theta=1e4,
        n_experts=64, moe_top_k=6, n_shared_experts=2,
        attn=AttnConfig(backend="mita", window=128, k=128, s=1),
    )),
)
