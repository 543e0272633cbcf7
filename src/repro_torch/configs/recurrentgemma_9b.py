"""recurrentgemma-9b — RG-LRU + local attention, 2:1 [arXiv:2402.19427;
unverified].  MQA (kv = 1), head dim 4096 / 16 = 256.

13 super-blocks of (RG-LRU, RG-LRU, attention) = 39 layers against the
published 38 (the 2:1 pattern does not tile 38).  MiTA replaces the local
attention layers; the RG-LRU layers are attention-free."""

from repro_torch.configs.registry import ArchConfig, production_dtypes
from repro_torch.models.modules import AttnConfig, ModelConfig

ARCH = ArchConfig(
    arch_id="recurrentgemma-9b",
    family="hybrid",
    model=production_dtypes(ModelConfig(
        name="recurrentgemma-9b",
        n_layers=39, d_model=4096, n_heads=16, n_kv=1,
        d_ff=12288, vocab=256000, rope_theta=1e4,
        attn=AttnConfig(backend="mita", window=128, k=128, s=1,
                        local_window=2048),
    )),
)
