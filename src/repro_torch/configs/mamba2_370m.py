"""mamba2-370m — SSD (state-space duality) [arXiv:2405.21060; unverified].
Attention-free: MiTA does not apply; the SSD state is the taxonomy's
compressed fast-weight module.  d_inner = 2 * d_model, 64-dim heads,
ssm_state = 128."""

from repro_torch.configs.registry import ArchConfig, production_dtypes
from repro_torch.models.modules import AttnConfig, ModelConfig

ARCH = ArchConfig(
    arch_id="mamba2-370m",
    family="ssm",
    model=production_dtypes(ModelConfig(
        name="mamba2-370m",
        n_layers=48, d_model=1024, n_heads=32, n_kv=32,
        d_ff=0, vocab=50280,
        attn=AttnConfig(backend="full"),  # unused (attention-free)
    )),
)
