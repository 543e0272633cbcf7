"""whisper-tiny — enc-dec, conv frontend stub [arXiv:2212.04356].

The input is precomputed frame embeddings [B, 1500, 384] (what the two
conv layers would produce).  MiTA runs bidirectionally in the encoder
(m = 25 landmarks over 1500 frames, encoder window 60) and causally in
the decoder (window 64 over its 448 positions); cross-attention stays
full.
"""

from repro_torch.configs.registry import ArchConfig, production_dtypes
from repro_torch.models.modules import AttnConfig, ModelConfig

ARCH = ArchConfig(
    arch_id="whisper-tiny",
    family="encdec",
    model=production_dtypes(ModelConfig(
        name="whisper-tiny",
        n_layers=4, d_model=384, n_heads=6, n_kv=6,
        d_ff=1536, vocab=51865, rope_theta=1e4,
        attn=AttnConfig(backend="mita", window=64, k=64, s=1,
                        enc_window=60),
    )),
    t_enc=1500,
    dec_len=448,
)
