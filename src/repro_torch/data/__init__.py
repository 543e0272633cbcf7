"""Data (port of ``repro.data``)."""

from repro_torch.data.pipeline import (DataConfig, SyntheticLMStream,
                                       synthetic_audio_embeds,
                                       synthetic_batch,
                                       synthetic_image_embeds)

__all__ = ["DataConfig", "SyntheticLMStream", "synthetic_audio_embeds",
           "synthetic_batch", "synthetic_image_embeds"]
