"""Model configuration: the subset of genconvit_tpu/config.py the scoring
path reads, as plain dataclasses (no yaml)."""

from __future__ import annotations

import dataclasses

_DEFAULT_IMG_SIZE = 224
_DEFAULT_LATENT = 12544  # == 256 * (224 // 32) ** 2 (ref model/genconvit_vae.py:83)


@dataclasses.dataclass
class ModelConfig:
    backbone: str = "convnext_tiny"
    latent_dims: int = _DEFAULT_LATENT


@dataclasses.dataclass
class Config:
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    num_classes: int = 2
    img_size: int = _DEFAULT_IMG_SIZE

    def derived_latent_dims(self) -> int:
        """latent_dims consistent with the VAE decoder's (256, s, s)
        unflatten, s = img_size // 32; used when img_size != 224."""
        s = self.img_size // 32
        return 256 * s * s

    def vae_latent_dims(self) -> int:
        """Width of the VAE mu/var heads: the explicit latent_dims at 224 px,
        the derived one otherwise (genconvit_tpu/models/genconvit.py:28-40)."""
        return (self.model.latent_dims if self.img_size == 224
                else self.derived_latent_dims())
