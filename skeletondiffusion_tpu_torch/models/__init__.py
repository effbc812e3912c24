"""The AutoEncoder and the Denoiser (plain PyTorch modules)."""
from .autoencoder import AutoEncoder
from .denoiser import Denoiser

__all__ = ["AutoEncoder", "Denoiser"]
