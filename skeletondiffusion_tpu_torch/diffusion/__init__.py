"""Nonisotropic latent diffusion: covariance, schedules, process tables,
the sampling engine and its factory."""
