"""Two-stage training: the AutoEncoder with its prediction-horizon curriculum
(``trainer_autoencoder``), the nonisotropic latent diffusion with the k-best
relaxed objective (``trainer_diffusion``), their EMA, schedules and
checkpoints."""
