"""The port's entry points: ``python -m skeletondiffusion_tpu_torch.cli.train_autoencoder``,
``.train_diffusion`` and ``.eval``, each with ``key=value`` overrides of
``configs/**``."""
