"""skeletondiffusion_tpu_torch: the PyTorch/CUDA port of ``skeletondiffusion_tpu``
for one NVIDIA H100.

It covers the prediction path, fp32 and bf16: observation → past embedding
(graph-GRU encoder) → 50-sample fan-out → nonisotropic ancestral sampling
(the denoiser plain in fp32 or as hand-written CUDA kernels in bf16, a
hand-written CUDA posterior step) → 120-step graph-GRU decode (hand-written
CUDA rollout) → metric space; and the evaluation path around it: the AMASS
test split and its loader (``data``), the metric suite (``metrics``) and
``eval_pipeline.compute_metrics``; and two-stage training (``train``: the
AutoEncoder with its horizon curriculum, the latent diffusion with the
k-best objective decoded on the rollout kernel, EMA, schedules,
checkpoints); and the entry points (``cli``: both training CLIs and the
eval CLI on ``configs/**``, read by ``utils/yaml_lite``; ``inference``).
Library entry points take an explicit
``device`` (default ``"cuda"``); the CPU runs each kernel's plain PyTorch
version and is what the parity tests use.

The package imports ``torch`` and ``numpy`` (and ``scipy`` for FID) — never
``jax``, ``flax``, ``optax``, ``orbax``, ``pandas`` or ``yaml``, and nothing
of ``skeletondiffusion_tpu``.
"""
