"""skeletondiffusion_tpu_torch: the PyTorch/CUDA port of ``skeletondiffusion_tpu``
for one NVIDIA H100.

It covers the fp32 prediction path so far: observation → past embedding
(graph-GRU encoder) → 50-sample fan-out → nonisotropic ancestral sampling
(plain denoiser, hand-written CUDA posterior step) → 120-step graph-GRU decode
(hand-written CUDA rollout) → metric space.  Entry points take an explicit
``device`` (default ``"cuda"``); the CPU runs each kernel's plain PyTorch
version and is what the parity tests use.

The package imports ``torch`` and ``numpy`` only — never ``jax`` and nothing of
``skeletondiffusion_tpu``.
"""
