"""One reverse-diffusion posterior update, fused into one CUDA kernel.

For the flagship sampler (pred_x0, clip_denoised, identity activation,
nonisotropic process) everything after the denoiser is

    x_{t-1} = P1_t·clip(x̂₀,−1,1) + P2_t·x_t + (U·diag σ_t)·ε

with ``m_t = [P1_t | P2_t | Uσ_t]`` from
``NonisotropicProcess.posterior_step_tables`` (noise block zero at t=0),
applied to node-major latents ``[N, B, D]``.  Port of
``skeletondiffusion_tpu/ops/pallas/posterior_step.py::posterior_step_pallas``
without the TPU's 128-lane feature padding; the kernel is
``csrc/posterior_step.cu``.  x̂₀ may be float32 or, as the fused bf16 denoiser
emits it, bfloat16: the second C entry reads it in bf16 and widens it in the
kernel; x_t, the noise and the output are float32 either way.
"""
from __future__ import annotations

import torch

from . import build

launches = 0           # the float32-x̂₀ entry
launches_x0_bf16 = 0   # the bfloat16-x̂₀ entry


def posterior_step_plain(x0: torch.Tensor, xt: torch.Tensor, noise: torch.Tensor,
                         m_t: torch.Tensor) -> torch.Tensor:
    """The kernel's function in plain PyTorch: three [N,N]·[N, B·D] products
    (a bf16 x̂₀ is widened first)."""
    n = xt.shape[0]
    x0 = torch.clamp(x0.float(), -1.0, 1.0)
    flat = lambda a: a.reshape(n, -1)  # noqa: E731
    out = m_t[:, :n] @ flat(x0) + m_t[:, n : 2 * n] @ flat(xt) + m_t[:, 2 * n :] @ flat(noise)
    return out.reshape(xt.shape)


def posterior_step(x0: torch.Tensor, xt: torch.Tensor, noise: torch.Tensor,
                   m_t: torch.Tensor) -> torch.Tensor:
    """x0 [N,B,D] float32 or bfloat16 (the denoiser's x̂₀), xt, noise [N,B,D]
    float32, m_t [N,3N] → x_{t-1} [N,B,D] float32.  CPU tensors run
    ``posterior_step_plain``; CUDA tensors launch the kernel or raise."""
    global launches, launches_x0_bf16
    if build.kernel_device(x0=x0, xt=xt, noise=noise, m_t=m_t) == "cpu":
        return posterior_step_plain(x0, xt, noise, m_t)
    n, b, d = xt.shape
    build.check_nodes("posterior_step", "posterior_step", n)
    shapes = {"x0": (n, b, d), "xt": (n, b, d), "noise": (n, b, d), "m_t": (n, 3 * n)}
    x0_bf16 = x0.dtype == torch.bfloat16
    dtypes = {"x0": x0.dtype if x0_bf16 else torch.float32, "xt": torch.float32,
              "noise": torch.float32, "m_t": torch.float32}
    build.check_kernel_inputs("posterior_step", shapes, dtypes, x0=x0, xt=xt, noise=noise,
                              m_t=m_t)
    if (b * d) % 4 or b * d == 0 or b * d >= 2**31:
        raise ValueError(f"posterior_step: B·D={b * d} must be a positive multiple of 4 below 2^31")
    if any(t.data_ptr() % 16 for t in (xt, noise)) or x0.data_ptr() % (8 if x0_bf16 else 16):
        raise ValueError("posterior_step: xt and noise must be 16-byte aligned and x0 16-byte "
                         "(float32) or 8-byte (bfloat16) aligned (vector loads)")
    out = torch.empty_like(xt)
    entry = build.c_entry("posterior_step", "posterior_step_x0_bf16" if x0_bf16
                          else "posterior_step_f32", 5, 2, n)
    status = entry(x0.data_ptr(), xt.data_ptr(), noise.data_ptr(), m_t.data_ptr(),
                   out.data_ptr(), n, b * d, build.stream_of(xt))
    build.check_status(f"posterior_step at {n} nodes", status)
    if x0_bf16:
        launches_x0_bf16 += 1
    else:
        launches += 1
    return out
