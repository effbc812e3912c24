"""One reverse-diffusion posterior update, fused into one CUDA kernel.

For the flagship sampler (pred_x0, clip_denoised, identity activation,
nonisotropic process) everything after the denoiser is

    x_{t-1} = P1_t·clip(x̂₀,−1,1) + P2_t·x_t + (U·diag σ_t)·ε

with ``m_t = [P1_t | P2_t | Uσ_t]`` from
``NonisotropicProcess.posterior_step_tables`` (noise block zero at t=0),
applied to node-major latents ``[N, B, D]``.  Port of
``skeletondiffusion_tpu/ops/pallas/posterior_step.py::posterior_step_pallas``
without the TPU's 128-lane feature padding; the kernel is
``csrc/posterior_step.cu``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import build

launches = 0


def posterior_step_plain(x0: torch.Tensor, xt: torch.Tensor, noise: torch.Tensor,
                         m_t: torch.Tensor) -> torch.Tensor:
    """The kernel's function in plain PyTorch: three [N,N]·[N, B·D] products."""
    n = xt.shape[0]
    x0 = torch.clamp(x0, -1.0, 1.0)
    flat = lambda a: a.reshape(n, -1)  # noqa: E731
    out = m_t[:, :n] @ flat(x0) + m_t[:, n : 2 * n] @ flat(xt) + m_t[:, 2 * n :] @ flat(noise)
    return out.reshape(xt.shape)


@functools.lru_cache(maxsize=None)
def _entry():
    fn = build.library("posterior_step").posterior_step_f32
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def posterior_step(x0: torch.Tensor, xt: torch.Tensor, noise: torch.Tensor,
                   m_t: torch.Tensor) -> torch.Tensor:
    """x0, xt, noise [N,B,D] float32 (x0 the denoiser's x̂₀), m_t [N,3N] →
    x_{t-1} [N,B,D].  CPU tensors run ``posterior_step_plain``; CUDA tensors
    launch the kernel or raise."""
    global launches
    if build.kernel_device(x0=x0, xt=xt, noise=noise, m_t=m_t) == "cpu":
        return posterior_step_plain(x0, xt, noise, m_t)
    n, b, d = xt.shape
    shapes = {"x0": (n, b, d), "xt": (n, b, d), "noise": (n, b, d), "m_t": (n, 3 * n)}
    build.check_kernel_inputs("posterior_step", shapes, x0=x0, xt=xt, noise=noise, m_t=m_t)
    if (b * d) % 4 or b * d == 0 or b * d >= 2**31:
        raise ValueError(f"posterior_step: B·D={b * d} must be a positive multiple of 4 below 2^31")
    if any(t.data_ptr() % 16 for t in (x0, xt, noise)):
        raise ValueError("posterior_step: x0, xt and noise must be 16-byte aligned (float4 loads)")
    out = torch.empty_like(xt)
    status = _entry()(x0.data_ptr(), xt.data_ptr(), noise.data_ptr(), m_t.data_ptr(),
                      out.data_ptr(), n, b * d, torch.cuda.current_stream(xt.device).cuda_stream)
    build.check_status(f"posterior_step at {n} nodes", status)
    launches += 1
    return out
