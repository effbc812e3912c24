"""One reverse-diffusion posterior update, fused into one CUDA kernel.

For the flagship sampler (pred_x0, clip_denoised, identity activation,
nonisotropic process) everything after the denoiser is

    x_{t-1} = P1_t·clip(x̂₀,−1,1) + P2_t·x_t + (U·diag σ_t)·ε

with ``m_t = [P1_t | P2_t | Uσ_t]`` from
``NonisotropicProcess.posterior_step_tables`` (noise block zero at t=0),
applied to node-major latents ``[N, B, D]``.  Port of
``skeletondiffusion_tpu/ops/pallas/posterior_step.py::posterior_step_pallas``
without the TPU's 128-lane feature padding; the kernel is
``csrc/posterior_step.cu``: one contraction ``m_t · [x_t; ε; clip(x̂₀)]`` on
the tensor cores in 3×TF32, fed by a TMA ring (``posterior_plan``).  x̂₀ may
be float32 or, as the fused bf16 denoiser emits it, bfloat16: the second C
entry reads it in bf16; x_t, the noise and the output are float32 either way.

``posterior_step`` calls the kernel through the custom op
``skd::posterior_step`` (``build.kernel_op``), either x̂₀ dtype.
``posterior_step_cuda_core`` launches the source's second design, the same
function on the CUDA cores: a yardstick for the first, which no path runs.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import build

launches = 0           # the float32-x̂₀ entry
launches_x0_bf16 = 0   # the bfloat16-x̂₀ entry
launches_cuda_core = 0  # the CUDA-core design, either entry

TILE_COLS = 32      # columns of a tile: one 128-byte fp32 row of a TMA box
MAX_STAGES = 4      # a warp's ring
MAX_SMEM = 232_448  # 227 KB of dynamic shared memory a block


MAX_WARPS = 8       # a block's (the kernel's launch bounds)


class PosteriorPlan(NamedTuple):
    cols: int     # columns of a warp's tile
    warps: int    # warps of a block, one block an SM
    stages: int   # ring stages of each warp
    k: int        # the contraction's width: 3·⌊N/8⌋ whole k-steps, then the
                  # three inputs' N mod 8 remaining rows together, padded to 8
    smem: int     # bytes of dynamic shared memory of a block


def plan_smem(n: int, x0_dtype: torch.dtype, warps: int, stages: int) -> int:
    """Dynamic shared memory of a block (the layout of
    ``csrc/posterior_step.cu``): 1 024 bytes to align the ring; ``warps`` ×
    ``stages`` stages, each a 32-column tile of x_t and ε (fp32) and x̂₀,
    ⌈n/8⌉·8 rows each, rounded to 1 024 bytes; M's split fragments (K/8
    k-steps × ⌈n/8⌉ n tiles × 32 lanes × 16 bytes); a barrier a stage."""
    n_pad = -(-n // 8) * 8
    x0_bytes = 2 if x0_dtype == torch.bfloat16 else 4
    stage = -(-(2 * n_pad * 4 * TILE_COLS + n_pad * TILE_COLS * x0_bytes) // 1024) * 1024
    k_steps = 3 * (n // 8) + -(-3 * (n % 8) // 8)
    return 1024 + warps * stages * stage + k_steps * n_pad * 64 + 8 * warps * stages


def posterior_plan(n: int, x0_dtype: torch.dtype = torch.float32) -> PosteriorPlan:
    """The tensor-core kernel's plan at ``n`` nodes, as swept on an H100
    (``scripts/torch_posterior_plans.py``): up to 32 nodes 4 warps × 2
    stages; past it one stage a warp and as many warps as fit (at 51 nodes
    7 with an fp32 x̂₀, 8 with a bf16 one: there the warps' issue binds)."""
    stages = 2 if n <= 32 else 1
    fits = [w for w in range(1, MAX_WARPS + 1) if plan_smem(n, x0_dtype, w, stages) <= MAX_SMEM]
    if not fits:
        raise ValueError(f"posterior_step: no ring fits a block's {MAX_SMEM} bytes at {n} nodes")
    warps = 4 if n <= 32 else fits[-1]
    k = 8 * (3 * (n // 8) + -(-3 * (n % 8) // 8))
    return PosteriorPlan(TILE_COLS, warps, stages, k, plan_smem(n, x0_dtype, warps, stages))


def posterior_step_plain(x0: torch.Tensor, xt: torch.Tensor, noise: torch.Tensor,
                         m_t: torch.Tensor) -> torch.Tensor:
    """The kernel's function in plain PyTorch: three [N,N]·[N, B·D] products
    (a bf16 x̂₀ is widened first)."""
    n = xt.shape[0]
    x0 = torch.clamp(x0.float(), -1.0, 1.0)
    flat = lambda a: a.reshape(n, -1)  # noqa: E731
    out = m_t[:, :n] @ flat(x0) + m_t[:, n : 2 * n] @ flat(xt) + m_t[:, 2 * n :] @ flat(noise)
    return out.reshape(xt.shape)


def _checked(x0, xt, noise, m_t) -> tuple:
    """(n, columns, x̂₀ in bf16) of a call on CUDA tensors the kernels take,
    or raise: shapes, dtypes, contiguity, and columns a multiple of 4
    (float32 x̂₀) or 8 (bf16): a tensor map's rows are whole multiples of 16
    bytes (the launches check the 16-byte alignment after it)."""
    n, b, d = xt.shape
    build.check_nodes("posterior_step", n)
    shapes = {"x0": (n, b, d), "xt": (n, b, d), "noise": (n, b, d), "m_t": (n, 3 * n)}
    x0_bf16 = x0.dtype == torch.bfloat16
    dtypes = {"x0": x0.dtype if x0_bf16 else torch.float32, "xt": torch.float32,
              "noise": torch.float32, "m_t": torch.float32}
    build.check_kernel_inputs("posterior_step", shapes, dtypes, x0=x0, xt=xt, noise=noise,
                              m_t=m_t)
    cols, mult = b * d, 8 if x0_bf16 else 4
    if cols % mult or cols == 0 or cols >= 2**31:
        raise ValueError(f"posterior_step: B·D={cols} must be a positive multiple of {mult} below "
                         f"2^31 (a TMA row of the {'bfloat16' if x0_bf16 else 'float32'} x̂₀ "
                         "is a multiple of 16 bytes)")
    return n, cols, x0_bf16


def _launch(x0: torch.Tensor, xt: torch.Tensor, noise: torch.Tensor,
            m_t: torch.Tensor) -> torch.Tensor:
    global launches, launches_x0_bf16
    n, cols, x0_bf16 = _checked(x0, xt, noise, m_t)
    build.check_aligned("posterior_step", 16, x0=x0, xt=xt, noise=noise)
    plan = posterior_plan(n, x0.dtype)
    out = torch.empty_like(xt)
    entry = build.c_entry("posterior_step", "posterior_step_x0_bf16" if x0_bf16
                          else "posterior_step_f32", 5, 5, n)
    status = entry(x0.data_ptr(), xt.data_ptr(), noise.data_ptr(), m_t.data_ptr(),
                   out.data_ptr(), n, cols, plan.warps, plan.stages, plan.smem,
                   build.stream_of(xt))
    build.check_status(f"posterior_step at {n} nodes", status)
    if x0_bf16:
        launches_x0_bf16 += 1
    else:
        launches += 1
    return out


def _fake(x0, xt, noise, m_t):
    if build.on_cuda(x0, xt, noise, m_t):
        posterior_plan(_checked(x0, xt, noise, m_t)[0], x0.dtype)
    return torch.empty_like(xt)


posterior_step_op = build.kernel_op(
    "posterior_step", "(Tensor x0, Tensor xt, Tensor noise, Tensor m_t) -> Tensor",
    posterior_step_plain, _launch, _fake)


def posterior_step(x0: torch.Tensor, xt: torch.Tensor, noise: torch.Tensor,
                   m_t: torch.Tensor) -> torch.Tensor:
    """x0 [N,B,D] float32 or bfloat16 (the denoiser's x̂₀), xt, noise [N,B,D]
    float32, m_t [N,3N] → x_{t-1} [N,B,D] float32.  CPU tensors run
    ``posterior_step_plain``; CUDA tensors launch the kernel or raise."""
    return posterior_step_op(x0, xt, noise, m_t)


def posterior_step_cuda_core(x0: torch.Tensor, xt: torch.Tensor, noise: torch.Tensor,
                             m_t: torch.Tensor) -> torch.Tensor:
    """``posterior_step`` on CUDA tensors by the source's CUDA-core design (a
    thread per 4 columns, 2 past 32 nodes; M read as float4 over 4 k): the
    yardstick chip_smoke times beside the kernel.  Raises on CPU tensors."""
    global launches_cuda_core
    if build.kernel_device(x0=x0, xt=xt, noise=noise, m_t=m_t) == "cpu":
        raise RuntimeError("posterior_step_cuda_core: needs CUDA tensors")
    n, cols, x0_bf16 = _checked(x0, xt, noise, m_t)
    build.check_aligned("posterior_step_cuda_core", 16, x0=x0, xt=xt, noise=noise)
    out = torch.empty_like(xt)
    entry = build.c_entry("posterior_step", "posterior_step_fma_x0_bf16" if x0_bf16
                          else "posterior_step_fma_f32", 5, 2, n)
    status = entry(x0.data_ptr(), xt.data_ptr(), noise.data_ptr(), m_t.data_ptr(),
                   out.data_ptr(), n, cols, build.stream_of(xt))
    build.check_status(f"posterior_step_cuda_core at {n} nodes", status)
    launches_cuda_core += 1
    return out
