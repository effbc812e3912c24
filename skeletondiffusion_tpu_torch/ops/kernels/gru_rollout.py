"""The graph-GRU decode rollout, all steps in one CUDA kernel.

The decoder unrolls ``ph`` graph-GRU steps with a constant input whose gates
``cx = [x_{T-1}, z]·W_ih + b_ih`` are hoisted; per step t

    gates_h = G_t·(h·W_hh + b_hh),  gates_x = G_t·cx
    r, z = σ(x + h),  n = tanh(x_n + r·h_n),  h' = n − n·z + z·h
    y_t = tanh(G_fc·(h'·W_fc + b_fc)),  G_{t+1} = l1norm_rows(G_t + G_add)

Port of ``skeletondiffusion_tpu/ops/pallas/gru_rollout.py::gru_rollout_pallas``
(fp32 ``_rollout_kernel``) without the TPU's 128-lane padding: the kernel is
``csrc/gru_rollout.cu``; the plain version is the step loop of
``ops/graph_gru.py``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ..graph_gru import graph_gru_step
from ..graph_linear import gmix_nm, gmm_nm, l1_normalize_rows
from . import build

launches = 0


def gru_rollout_plain(cx, h0, w_hh, b_hh, g0, g_add, w_fc, b_fc, g_fc, *, ph: int) -> torch.Tensor:
    """The kernel's function in plain PyTorch → [ph, N, B, F]."""
    h, g = h0, g0
    ys = []
    for _ in range(ph):
        h = graph_gru_step(cx, h, g, w_hh, b_hh)
        ys.append(torch.tanh(gmix_nm(g_fc, gmm_nm(h, w_fc) + b_fc[:, None, :])))
        g = l1_normalize_rows(g + g_add)
    return torch.stack(ys)


@functools.lru_cache(maxsize=None)
def _entry():
    fn = build.library("gru_rollout").gru_rollout_f32
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def gru_rollout(
    cx: torch.Tensor,     # [N, B, 3H] hoisted input gates (before the G mix)
    h0: torch.Tensor,     # [N, B, H]
    w_hh: torch.Tensor,   # [N, H, 3H] per-node banks
    b_hh: torch.Tensor,   # [N, 3H]
    g0: torch.Tensor,     # [N, N] row-normalized initial influence
    g_add: torch.Tensor,  # [N, N]
    w_fc: torch.Tensor,   # [N, H, F]
    b_fc: torch.Tensor,   # [N, F]
    g_fc: torch.Tensor,   # [N, N] row-normalized output-head influence
    *,
    ph: int,
) -> torch.Tensor:
    """Full rollout → [ph, N, B, F] float32.  CPU tensors run
    ``gru_rollout_plain``; CUDA tensors launch the kernel or raise."""
    global launches
    tensors = dict(cx=cx, h0=h0, w_hh=w_hh, b_hh=b_hh, g0=g0, g_add=g_add, w_fc=w_fc,
                   b_fc=b_fc, g_fc=g_fc)
    if build.kernel_device(**tensors) == "cpu":
        return gru_rollout_plain(**tensors, ph=ph)
    n, b, h = h0.shape
    f = w_fc.shape[-1]
    shapes = dict(cx=(n, b, 3 * h), h0=(n, b, h), w_hh=(n, h, 3 * h), b_hh=(n, 3 * h),
                  g0=(n, n), g_add=(n, n), w_fc=(n, h, f), b_fc=(n, f), g_fc=(n, n))
    build.check_kernel_inputs("gru_rollout", shapes, torch.float32, **tensors)
    if b == 0 or ph <= 0 or n * b * 3 * h >= 2**31:
        raise ValueError(f"gru_rollout: batch {b} and ph {ph} out of the kernel's range")
    out = torch.empty((ph, n, b, f), dtype=torch.float32, device=cx.device)
    ptrs = [t.data_ptr() for t in tensors.values()]
    status = _entry()(*ptrs, out.data_ptr(), n, b, h, f, ph,
                      torch.cuda.current_stream(cx.device).cuda_stream)
    build.check_status(f"gru_rollout at (nodes, hidden, outputs)={(n, h, f)}", status)
    launches += 1
    return out
