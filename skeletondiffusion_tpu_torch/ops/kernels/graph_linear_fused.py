"""One-pass graph-structural linear — the fused denoiser's stem — in one CUDA
kernel:

    out = round(G·round(x·W + b + u))

with per-node banks W [N, in, out], b [N, out], the row-normalized influence
G [N, N] and the hoisted conditioning product u [N, B, out], all in one
element type (bf16 on the prediction path; fp32 is instantiated too), sums in
fp32 and round() to that type where the Pallas kernel materialises.  Port of
``skeletondiffusion_tpu/ops/pallas/graph_linear_fused.py::graph_linear_pallas``
without the TPU's 128-lane feature padding and batch-tile padding; the kernel
is ``csrc/graph_linear_fused.cu`` (its routines in ``csrc/node_mix.cuh``).
"""
from __future__ import annotations

from typing import Optional

import torch

from ..graph_linear import gmix_nm, gmm_nm
from . import build

launches = 0


def product_plain(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None
                  ) -> torch.Tensor:
    """Per-node x·W (+ b) of node-major [N,B,in]·[N,in,out] in fp32 from the
    inputs' values."""
    h = gmm_nm(x.float(), w.float())
    return h if b is None else h + b.float()[:, None, :]


def mix_plain(g: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """The influence mix G·h in fp32 from the inputs' values."""
    return gmix_nm(g.float(), h.float())


def graph_linear_fused_plain(x, w, b, g, u=None) -> torch.Tensor:
    """The kernel's function in plain PyTorch, rounding where it rounds."""
    dt = x.dtype
    h = product_plain(x, w, b)
    if u is not None:
        h = h + u.float()
    return mix_plain(g, h.to(dt)).to(dt)


def graph_linear_fused(
    x: torch.Tensor,                    # [N, B, in]
    w: torch.Tensor,                    # [N, in, out] per-node banks
    b: torch.Tensor,                    # [N, out]
    g: torch.Tensor,                    # [N, N] row-normalized influence
    u: Optional[torch.Tensor] = None,   # [N, B, out] partial product to add
) -> torch.Tensor:
    """→ [N, B, out] in the inputs' dtype.  CPU tensors run
    ``graph_linear_fused_plain``; CUDA tensors launch the kernel or raise."""
    global launches
    tensors = dict(x=x, w=w, b=b, g=g) if u is None else dict(x=x, w=w, b=b, g=g, u=u)
    if build.kernel_device(**tensors) == "cpu":
        return graph_linear_fused_plain(x, w, b, g, u)
    n, rows, fi = x.shape
    fo = w.shape[-1]
    shapes = dict(x=(n, rows, fi), w=(n, fi, fo), b=(n, fo), g=(n, n), u=(n, rows, fo))
    suffix = build.element_suffix("graph_linear_fused", x.dtype)
    build.check_kernel_inputs("graph_linear_fused", shapes, x.dtype, **tensors)
    build.check_aligned("graph_linear_fused", 32, **tensors)
    out = torch.empty((n, rows, fo), dtype=x.dtype, device=x.device)
    status = build.c_entry("graph_linear_fused", f"graph_linear_fused_{suffix}", 6, 4)(
        x.data_ptr(), w.data_ptr(), b.data_ptr(), g.data_ptr(),
        None if u is None else u.data_ptr(), out.data_ptr(), n, rows, fi, fo,
        build.stream_of(x))
    build.check_status(f"graph_linear_fused at (nodes, in, out)={(n, fi, fo)}", status)
    launches += 1
    return out
