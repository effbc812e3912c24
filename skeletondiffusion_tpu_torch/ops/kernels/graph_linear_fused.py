"""One-pass graph-structural linear — the fused denoiser's stem — in one CUDA
kernel:

    out = round(G·round(x·W + b + u))

with per-node banks W [N, in, out], b [N, out], the row-normalized influence
G [N, N] and the hoisted conditioning product u [N, B, out], all in one
element type (bf16 on the prediction path; fp32 is instantiated too), sums in
fp32 and round() to that type where the Pallas kernel materialises.  Port of
``skeletondiffusion_tpu/ops/pallas/graph_linear_fused.py::graph_linear_pallas``
without the TPU's 128-lane feature padding and batch-tile padding; the kernel
is ``csrc/graph_linear_fused.cu``, the stem pass of the layer-fused
``stem_block`` (B9a) alone on the engine of ``csrc/node_mix_sm90.cuh``: the
wrapper hands it the bank [N, D, F] packed into one tile of all F columns,
its rows zero-padded to ``node_mix_sm90.narrow_width(D)`` (cached per bank),
and the tile plan (``graph_linear_fused_plan``).
"""
from __future__ import annotations

from typing import Optional

import torch

from ..graph_linear import gmix_nm, gmm_nm
from . import build, node_mix_sm90

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


def graph_linear_fused_plan(dtype: torch.dtype, d: int, f: int,
                            nodes: int = node_mix_sm90.N_NODES) -> node_mix_sm90.BlockPlan:
    """The tile plan of the kernel at ``nodes`` nodes: one pass d → f, its
    contraction padded to ``node_mix_sm90.narrow_width(d)`` (the plan of
    B9a's stem pass); raises for what the kernel does not take (d not a
    positive multiple of 8, f not a multiple of 64 up to 256, a node count
    out of range, a plan that does not fit)."""
    return node_mix_sm90.block_plan("graph_linear_fused", dtype, f,
                                    (node_mix_sm90.narrow_width("graph_linear_fused", d),),
                                    nodes)


def _checked(x, w, b, g, u):
    """(tensors, shapes, widths, plan) of a launch, or raise."""
    n, rows, d = x.shape
    f = w.shape[-1]
    plan = graph_linear_fused_plan(x.dtype, d, f, n)
    shapes = dict(x=(n, rows, d), w=(n, d, f), b=(n, f), g=(n, n), u=(n, rows, f))
    tensors = dict(x=x, w=w, b=b, g=g, u=u)
    node_mix_sm90.check("graph_linear_fused", tensors, shapes, x.dtype)
    return tensors, shapes, (n, rows, d, f), plan


def _launch(x, w, b, g, u):
    global launches
    tensors, shapes, (n, rows, d, f), plan = _checked(x, w, b, g, u)
    out = torch.empty((n, rows, f), dtype=x.dtype, device=x.device)
    node_mix_sm90.launch("graph_linear_fused", "graph_linear_fused", tensors, shapes,
                         {"w": ("rows", node_mix_sm90.padded_width(d), ("groups", f, f))},
                         (n, rows, d, f, *plan), out)
    launches += 1
    return out


def _fake(x, w, b, g, u):
    if build.on_cuda(x, w, b, g, u):
        _checked(x, w, b, g, u)
    return x.new_empty((*x.shape[:2], w.shape[-1]))


graph_linear_fused_op = build.kernel_op(
    "graph_linear_fused", "(Tensor x, Tensor w, Tensor b, Tensor g, Tensor? u) -> Tensor",
    graph_linear_fused_plain, _launch, _fake)


def graph_linear_fused(
    x: torch.Tensor,                    # [N, B, in]
    w: torch.Tensor,                    # [N, in, out] per-node banks
    b: torch.Tensor,                    # [N, out]
    g: torch.Tensor,                    # [N, N] row-normalized influence
    u: Optional[torch.Tensor] = None,   # [N, B, out] partial product to add
) -> torch.Tensor:
    """→ [N, B, out] in the inputs' dtype, through the op
    ``skd::graph_linear_fused``.  CPU tensors run
    ``graph_linear_fused_plain``; CUDA tensors launch the kernel or raise."""
    return graph_linear_fused_op(x, w, b, g, u)
