"""The attention layer's two projection stages as CUDA kernels.

Node-major activations, per-node banks, row-normalized influences [N, N],
all in one element type (bf16 on the prediction path; fp32 is instantiated
too); sums in fp32, round() to that type where the Pallas kernels
materialise:

    rms_qkv:      h   = round(x / sqrt(max(Σx², 1e-24)) · g_rms)
                  qkv = round(G_qkv·round(h·W_qkv))        [N,B,F] → [N,B,3·hd]
    outproj_res:  out = round(G_out·round(a·W_out) + x)    [N,B,hd] → [N,B,F]

``g_rms`` [F] is the RMSNorm gain with √F folded in.  Ports of
``skeletondiffusion_tpu/ops/pallas/attention_proj.py::rms_qkv_pallas`` and
``::outproj_res_pallas`` without the TPU's padding; the kernels are
``csrc/attention_proj.cu``.  Both run on the engine of
``csrc/node_mix_sm90.cuh``: they take the banks in the JAX layout and hand
the kernel a packed copy (``node_mix_sm90.pack_banks``, cached per bank: for
``rms_qkv`` tiles of 96 columns of W_qkv, for ``outproj_res`` one tile of all
F columns of W_out) and the tile plan (``rms_qkv_plan``,
``outproj_res_plan``).
"""
from __future__ import annotations

import torch

from . import build, node_mix_sm90
from .graph_linear_fused import mix_plain, product_plain

launches_rms_qkv = 0
launches_outproj_res = 0

# rows an item and output columns a group of the rms_qkv kernel, up to
# build.NARROW_NODES and past it (``QkvTile`` in csrc/attention_proj.cu)
QKV_TILES = {torch.bfloat16: (32, 96), torch.float32: (8, 96)}
QKV_TILES_WIDE = {torch.bfloat16: (16, 64), torch.float32: (8, 96)}


def rms_qkv_plain(x, g_rms, w_qkv, g_qkv) -> torch.Tensor:
    dt = x.dtype
    xf = x.float()
    norm = torch.sqrt(torch.clamp((xf * xf).sum(dim=-1, keepdim=True), min=1e-24))
    h = (xf / norm * g_rms.float()).to(dt)
    return mix_plain(g_qkv, product_plain(h, w_qkv).to(dt)).to(dt)


def outproj_res_plain(a, x, w_out, g_out) -> torch.Tensor:
    dt = x.dtype
    return (mix_plain(g_out, product_plain(a, w_out).to(dt)) + x.float()).to(dt)


def rms_qkv_plan(dtype: torch.dtype, f: int, fo: int,
                 nodes: int = node_mix_sm90.N_NODES) -> node_mix_sm90.TilePlan:
    """The tile plan of the rms_qkv kernel at input width ``f``, output
    width ``fo`` and ``nodes`` nodes; raises for what the kernel does not
    take."""
    build.element_suffix("rms_qkv", dtype)
    if f <= 0 or f % 32:
        raise ValueError(f"rms_qkv: F={f} must be a positive multiple of 32")
    if fo <= 0 or fo % 8:
        raise ValueError(f"rms_qkv: the output width {fo} must be a positive multiple of 8")
    rows, cols = (QKV_TILES_WIDE if build.wide(nodes) else QKV_TILES)[dtype]
    return node_mix_sm90.plan("rms_qkv", dtype, rows, cols, f, nodes)


def _rms_qkv_checked(x, g_rms, w_qkv, g_qkv):
    n, rows, f = x.shape
    fo = w_qkv.shape[-1]
    plan = rms_qkv_plan(x.dtype, f, fo, n)
    shapes = dict(x=(n, rows, f), g_rms=(f,), w_qkv=(n, f, fo), g_qkv=(n, n))
    tensors = dict(x=x, g_rms=g_rms, w_qkv=w_qkv, g_qkv=g_qkv)
    node_mix_sm90.check("rms_qkv", tensors, shapes, x.dtype)
    return tensors, shapes, plan


def _rms_qkv_launch(x, g_rms, w_qkv, g_qkv):
    global launches_rms_qkv
    tensors, shapes, plan = _rms_qkv_checked(x, g_rms, w_qkv, g_qkv)
    n, rows, f = x.shape
    fo = w_qkv.shape[-1]
    out = torch.empty((n, rows, fo), dtype=x.dtype, device=x.device)
    node_mix_sm90.launch("attention_proj", "rms_qkv", tensors, shapes,
                         {"w_qkv": ("groups", fo, plan.cols)}, (n, rows, f, fo, *plan), out)
    launches_rms_qkv += 1
    return out


def _rms_qkv_fake(x, g_rms, w_qkv, g_qkv):
    if build.on_cuda(x, g_rms, w_qkv, g_qkv):
        _rms_qkv_checked(x, g_rms, w_qkv, g_qkv)
    return x.new_empty((*x.shape[:2], w_qkv.shape[-1]))


rms_qkv_op = build.kernel_op(
    "rms_qkv", "(Tensor x, Tensor g_rms, Tensor w_qkv, Tensor g_qkv) -> Tensor",
    rms_qkv_plain, _rms_qkv_launch, _rms_qkv_fake)


def rms_qkv(x, g_rms, w_qkv, g_qkv) -> torch.Tensor:
    """x [N,B,F], g_rms [F], w_qkv [N,F,3·hd], g_qkv [N,N] → [N,B,3·hd],
    through the op ``skd::rms_qkv``.  CPU tensors run ``rms_qkv_plain``;
    CUDA tensors launch the kernel or raise."""
    return rms_qkv_op(x, g_rms, w_qkv, g_qkv)


def outproj_res_plan(dtype: torch.dtype, hd: int, f: int,
                     nodes: int = node_mix_sm90.N_NODES) -> node_mix_sm90.BlockPlan:
    """The tile plan of the outproj_res kernel (the out-projection hd → f)
    at ``nodes`` nodes; raises for what the kernel does not take."""
    return node_mix_sm90.block_plan("outproj_res", dtype, f, (hd,), nodes)


def _outproj_res_checked(a, x, w_out, g_out):
    n, rows, hd = a.shape
    f = x.shape[-1]
    plan = outproj_res_plan(x.dtype, hd, f, n)
    shapes = dict(a=(n, rows, hd), x=(n, rows, f), w_out=(n, hd, f), g_out=(n, n))
    tensors = dict(a=a, x=x, w_out=w_out, g_out=g_out)
    node_mix_sm90.check("outproj_res", tensors, shapes, x.dtype)
    return tensors, shapes, plan


def _outproj_res_launch(a, x, w_out, g_out):
    global launches_outproj_res
    tensors, shapes, plan = _outproj_res_checked(a, x, w_out, g_out)
    n, rows, hd = a.shape
    f = x.shape[-1]
    out = torch.empty_like(x)
    node_mix_sm90.launch("attention_proj", "outproj_res", tensors, shapes,
                         {"w_out": ("groups", f, f)}, (n, rows, hd, f, *plan), out)
    launches_outproj_res += 1
    return out


def _outproj_res_fake(a, x, w_out, g_out):
    if build.on_cuda(a, x, w_out, g_out):
        _outproj_res_checked(a, x, w_out, g_out)
    return torch.empty_like(x)


outproj_res_op = build.kernel_op(
    "outproj_res", "(Tensor a, Tensor x, Tensor w_out, Tensor g_out) -> Tensor",
    outproj_res_plain, _outproj_res_launch, _outproj_res_fake)


def outproj_res(a, x, w_out, g_out) -> torch.Tensor:
    """a [N,B,hd], x [N,B,F], w_out [N,hd,F], g_out [N,N] → [N,B,F], through
    the op ``skd::outproj_res``.  CPU tensors run ``outproj_res_plain``;
    CUDA tensors launch the kernel or raise."""
    return outproj_res_op(a, x, w_out, g_out)
