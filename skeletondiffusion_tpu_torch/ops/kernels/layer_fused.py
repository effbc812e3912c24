"""The denoiser's per-layer kernels (``SKELDIFF_LAYER_FUSED=1``): each runs
two or three stages of the single-stage chain in one CUDA kernel, so that
what passes between them never leaves the block.

Node-major activations, per-node banks, biases, row-normalized influences
[N, N] and FiLM rows scale‖shift [2F], all in one element type (bf16 on the
prediction path; fp32 is instantiated too); they round where the
single-stage kernels round, and their plain versions are those kernels'
plain versions composed:

    stem_block:     r   = graph_linear_fused(x, Ws, bs, Gs, u)        (B4)
                    out = resnet_block(r)                             (B1)
    rms_qkv_core:   out = attention_core(rms_qkv(x))                  (B3a, B2)
    outproj_block:  out = resnet_block(outproj_res(a, x))             (B3b, B1)

Ports of ``skeletondiffusion_tpu/ops/pallas/layer_fused.py``
(``stem_block_pallas``, ``rms_qkv_core_pallas``, ``outproj_block_pallas``)
without the TPU's padding; the kernels are ``csrc/layer_fused.cu``, all three
on the engine of ``csrc/node_mix_sm90.cuh``: they take the banks in the JAX
layout and hand the kernel packed copies (``node_mix_sm90.pack_banks``,
cached per bank: for ``rms_qkv_core`` one tile of a head's q, k and v
columns, for ``outproj_block`` and ``stem_block`` one tile of all F columns
of each bank, the stem's [N, D, F] bank with its rows zero-padded to
``node_mix_sm90.padded_width(D)``) and the tile plan
(``rms_qkv_core_plan``, ``outproj_block_plan``, ``stem_block_plan``).
"""
from __future__ import annotations

import torch

from . import build, node_mix_sm90
from .attention_proj import outproj_res_plain, rms_qkv_plain
from .graph_linear_fused import graph_linear_fused_plain
from .joint_attention import attention_core_plain
from .resnet_block import resnet_block_plain

launches_stem_block = 0
launches_rms_qkv_core = 0
launches_outproj_block = 0

# rows an item of the rms_qkv_core kernel (its columns are a head's q‖k‖v),
# up to build.NARROW_NODES and past it (``CoreTile`` in csrc/layer_fused.cu)
CORE_ROWS = {torch.bfloat16: 32, torch.float32: 8}
CORE_ROWS_WIDE = {torch.bfloat16: 8, torch.float32: 8}
CORE_DIM_HEAD = 32


def stem_block_plain(x, u, film, ws, bs, gs, w1, b1, g1, w2, b2, g2):
    r = graph_linear_fused_plain(x, ws, bs, gs, u)
    return r, resnet_block_plain(r, film, w1, b1, g1, w2, b2, g2)


def rms_qkv_core_plain(x, g_rms, w_qkv, g_qkv, heads: int, dim_head: int) -> torch.Tensor:
    return attention_core_plain(rms_qkv_plain(x, g_rms, w_qkv, g_qkv), heads, dim_head)


def outproj_block_plain(a, x, film, w_out, g_out, w1, b1, g1, w2, b2, g2) -> torch.Tensor:
    return resnet_block_plain(outproj_res_plain(a, x, w_out, g_out), film, w1, b1, g1, w2, b2,
                              g2)


def _block_shapes(n: int, f: int) -> dict:
    return dict(film=(2 * f,), w1=(n, f, f), b1=(n, f), g1=(n, n), w2=(n, f, f), b2=(n, f),
                g2=(n, n))


def stem_block_plan(dtype: torch.dtype, d: int, f: int,
                    nodes: int = node_mix_sm90.N_NODES) -> node_mix_sm90.BlockPlan:
    """The tile plan of the stem_block kernel (the stem d → f, its
    contraction padded to ``node_mix_sm90.padded_width(d)``, then the
    block's two f → f products) at ``nodes`` nodes; raises for what the
    kernel does not take."""
    return node_mix_sm90.block_plan("stem_block", dtype, f,
                                    (node_mix_sm90.narrow_width("stem_block", d), f, f), nodes)


def _stem_block_checked(x, u, film, ws, bs, gs, w1, b1, g1, w2, b2, g2):
    n, rows, d = x.shape
    f = ws.shape[-1]
    plan = stem_block_plan(x.dtype, d, f, n)
    shapes = dict(x=(n, rows, d), u=(n, rows, f), ws=(n, d, f), bs=(n, f), gs=(n, n),
                  **_block_shapes(n, f))
    tensors = dict(x=x, u=u, film=film, ws=ws, bs=bs, gs=gs, w1=w1, b1=b1, g1=g1, w2=w2, b2=b2,
                   g2=g2)
    node_mix_sm90.check("stem_block", tensors, shapes, x.dtype)
    return tensors, shapes, plan


def _stem_block_launch(*args):
    global launches_stem_block
    tensors, shapes, plan = _stem_block_checked(*args)
    x, ws = args[0], args[3]
    n, rows, d = x.shape
    f = ws.shape[-1]
    r = torch.empty((n, rows, f), dtype=x.dtype, device=x.device)
    out = torch.empty_like(r)
    whole = ("groups", f, f)  # one tile of all f columns a bank
    node_mix_sm90.launch("layer_fused", "stem_block", tensors, shapes,
                         {"ws": ("rows", node_mix_sm90.padded_width(d), whole), "w1": whole,
                          "w2": whole},
                         (n, rows, d, f, *plan), r, out)
    launches_stem_block += 1
    return r, out


def _stem_block_fake(*args):
    if build.on_cuda(*args):
        _stem_block_checked(*args)
    x, ws = args[0], args[3]
    r = x.new_empty((*x.shape[:2], ws.shape[-1]))
    return r, torch.empty_like(r)


stem_block_op = build.kernel_op(
    "stem_block", "(Tensor x, Tensor u, Tensor film, Tensor ws, Tensor bs, Tensor gs, "
    "Tensor w1, Tensor b1, Tensor g1, Tensor w2, Tensor b2, Tensor g2) -> (Tensor, Tensor)",
    stem_block_plain, _stem_block_launch, _stem_block_fake)


def stem_block(x, u, film, ws, bs, gs, w1, b1, g1, w2, b2, g2):
    """x [N,B,D], u [N,B,F], film [2F], ws [N,D,F], bs [N,F], gs [N,N], the
    block's w1, w2 [N,F,F], b1, b2 [N,F], g1, g2 [N,N] → (r, out) [N,B,F]
    each: the stem's output (the long skip) and block 0's, through the op
    ``skd::stem_block``.  CPU tensors run ``stem_block_plain``; CUDA tensors
    launch the kernel or raise."""
    return stem_block_op(x, u, film, ws, bs, gs, w1, b1, g1, w2, b2, g2)


def rms_qkv_core_plan(dtype: torch.dtype, f: int, heads: int, dim_head: int,
                      nodes: int = node_mix_sm90.N_NODES) -> node_mix_sm90.TilePlan:
    """The tile plan of the rms_qkv_core kernel at input width ``f`` and
    ``nodes`` nodes; raises for what the kernel does not take."""
    build.element_suffix("rms_qkv_core", dtype)
    if dim_head != CORE_DIM_HEAD or heads <= 0:
        raise ValueError(f"rms_qkv_core: takes heads of {CORE_DIM_HEAD}, got {heads} × {dim_head}")
    if f <= 0 or f % 32:
        raise ValueError(f"rms_qkv_core: F={f} must be a positive multiple of 32")
    rows = (CORE_ROWS_WIDE if build.wide(nodes) else CORE_ROWS)[dtype]
    return node_mix_sm90.plan("rms_qkv_core", dtype, rows, 3 * dim_head, f, nodes)


def _rms_qkv_core_checked(x, g_rms, w_qkv, g_qkv, heads: int, dim_head: int):
    n, rows, f = x.shape
    hd = heads * dim_head
    plan = rms_qkv_core_plan(x.dtype, f, heads, dim_head, n)
    shapes = dict(x=(n, rows, f), g_rms=(f,), w_qkv=(n, f, 3 * hd), g_qkv=(n, n))
    tensors = dict(x=x, g_rms=g_rms, w_qkv=w_qkv, g_qkv=g_qkv)
    node_mix_sm90.check("rms_qkv_core", tensors, shapes, x.dtype)
    return tensors, shapes, plan


def _rms_qkv_core_launch(x, g_rms, w_qkv, g_qkv, heads: int, dim_head: int):
    global launches_rms_qkv_core
    tensors, shapes, plan = _rms_qkv_core_checked(x, g_rms, w_qkv, g_qkv, heads, dim_head)
    n, rows, f = x.shape
    out = torch.empty((n, rows, heads * dim_head), dtype=x.dtype, device=x.device)
    node_mix_sm90.launch("layer_fused", "rms_qkv_core", tensors, shapes,
                         {"w_qkv": ("heads", heads, dim_head)},
                         (n, rows, f, heads, dim_head, *plan), out)
    launches_rms_qkv_core += 1
    return out


def _rms_qkv_core_fake(x, g_rms, w_qkv, g_qkv, heads: int, dim_head: int):
    if build.on_cuda(x, g_rms, w_qkv, g_qkv):
        _rms_qkv_core_checked(x, g_rms, w_qkv, g_qkv, heads, dim_head)
    return x.new_empty((*x.shape[:2], heads * dim_head))


rms_qkv_core_op = build.kernel_op(
    "rms_qkv_core", "(Tensor x, Tensor g_rms, Tensor w_qkv, Tensor g_qkv, int heads, "
    "int dim_head) -> Tensor", rms_qkv_core_plain, _rms_qkv_core_launch, _rms_qkv_core_fake)


def rms_qkv_core(x, g_rms, w_qkv, g_qkv, *, heads: int, dim_head: int) -> torch.Tensor:
    """x [N,B,F], g_rms [F] (√F folded in), w_qkv [N,F,3·H·dh] (q‖k‖v),
    g_qkv [N,N] → the attention core's output [N,B,H·dh], through the op
    ``skd::rms_qkv_core``.  CPU tensors run ``rms_qkv_core_plain``; CUDA
    tensors launch the kernel or raise."""
    return rms_qkv_core_op(x, g_rms, w_qkv, g_qkv, heads, dim_head)


def outproj_block_plan(dtype: torch.dtype, hd: int, f: int,
                       nodes: int = node_mix_sm90.N_NODES) -> node_mix_sm90.BlockPlan:
    """The tile plan of the outproj_block kernel (out-projection hd → f, then
    the block's two f → f products) at ``nodes`` nodes; raises for what the
    kernel does not take."""
    return node_mix_sm90.block_plan("outproj_block", dtype, f, (hd, f, f), nodes)


def _outproj_block_checked(a, x, film, w_out, g_out, w1, b1, g1, w2, b2, g2):
    n, rows, hd = a.shape
    f = x.shape[-1]
    plan = outproj_block_plan(x.dtype, hd, f, n)
    shapes = dict(a=(n, rows, hd), x=(n, rows, f), w_out=(n, hd, f), g_out=(n, n),
                  **_block_shapes(n, f))
    tensors = dict(a=a, x=x, film=film, w_out=w_out, g_out=g_out, w1=w1, b1=b1, g1=g1, w2=w2,
                   b2=b2, g2=g2)
    node_mix_sm90.check("outproj_block", tensors, shapes, x.dtype)
    return tensors, shapes, plan


def _outproj_block_launch(*args):
    global launches_outproj_block
    tensors, shapes, plan = _outproj_block_checked(*args)
    a, x = args[0], args[1]
    n, rows, hd = a.shape
    f = x.shape[-1]
    out = torch.empty_like(x)
    whole = ("groups", f, f)  # one tile of all f columns a bank
    node_mix_sm90.launch("layer_fused", "outproj_block", tensors, shapes,
                         {"w_out": whole, "w1": whole, "w2": whole},
                         (n, rows, hd, f, *plan), out)
    launches_outproj_block += 1
    return out


def _outproj_block_fake(*args):
    if build.on_cuda(*args):
        _outproj_block_checked(*args)
    return torch.empty_like(args[1])


outproj_block_op = build.kernel_op(
    "outproj_block", "(Tensor a, Tensor x, Tensor film, Tensor w_out, Tensor g_out, Tensor w1, "
    "Tensor b1, Tensor g1, Tensor w2, Tensor b2, Tensor g2) -> Tensor", outproj_block_plain,
    _outproj_block_launch, _outproj_block_fake)


def outproj_block(a, x, film, w_out, g_out, w1, b1, g1, w2, b2, g2) -> torch.Tensor:
    """a [N,B,hd], x [N,B,F], film [2F], w_out [N,hd,F], g_out [N,N], the
    next block's banks as ``stem_block`` takes them → [N,B,F], through the op
    ``skd::outproj_block``.  CPU tensors run ``outproj_block_plain``; CUDA
    tensors launch the kernel or raise."""
    return outproj_block_op(a, x, film, w_out, g_out, w1, b1, g1, w2, b2, g2)
