"""The fused denoiser's ResnetBlocks as CUDA kernels: the square block (one
kernel) and the rectangular 2F→F final block with the output head (two).

Node-major [N, B, F] activations, per-node banks [N, in, out], biases
[N, out], row-normalized influences [N, N] and the block's scalar-time FiLM
row ``film`` = scale‖shift [2F], all in one element type (bf16 on the
prediction path; fp32 is instantiated too); sums in fp32, round() to that
type where the Pallas kernels materialise:

    resnet_block:     h   = round(tanh(FiLM(G1·round(x·W1 + b1))))
                      out = round(tanh(G2·round(h·W2 + b2)) + x)
    final_block_in:   h   = round(tanh(FiLM(G1·round([x‖r]·W1 + b1))))
                      res = round(Gr·round([x‖r]·Wr))
    final_block_out:  o   = round(tanh(G2·round(h·W2 + b2)) + res)
                      out = round(Gh·round(o·Wh + bh))

with FiLM(y) = y·(scale + 1) + shift in fp32 from the bf16 row.  Ports of
``skeletondiffusion_tpu/ops/pallas/resnet_block.py::resnet_block_pallas_padded``
(``_resnet_kernel``) and ``final_block_head_pallas_padded``
(``_rect_in_kernel``, ``_rect_out_head_kernel``) without the TPU's padding; the
kernels are ``csrc/resnet_block.cu``, all three on the engine of
``csrc/node_mix_sm90.cuh``.  Each wrapper hands its kernel the banks packed
into one tile of all F columns each (``node_mix_sm90.pack_banks``, cached
per bank; the head's [F, O] bank and its bias zero-padded to F columns)
and its tile plan (``resnet_block_plan``, ``final_block_in_plan``,
``final_block_out_plan``).  The final block's [2F, F] banks stay whole: rows
:F act on x and F: on the long skip r, k-slices the kernel reads from x and
from r, so x‖r is never written out.
"""
from __future__ import annotations

import torch

from . import build, node_mix_sm90
from .graph_linear_fused import mix_plain, product_plain

launches_block = 0
launches_final_in = 0
launches_final_out = 0


def film_plain(y: torch.Tensor, film: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """round(tanh(y·(scale+1) + shift)) for fp32 y and film [2F], in fp32."""
    f = y.shape[-1]
    scale = film[:f].float() + 1.0
    return torch.tanh(y * scale + film[f:].float()).to(dt)


def resnet_block_plain(x, film, w1, b1, g1, w2, b2, g2) -> torch.Tensor:
    dt = x.dtype
    h = film_plain(mix_plain(g1, product_plain(x, w1, b1).to(dt)), film, dt)
    h2 = mix_plain(g2, product_plain(h, w2, b2).to(dt))
    return (torch.tanh(h2) + x.float()).to(dt)


def final_block_in_plain(x, r, film, w1, b1, g1, wr, gr):
    dt = x.dtype
    xr = torch.cat([x, r], dim=-1)
    h = film_plain(mix_plain(g1, product_plain(xr, w1, b1).to(dt)), film, dt)
    res = mix_plain(gr, product_plain(xr, wr).to(dt)).to(dt)
    return h, res


def final_block_out_plain(h, res, w2, b2, g2, wh, bh, gh) -> torch.Tensor:
    dt = h.dtype
    h2 = mix_plain(g2, product_plain(h, w2, b2).to(dt))
    o = (torch.tanh(h2) + res.float()).to(dt)
    return mix_plain(gh, product_plain(o, wh, bh).to(dt)).to(dt)


def resnet_block_plan(dtype: torch.dtype, f: int,
                      nodes: int = node_mix_sm90.N_NODES) -> node_mix_sm90.BlockPlan:
    """The tile plan of the resnet_block kernel at width ``f`` and ``nodes``
    nodes; raises for what the kernel does not take."""
    return node_mix_sm90.block_plan("resnet_block", dtype, f, (f, f), nodes)


def final_block_in_plan(dtype: torch.dtype, f: int,
                        nodes: int = node_mix_sm90.N_NODES) -> node_mix_sm90.BlockPlan:
    """The tile plan of the final_block_in kernel at width ``f`` (both passes
    contract over x‖r, 2F wide) and ``nodes`` nodes; raises for what the
    kernel does not take."""
    return node_mix_sm90.block_plan("final_block_in", dtype, f, (2 * f, 2 * f), nodes)


def final_block_out_plan(dtype: torch.dtype, f: int, fo: int,
                         nodes: int = node_mix_sm90.N_NODES) -> node_mix_sm90.BlockPlan:
    """The tile plan of the final_block_out kernel at width ``f`` with a head
    of ``fo`` columns, at ``nodes`` nodes; raises for what the kernel does
    not take."""
    plan = node_mix_sm90.block_plan("final_block_out", dtype, f, (f, f), nodes)
    node_mix_sm90.check_out_width("final_block_out", dtype, f, fo)
    return plan


def _block_checked(x, film, w1, b1, g1, w2, b2, g2):
    n, rows, f = x.shape
    plan = resnet_block_plan(x.dtype, f, n)
    shapes = dict(x=(n, rows, f), film=(2 * f,), w1=(n, f, f), b1=(n, f), g1=(n, n),
                  w2=(n, f, f), b2=(n, f), g2=(n, n))
    tensors = dict(x=x, film=film, w1=w1, b1=b1, g1=g1, w2=w2, b2=b2, g2=g2)
    node_mix_sm90.check("resnet_block", tensors, shapes, x.dtype)
    return tensors, shapes, plan


def _block_launch(x, film, w1, b1, g1, w2, b2, g2):
    global launches_block
    tensors, shapes, plan = _block_checked(x, film, w1, b1, g1, w2, b2, g2)
    n, rows, f = x.shape
    out = torch.empty_like(x)
    whole = ("groups", f, f)  # one tile of all f columns a bank
    node_mix_sm90.launch("resnet_block", "resnet_block", tensors, shapes,
                         {"w1": whole, "w2": whole}, (n, rows, f, *plan), out)
    launches_block += 1
    return out


def _block_fake(*args):
    if build.on_cuda(*args):
        _block_checked(*args)
    return torch.empty_like(args[0])


resnet_block_op = build.kernel_op(
    "resnet_block", "(Tensor x, Tensor film, Tensor w1, Tensor b1, Tensor g1, Tensor w2, "
    "Tensor b2, Tensor g2) -> Tensor", resnet_block_plain, _block_launch, _block_fake)


def resnet_block(x, film, w1, b1, g1, w2, b2, g2) -> torch.Tensor:
    """x [N,B,F], film [2F], w1, w2 [N,F,F], b1, b2 [N,F], g1, g2 [N,N] →
    [N,B,F], through the op ``skd::resnet_block``.  CPU tensors run
    ``resnet_block_plain``; CUDA tensors launch the kernel or raise."""
    return resnet_block_op(x, film, w1, b1, g1, w2, b2, g2)


def _final_in_checked(x, r, film, w1, b1, g1, wr, gr):
    n, rows, f = x.shape
    plan = final_block_in_plan(x.dtype, f, n)
    shapes = dict(x=(n, rows, f), r=(n, rows, f), film=(2 * f,), w1=(n, 2 * f, f), b1=(n, f),
                  g1=(n, n), wr=(n, 2 * f, f), gr=(n, n))
    tensors = dict(x=x, r=r, film=film, w1=w1, b1=b1, g1=g1, wr=wr, gr=gr)
    node_mix_sm90.check("final_block_in", tensors, shapes, x.dtype)
    return tensors, shapes, plan


def _final_in_launch(x, r, film, w1, b1, g1, wr, gr):
    global launches_final_in
    tensors, shapes, plan = _final_in_checked(x, r, film, w1, b1, g1, wr, gr)
    n, rows, f = x.shape
    h, res = torch.empty_like(x), torch.empty_like(x)
    whole = ("groups", f, f)
    node_mix_sm90.launch("resnet_block", "final_block_in", tensors, shapes,
                         {"w1": whole, "wr": whole}, (n, rows, f, *plan), h, res)
    launches_final_in += 1
    return h, res


def _final_in_fake(*args):
    if build.on_cuda(*args):
        _final_in_checked(*args)
    return torch.empty_like(args[0]), torch.empty_like(args[0])


final_block_in_op = build.kernel_op(
    "final_block_in", "(Tensor x, Tensor r, Tensor film, Tensor w1, Tensor b1, Tensor g1, "
    "Tensor wr, Tensor gr) -> (Tensor, Tensor)", final_block_in_plain, _final_in_launch,
    _final_in_fake)


def final_block_in(x, r, film, w1, b1, g1, wr, gr):
    """x, r [N,B,F], film [2F], w1, wr [N,2F,F], b1 [N,F], g1, gr [N,N] →
    (h, res) [N,B,F] each, through the op ``skd::final_block_in``.  CPU
    tensors run ``final_block_in_plain``; CUDA tensors launch the kernel or
    raise."""
    return final_block_in_op(x, r, film, w1, b1, g1, wr, gr)


def _final_out_checked(h, res, w2, b2, g2, wh, bh, gh):
    n, rows, f = h.shape
    fo = wh.shape[-1]
    plan = final_block_out_plan(h.dtype, f, fo, n)
    shapes = dict(h=(n, rows, f), res=(n, rows, f), w2=(n, f, f), b2=(n, f), g2=(n, n),
                  wh=(n, f, fo), bh=(n, fo), gh=(n, n))
    tensors = dict(h=h, res=res, w2=w2, b2=b2, g2=g2, wh=wh, bh=bh, gh=gh)
    node_mix_sm90.check("final_block_out", tensors, shapes, h.dtype)
    return tensors, shapes, plan


def _final_out_launch(h, res, w2, b2, g2, wh, bh, gh):
    global launches_final_out
    tensors, shapes, plan = _final_out_checked(h, res, w2, b2, g2, wh, bh, gh)
    n, rows, f = h.shape
    fo = wh.shape[-1]
    out = torch.empty((n, rows, fo), dtype=h.dtype, device=h.device)
    # the head is an F-wide pass whose bank and bias are zero past fo
    packs = {"w2": ("groups", f, f), "wh": ("groups", fo, f), "bh": ("pad", f)}
    node_mix_sm90.launch("resnet_block", "final_block_out", tensors, shapes, packs,
                         (n, rows, f, fo, *plan), out)
    launches_final_out += 1
    return out


def _final_out_fake(*args):
    if build.on_cuda(*args):
        _final_out_checked(*args)
    h, wh = args[0], args[5]
    return h.new_empty((*h.shape[:2], wh.shape[-1]))


final_block_out_op = build.kernel_op(
    "final_block_out", "(Tensor h, Tensor res, Tensor w2, Tensor b2, Tensor g2, Tensor wh, "
    "Tensor bh, Tensor gh) -> Tensor", final_block_out_plain, _final_out_launch,
    _final_out_fake)


def final_block_out(h, res, w2, b2, g2, wh, bh, gh) -> torch.Tensor:
    """h, res [N,B,F], w2 [N,F,F], b2 [N,F], wh [N,F,O], bh [N,O], g2, gh
    [N,N] → [N,B,O], through the op ``skd::final_block_out``.  CPU tensors
    run ``final_block_out_plain``; CUDA tensors launch the kernel or
    raise."""
    return final_block_out_op(h, res, w2, b2, g2, wh, bh, gh)
