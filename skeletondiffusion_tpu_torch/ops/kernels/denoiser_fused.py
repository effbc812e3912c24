"""The denoiser forward of the sampling path as a chain of CUDA kernels.

Port of ``skeletondiffusion_tpu/ops/pallas/denoiser_fused.py``
(``prep_fused_denoiser``, ``fused_denoiser_core_nm``): the same computation
as ``models.denoiser.Denoiser.forward`` on its hoisted-conditioning path,
node-major ``[N, B, ·]`` from end to end, with one kernel per stage:

    stem        graph_linear_fused   (B4)   x·W + b + u, G mix
    2·depth ×   resnet_block         (B1)   with, between two of them,
    2·depth−1 × rms_qkv → attention_core → outproj_res   (B3a, B2, B3b)
    final       final_block_in → final_block_out          (B5a, B5b)

or, with the environment variable ``SKELDIFF_LAYER_FUSED=1`` (read at each
call, as the JAX package reads it; default ``0``), one kernel per layer
(``layer_fused.py``):

    stem + block 0            stem_block      (B9a)
    2·depth−1 ×               rms_qkv_core → outproj_block + next block
                                              (B9b, B9c)
    final                     final_block_in → final_block_out   (B5a, B5b)

``prep_fused_denoiser`` gathers every weight-side operand once (the caller
keeps it across calls); ``fused_denoiser_core_nm`` computes the time MLP and
the FiLM rows (float32, a few [1, ·] products) and runs the kernels.  The
TPU's 128/256-lane feature padding and the batch padding to a tile multiple
are gone; the widths are padded only to the kernels' granules
(``chain_widths``), as the JAX prep pads its own to the TPU's lanes: F =
dim + cond_dim to a multiple of 64 (the engine's column tiles), the latent D
and the head's output columns to multiples of 8 (whole 16-byte chunks), and
each head's dh to the attention kernels' width (16, 32, 64 or 128).  The pad
columns of every bank, bias, gain and FiLM row are zero, so the pad features
stay 0 through every stage (the RMSNorm gain keeps the true √F); the chain
runs on the padded widths and its output is sliced back.  At the flagship's
widths (F 192, D 96, 8 heads × 32) nothing is padded.  A ragged last row
tile is masked by the kernels.  On the CPU every wrapper runs its plain
PyTorch version, padding included.
"""
from __future__ import annotations

import os
from typing import TYPE_CHECKING, Dict, List, NamedTuple, Optional, Union

import torch
from torch.nn.functional import pad

from ...parallel.mesh import MODEL_AXIS_TRAINING_ONLY
from . import attention_proj, build, graph_linear_fused, joint_attention, layer_fused, resnet_block

if TYPE_CHECKING:  # the module runs on the modules it is given and imports none of them
    from ...models.denoiser import Denoiser
    from ..graph_linear import StaticGraphLinear


F_GRANULE = 64  # the engine's column tiles (node_mix_sm90.block_plan)
D_GRANULE = 8   # whole 16-byte chunks of a bf16 row (node_mix_sm90.narrow_width)


def _up(n: int, granule: int) -> int:
    return -(-n // granule) * granule


class ChainWidths(NamedTuple):
    """The denoiser's widths and the chain's padded ones: F = dim +
    cond_dim, the latent D, the head's output columns, heads × dh and the
    kernels' head width W."""
    f: int
    f_pad: int
    d: int
    d_pad: int
    out: int
    out_pad: int
    heads: int
    dim_head: int
    width: int


def chain_widths(den: "Denoiser") -> ChainWidths:
    f, d, out = den.dim + den.cond_dim, den.dim, den.final_glin.weight.shape[-1]
    return ChainWidths(f, _up(f, F_GRANULE), d, _up(d, D_GRANULE), out, _up(out, D_GRANULE),
                       den.attn_heads, den.attn_dim_head,
                       joint_attention.head_width(den.attn_dim_head))


def _pad_to(t: torch.Tensor, *sizes: int) -> torch.Tensor:
    """``t`` zero-padded at the end of its trailing axes to ``sizes``."""
    pads: List[int] = []
    for size, n in zip(reversed(sizes), reversed(t.shape)):
        pads += [0, size - n]
    return pad(t, pads) if any(pads) else t


def _pad_heads(w: torch.Tensor, axis: int, heads: int, dim_head: int, width: int
               ) -> torch.Tensor:
    """Axis ``axis`` of w, [parts·heads·dim_head], with each head's
    dim_head entries zero-padded to ``width``."""
    if width == dim_head:
        return w
    shape = w.shape
    w = w.reshape(*shape[:axis], -1, dim_head, *shape[axis + 1:])
    w = pad(w, [0, 0] * (len(shape) - axis - 1) + [0, width - dim_head])
    return w.reshape(*shape[:axis], -1, *shape[axis + 1:])


def pad_condition(prepped: Dict, u: torch.Tensor) -> torch.Tensor:
    """The hoisted conditioning product u [N,B,F] at the chain's padded
    width, in its compute dtype: the sampler pads it once a call."""
    return _pad_to(u.to(prepped["dtype"]), prepped["widths"].f_pad).contiguous()


def _influence(lin: "StaticGraphLinear", n: int) -> torch.Tensor:
    g = lin.influence()
    return torch.eye(n, device=lin.weight.device) if g is None else g


def _banks(lin: "StaticGraphLinear", dt: torch.dtype, rows: Optional[slice] = None) -> Dict:
    """Per-node weight bank (rows ``rows`` of its input side), bias and
    row-normalized G of a graph linear, cast to ``dt`` and contiguous."""
    w = lin.weight[lin.type_index]
    if rows is not None:
        w = w[:, rows]
    n = w.shape[0]
    out = {"w": w.to(dt).contiguous(), "g": _influence(lin, n).to(dt).contiguous()}
    if lin.bias is not None:
        out["b"] = lin.bias[lin.type_index].to(dt).contiguous()
    return out


def chain_plans(den: "Denoiser") -> List:
    """Every plan the kernel chain makes for ``den``'s padded widths
    (``chain_widths``), node count and compute dtype, on both chains (the
    environment picks one at each call): B4, B1, B3a, B2, B3b, B9a, B9b,
    B9c, B5a and B5b through their own plan functions.  Raises the first
    plan's ValueError, with the widths it was asked for, where a kernel
    does not take the denoiser; nothing is built or launched."""
    dt = den.compute_dtype or torch.float32
    n = den.init_lin.type_index.numel()
    w = chain_widths(den)
    f, heads, width = w.f_pad, w.heads, w.width
    hd = heads * width
    try:
        plans = [graph_linear_fused.graph_linear_fused_plan(dt, w.d_pad, f, n),
                 resnet_block.resnet_block_plan(dt, f, n),
                 layer_fused.stem_block_plan(dt, w.d_pad, f, n),
                 resnet_block.final_block_in_plan(dt, f, n),
                 resnet_block.final_block_out_plan(dt, f, w.out_pad, n)]
        if den.n_pairs > 1:  # the attention layers between the blocks
            plans += [attention_proj.rms_qkv_plan(dt, f, 3 * hd, n),
                      joint_attention.attention_plan(dt, heads, width, n),
                      attention_proj.outproj_res_plan(dt, hd, f, n),
                      layer_fused.rms_qkv_core_plan(dt, f, heads, width, n),
                      layer_fused.outproj_block_plan(dt, hd, f, n)]
    except ValueError as e:
        raise ValueError(f"{e} [the chain's widths: F {w.f} → {w.f_pad}, D {w.d} → {w.d_pad}, "
                         f"{heads} heads of {w.dim_head} → {width}]") from None
    return plans


def chain_refusal(den: "Denoiser", device: torch.device) -> Optional[str]:
    """Why the kernel chain does not take ``den`` on ``device``, or None
    where it does: the JAX predictor's conditions (bf16, attention, no
    self-conditioning; the caller adds the hoisted conditioning), then, on
    a CUDA device, every plan of ``chain_plans`` at its widths (on the CPU
    each kernel of the chain is its plain version, which takes every
    width)."""
    if den.compute_dtype != torch.bfloat16:
        return f"the chain is bf16-compute only, the denoiser computes in {den.compute_dtype}"
    if not den.use_attention:
        return "the chain runs a denoiser with attention"
    if den.self_condition:
        return "the chain runs no self-conditioning"
    if device.type == "cuda":
        try:  # plans only: no kernel is built or launched here
            chain_plans(den)
        except ValueError as e:
            return str(e)
    return None


@torch.no_grad()
def prep_fused_denoiser(den: "Denoiser") -> Dict:
    """Every weight-side operand of the fused forward, in the denoiser's
    compute dtype (float32 when it has none), zero-padded to the chain's
    widths (``chain_widths``); FiLM projections and the time MLP stay
    float32 module references (they depend on t)."""
    if any(getattr(m, "_model_shards", None) for m in den.modules()):
        raise NotImplementedError(f"the fused denoiser kernels: {MODEL_AXIS_TRAINING_ONLY}")
    dt = den.compute_dtype or torch.float32
    w = chain_widths(den)
    f, fp = w.f, w.f_pad

    def square(lin) -> Dict:  # an F → F graph linear, padded to Fp → Fp
        b = _banks(lin, dt)
        return dict(w=_pad_to(b["w"], fp, fp).contiguous(), b=_pad_to(b["b"], fp).contiguous(),
                    g=b["g"])

    blocks: List[Dict] = []
    for i in range(den.n_pairs):
        blk = getattr(den, f"res{i}")
        b1, b2 = square(blk.block1.proj), square(blk.block2.proj)
        blocks.append(dict(w1=b1["w"], b1=b1["b"], g1=b1["g"], w2=b2["w"], b2=b2["b"],
                           g2=b2["g"], film=blk.mlp))
    attns: List[Dict] = []
    for i in range(den.n_pairs - 1):
        att = getattr(den, f"attn{i}")
        qkv, out = _banks(att.attn.to_qkv, dt), _banks(att.attn.to_out, dt)
        heads = (w.heads, w.dim_head, w.width)
        # the RMSNorm gain with the true √F folded in (`denoiser_fused.py:130`);
        # its pad entries zero, so the normalised pad features are too
        g_rms = _pad_to(att.norm.g.reshape(f) * (f ** 0.5), fp).to(dt).contiguous()
        w_qkv = _pad_to(_pad_heads(qkv["w"], 2, *heads), fp, 3 * w.heads * w.width)
        w_out = _pad_to(_pad_heads(out["w"], 1, *heads), w.heads * w.width, fp)
        attns.append(dict(g_rms=g_rms, w_qkv=w_qkv.contiguous(), g_qkv=qkv["g"],
                          w_out=w_out.contiguous(), g_out=out["g"]))
    # the latent half of the stem (its conditioning half is the hoisted u)
    stem = _banks(den.init_lin, dt, rows=slice(den.cond_dim, den.cond_dim + den.dim))
    stem = dict(w=_pad_to(stem["w"], w.d_pad, fp).contiguous(),
                b=_pad_to(stem["b"], fp).contiguous(), g=stem["g"])
    head = _banks(den.final_glin, dt)
    head = dict(w=_pad_to(head["w"], fp, w.out_pad).contiguous(),
                b=_pad_to(head["b"], w.out_pad).contiguous(), g=head["g"])
    fb = den.final_res_block

    def rect(lin) -> Dict:  # [2F, F] banks: rows :F act on x, F: on the long skip
        b = _banks(lin, dt)
        halves = [_pad_to(half, fp, fp) for half in b["w"].split(f, dim=1)]
        out = dict(w=torch.cat(halves, dim=1).contiguous(), g=b["g"])
        if "b" in b:
            out["b"] = _pad_to(b["b"], fp).contiguous()
        return out

    b1, br, b2 = rect(fb.block1.proj), rect(fb.res_linear), square(fb.block2.proj)
    final = dict(w1=b1["w"], b1=b1["b"], g1=b1["g"], wr=br["w"], gr=br["g"], w2=b2["w"],
                 b2=b2["b"], g2=b2["g"], film=fb.mlp)
    return {"dtype": dt, "widths": w, "blocks": blocks, "attns": attns, "stem": stem,
            "head": head, "final": final}


def _block_banks(blk: Dict):
    """A ResnetBlock's w1, b1, g1, w2, b2, g2, in the kernels' order."""
    return blk["w1"], blk["b1"], blk["g1"], blk["w2"], blk["b2"], blk["g2"]


def _film(mlp, tt: torch.Tensor, dt: torch.dtype, f_pad: int) -> torch.Tensor:
    """The block's scalar-time FiLM row scale‖shift [2F]: fp32, then cast
    (`denoiser_fused.py:224-234`), each half zero-padded to ``f_pad``
    (`resnet_block.py::pad_film`)."""
    scale, shift = mlp(tt).reshape(2, -1)
    return _pad_to(torch.stack([scale, shift]), f_pad).reshape(-1).to(dt).contiguous()


@build.without_grad
def fused_denoiser_core_nm(
    den: "Denoiser",
    x_nm: torch.Tensor,              # [N, B, D] node-major latents (float32)
    time: Union[int, torch.Tensor],  # one step for the whole batch
    u: torch.Tensor,                 # [N, B, F] hoisted conditioning product (or padded)
    prepped: Optional[Dict] = None,
) -> torch.Tensor:
    """The denoiser forward → [N, B, out_dim] in the compute dtype.  ``u``
    may come padded already (``pad_condition``, once a sampling call);
    else it is padded here."""
    if prepped is None:
        prepped = prep_fused_denoiser(den)
    dt, w = prepped["dtype"], prepped["widths"]
    tt = torch.tanh(den.time_embedding(time, x_nm.device))  # [1, time_dim] float32

    def film(blk):
        return _film(blk["film"], tt, dt, w.f_pad)

    stem, blocks = prepped["stem"], prepped["blocks"]
    x_in = _pad_to(x_nm.to(dt), w.d_pad).contiguous()
    u_in = u.contiguous() if u.dtype == dt and u.shape[-1] == w.f_pad else pad_condition(
        prepped, u)
    heads = dict(heads=w.heads, dim_head=w.dim_head)
    if os.environ.get("SKELDIFF_LAYER_FUSED", "0") == "1":
        b0 = blocks[0]
        rp, xp = layer_fused.stem_block(x_in, u_in, film(b0), stem["w"], stem["b"], stem["g"],
                                        *_block_banks(b0))
        for a, blk in zip(prepped["attns"], blocks[1:]):
            core = layer_fused.rms_qkv_core(xp, a["g_rms"], a["w_qkv"], a["g_qkv"], **heads)
            xp = layer_fused.outproj_block(core, xp, film(blk), a["w_out"], a["g_out"],
                                           *_block_banks(blk))
    else:
        xp = graph_linear_fused.graph_linear_fused(x_in, stem["w"], stem["b"], stem["g"], u_in)
        rp = xp  # the long skip
        for i, blk in enumerate(blocks):
            xp = resnet_block.resnet_block(xp, film(blk), *_block_banks(blk))
            if i < len(prepped["attns"]):
                a = prepped["attns"][i]
                qkv = attention_proj.rms_qkv(xp, a["g_rms"], a["w_qkv"], a["g_qkv"])
                core = joint_attention.attention_core(qkv, **heads)
                xp = attention_proj.outproj_res(core, xp, a["w_out"], a["g_out"])
    fin, head = prepped["final"], prepped["head"]
    h, res = resnet_block.final_block_in(xp, rp, film(fin), fin["w1"], fin["b1"], fin["g1"],
                                         fin["wr"], fin["gr"])
    out = resnet_block.final_block_out(h, res, fin["w2"], fin["b2"], fin["g2"], head["w"],
                                       head["b"], head["g"])
    return out if w.out_pad == w.out else out[..., :w.out]
