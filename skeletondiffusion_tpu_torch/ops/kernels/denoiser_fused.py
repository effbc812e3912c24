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
are gone: F, D and H·dh keep their widths and the kernels mask a ragged last
tile.  On the CPU every wrapper runs its plain PyTorch version.
"""
from __future__ import annotations

import os
from typing import TYPE_CHECKING, Dict, List, Optional, Union

import torch

from ...parallel.mesh import MODEL_AXIS_TRAINING_ONLY
from . import attention_proj, build, graph_linear_fused, joint_attention, layer_fused, resnet_block

if TYPE_CHECKING:  # the module runs on the modules it is given and imports none of them
    from ...models.denoiser import Denoiser
    from ..graph_linear import StaticGraphLinear


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


@torch.no_grad()
def prep_fused_denoiser(den: "Denoiser") -> Dict:
    """Every weight-side operand of the fused forward, in the denoiser's
    compute dtype (float32 when it has none); FiLM projections and the time
    MLP stay float32 module references (they depend on t)."""
    if any(getattr(m, "_model_shards", None) for m in den.modules()):
        raise NotImplementedError(f"the fused denoiser kernels: {MODEL_AXIS_TRAINING_ONLY}")
    dt = den.compute_dtype or torch.float32
    f = den.dim + den.cond_dim
    blocks: List[Dict] = []
    for i in range(den.n_pairs):
        blk = getattr(den, f"res{i}")
        b1, b2 = _banks(blk.block1.proj, dt), _banks(blk.block2.proj, dt)
        blocks.append(dict(w1=b1["w"], b1=b1["b"], g1=b1["g"], w2=b2["w"], b2=b2["b"],
                           g2=b2["g"], film=blk.mlp))
    attns: List[Dict] = []
    for i in range(den.n_pairs - 1):
        att = getattr(den, f"attn{i}")
        qkv, out = _banks(att.attn.to_qkv, dt), _banks(att.attn.to_out, dt)
        # the RMSNorm gain with its √F factor folded in (`denoiser_fused.py:130`)
        g_rms = (att.norm.g.reshape(f) * (f ** 0.5)).to(dt).contiguous()
        attns.append(dict(g_rms=g_rms, w_qkv=qkv["w"], g_qkv=qkv["g"], w_out=out["w"],
                          g_out=out["g"]))
    # the latent half of the stem (its conditioning half is the hoisted u)
    stem = _banks(den.init_lin, dt, rows=slice(den.cond_dim, den.cond_dim + den.dim))
    fb = den.final_res_block
    # [2F, F] banks of the final block: rows :F act on x, F: on the long skip
    b1, br, b2 = _banks(fb.block1.proj, dt), _banks(fb.res_linear, dt), _banks(fb.block2.proj, dt)
    final = dict(w1=b1["w"], b1=b1["b"], g1=b1["g"], wr=br["w"], gr=br["g"], w2=b2["w"],
                 b2=b2["b"], g2=b2["g"], film=fb.mlp)
    return {"dtype": dt, "blocks": blocks, "attns": attns, "stem": stem,
            "head": _banks(den.final_glin, dt), "final": final}


def _block_banks(blk: Dict):
    """A ResnetBlock's w1, b1, g1, w2, b2, g2, in the kernels' order."""
    return blk["w1"], blk["b1"], blk["g1"], blk["w2"], blk["b2"], blk["g2"]


def _film(mlp, tt: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """The block's scalar-time FiLM row scale‖shift [2F]: fp32, then cast
    (`denoiser_fused.py:224-234`)."""
    return mlp(tt).reshape(-1).to(dt).contiguous()


@build.without_grad
def fused_denoiser_core_nm(
    den: "Denoiser",
    x_nm: torch.Tensor,              # [N, B, D] node-major latents (float32)
    time: Union[int, torch.Tensor],  # one step for the whole batch
    u: torch.Tensor,                 # [N, B, F] hoisted conditioning product
    prepped: Optional[Dict] = None,
) -> torch.Tensor:
    """The denoiser forward → [N, B, out_dim] in the compute dtype."""
    if prepped is None:
        prepped = prep_fused_denoiser(den)
    dt = prepped["dtype"]
    tt = torch.tanh(den.time_embedding(time, x_nm.device))  # [1, time_dim] float32

    stem, blocks = prepped["stem"], prepped["blocks"]
    x_in, u_in = x_nm.to(dt).contiguous(), u.to(dt).contiguous()
    if os.environ.get("SKELDIFF_LAYER_FUSED", "0") == "1":
        b0 = blocks[0]
        rp, xp = layer_fused.stem_block(x_in, u_in, _film(b0["film"], tt, dt), stem["w"],
                                        stem["b"], stem["g"], *_block_banks(b0))
        for a, blk in zip(prepped["attns"], blocks[1:]):
            core = layer_fused.rms_qkv_core(xp, a["g_rms"], a["w_qkv"], a["g_qkv"],
                                            heads=den.attn_heads, dim_head=den.attn_dim_head)
            xp = layer_fused.outproj_block(core, xp, _film(blk["film"], tt, dt), a["w_out"],
                                           a["g_out"], *_block_banks(blk))
    else:
        xp = graph_linear_fused.graph_linear_fused(x_in, stem["w"], stem["b"], stem["g"], u_in)
        rp = xp  # the long skip
        for i, blk in enumerate(blocks):
            xp = resnet_block.resnet_block(xp, _film(blk["film"], tt, dt), *_block_banks(blk))
            if i < len(prepped["attns"]):
                a = prepped["attns"][i]
                qkv = attention_proj.rms_qkv(xp, a["g_rms"], a["w_qkv"], a["g_qkv"])
                core = joint_attention.attention_core(qkv, heads=den.attn_heads,
                                                      dim_head=den.attn_dim_head)
                xp = attention_proj.outproj_res(core, xp, a["w_out"], a["g_out"])
    fin, head = prepped["final"], prepped["head"]
    h, res = resnet_block.final_block_in(xp, rp, _film(fin["film"], tt, dt), fin["w1"],
                                         fin["b1"], fin["g1"], fin["wr"], fin["gr"])
    return resnet_block.final_block_out(h, res, fin["w2"], fin["b2"], fin["g2"], head["w"],
                                        head["b"], head["g"])
