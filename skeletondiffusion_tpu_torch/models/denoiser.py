"""Joint-graph Denoiser over per-joint latents.

Port of ``skeletondiffusion_tpu/models/denoiser.py`` (reference
`src/core/network/nn/generator.py:8-107`): graph-linear stem → sinusoidal
time MLP → depth×2 pairs of (FiLM'd ResnetBlock, joint-attention residual)
with the last pair's attention replaced by identity → long skip-concat →
final ResnetBlock → graph-linear head.  It runs node-major ``[N,B,F]`` —
the sampler's layout — and always takes the conditioning as the hoisted
product of ``cond_embedding`` (the flax module's ``u_cond`` path); submodule
and parameter names are the flax ones, so the weight bridge is a copy.  No
self-conditioning (no shipped config uses it).

``compute_dtype`` (e.g. ``torch.bfloat16``) runs the network in that dtype as
the flax module does (`models/denoiser.py:94-106`): parameters stay float32,
the input, the graph linears and the FiLM rows are cast, the time MLP stays
float32, and the output is float32.  This plain forward is the counterpart
of the JAX package's XLA bf16 path; the prediction path runs the same
weights through the fused kernels (``ops/kernels/denoiser_fused.py``).
"""
from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch
from torch import nn

from ..ops.attention import PreNormAttentionResidual, ResnetBlock, sinusoidal_pos_emb
from ..ops.graph_linear import Dense, StaticGraphLinear


class Denoiser(nn.Module):
    """``dim`` latent size, ``cond_dim`` conditioning size (0 without
    conditioning), ``channels`` the number of nodes N (reference naming)."""

    def __init__(
        self,
        dim: int,
        out_dim: int,
        channels: int,
        generator: torch.Generator,
        cond_dim: int = 0,
        depth: int = 1,
        node_types: Optional[np.ndarray] = None,
        learn_influence: bool = False,
        attn_dim_head: int = 32,
        attn_heads: int = 4,
        sinusoidal_pos_emb_theta: float = 10000.0,
        compute_dtype: Optional[torch.dtype] = None,
    ):
        super().__init__()
        self.dim, self.cond_dim = dim, cond_dim
        self.compute_dtype = compute_dtype
        self.attn_heads, self.attn_dim_head = attn_heads, attn_dim_head
        self.theta = sinusoidal_pos_emb_theta
        size = dim + cond_dim
        time_dim = size * 4
        common = dict(num_nodes=channels, generator=generator, node_types=node_types,
                      learn_influence=learn_influence, compute_dtype=compute_dtype)
        self.init_lin = StaticGraphLinear(dim + cond_dim, size, **common)
        self.time_mlp0 = Dense(size, time_dim, generator)
        self.time_mlp1 = Dense(time_dim, time_dim, generator)
        self.n_pairs = 2 * depth
        for i in range(self.n_pairs):
            self.add_module(f"res{i}", ResnetBlock(size, size, time_dim, **common))
            if i != self.n_pairs - 1:
                self.add_module(f"attn{i}", PreNormAttentionResidual(
                    size, heads=attn_heads, dim_head=attn_dim_head, **common))
        self.final_res_block = ResnetBlock(size * 2, size, time_dim, **common)
        self.final_glin = StaticGraphLinear(size, out_dim, **common)

    def cond_embedding(self, x_cond: torch.Tensor) -> torch.Tensor:
        """The loop-invariant conditioning half of the stem, node-major
        [N,B,size] in the compute dtype: the sampler computes it once and
        passes it as ``u_cond``."""
        return self.init_lin.partial(x_cond.transpose(0, 1), input_offset=0)

    def time_embedding(self, time: Union[int, torch.Tensor], device: torch.device) -> torch.Tensor:
        """Sinusoidal embedding → Dense → exact (erf) GELU → Dense, float32:
        [1 | B, 4·(dim+cond_dim)]."""
        time = torch.as_tensor(time, device=device).reshape(-1)
        t = sinusoidal_pos_emb(time, self.dim + self.cond_dim, self.theta)
        t = self.time_mlp0(t)
        t = nn.functional.gelu(t, approximate="none")
        return self.time_mlp1(t)

    def forward(
        self,
        x: torch.Tensor,
        time: Union[int, torch.Tensor],
        u_cond: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """Node-major forward: x [N,B,dim] and the conditioning product
        ``u_cond`` [N,B,dim+cond_dim] of ``cond_embedding`` → [N,B,out_dim].
        ``time`` is one step shared by the batch (an int) or a [B] tensor."""
        if self.cond_dim and u_cond is None:
            raise ValueError("a conditioned denoiser needs u_cond (see cond_embedding)")
        if self.compute_dtype is not None:
            x = x.to(self.compute_dtype)
        x = self.init_lin(x, input_offset=self.cond_dim, partial_in=u_cond)
        r = x

        t = self.time_embedding(time, x.device)

        for i in range(self.n_pairs):
            x = getattr(self, f"res{i}")(x, t)
            if i != self.n_pairs - 1:
                x = getattr(self, f"attn{i}")(x)

        x = self.final_res_block(torch.cat([x, r], dim=-1), t)
        return self.final_glin(x).float()
