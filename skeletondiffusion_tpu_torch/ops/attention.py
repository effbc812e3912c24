"""Attention over the joint axis and FiLM'd graph-linear blocks — the
denoiser's building blocks, node-major ``[N, B, F]``.

Port of ``skeletondiffusion_tpu/ops/attention.py`` (reference
`src/core/network/layers/attention.py`).  Plain PyTorch: the fused TPU
kernels of these blocks (the bf16 path) are not ported yet.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from .graph_linear import Dense, StaticGraphLinear


class RMSNorm(nn.Module):
    """x/max(‖x‖₂, 1e-12) · g · √dim over the feature axis; reference
    `attention.py:30-36`."""

    def __init__(self, dim: int):
        super().__init__()
        self.dim = dim
        self.g = nn.Parameter(torch.ones(1, 1, dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        norm = torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True), min=1e-12)
        return x / norm * self.g * (self.dim ** 0.5)


class Attention(nn.Module):
    """Multi-head attention across the node axis with graph-linear qkv/out
    projections; reference `attention.py:105-136`."""

    def __init__(self, dim: int, num_nodes: int, generator: torch.Generator, heads: int = 4,
                 dim_head: int = 32, node_types: Optional[np.ndarray] = None,
                 learn_influence: bool = False):
        super().__init__()
        self.heads, self.dim_head = heads, dim_head
        hidden = heads * dim_head
        common = dict(num_nodes=num_nodes, generator=generator, node_types=node_types,
                      learn_influence=learn_influence, use_bias=False)
        self.to_qkv = StaticGraphLinear(dim, hidden * 3, **common)
        self.to_out = StaticGraphLinear(hidden, dim, **common)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, b = x.shape[0], x.shape[1]
        q, k, v = self.to_qkv(x).chunk(3, dim=-1)
        shape4 = (n, b, self.heads, self.dim_head)
        q = q.reshape(shape4) * (self.dim_head ** -0.5)
        k = k.reshape(shape4)
        v = v.reshape(shape4)
        sim = torch.einsum("nbhc,mbhc->bhnm", q, k)
        attn = torch.softmax(sim, dim=-1)
        out = torch.einsum("bhnm,mbhc->nbhc", attn, v).reshape(n, b, -1)
        return self.to_out(out)


class PreNormAttentionResidual(nn.Module):
    """x + Attention(RMSNorm(x)); reference `attention.py:11-17,38-46`."""

    def __init__(self, dim: int, num_nodes: int, generator: torch.Generator, **attn_kwargs):
        super().__init__()
        self.norm = RMSNorm(dim)
        self.attn = Attention(dim, num_nodes, generator, **attn_kwargs)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.attn(self.norm(x)) + x


class Block(nn.Module):
    """graph-linear → FiLM scale/shift → tanh; reference `attention.py:49-75`."""

    def __init__(self, dim: int, dim_out: int, **glin_kwargs):
        super().__init__()
        self.proj = StaticGraphLinear(dim, dim_out, **glin_kwargs)

    def forward(self, x: torch.Tensor, scale_shift=None) -> torch.Tensor:
        x = self.proj(x)
        if scale_shift is not None:
            scale, shift = scale_shift
            x = x * (scale + 1) + shift
        return torch.tanh(x)


class ResnetBlock(nn.Module):
    """Two FiLM'd blocks + graph-linear residual; reference `attention.py:78-102`."""

    def __init__(self, dim: int, dim_out: int, time_emb_dim: int, num_nodes: int,
                 generator: torch.Generator, node_types: Optional[np.ndarray] = None,
                 learn_influence: bool = False):
        super().__init__()
        common = dict(num_nodes=num_nodes, generator=generator, node_types=node_types,
                      learn_influence=learn_influence)
        self.mlp = Dense(time_emb_dim, dim_out * 2, generator)
        self.block1 = Block(dim, dim_out, **common)
        self.block2 = Block(dim_out, dim_out, **common)
        self.res_linear = (
            StaticGraphLinear(dim, dim_out, use_bias=False, **common) if dim != dim_out else None
        )

    def forward(self, x: torch.Tensor, time_emb: torch.Tensor) -> torch.Tensor:
        # [B|1, C] → [1, B|1, C]: broadcast over the node axis
        t = self.mlp(torch.tanh(time_emb))[None]
        h = self.block1(x, scale_shift=t.chunk(2, dim=-1))
        h = self.block2(h)
        return h + (x if self.res_linear is None else self.res_linear(x))


def sinusoidal_pos_emb(t: torch.Tensor, dim: int, theta: float = 10000.0) -> torch.Tensor:
    """1-D sinusoidal time embedding [B] → [B, dim] (float32 throughout, as the
    JAX package computes it)."""
    half_dim = dim // 2
    emb = torch.log(torch.tensor(theta, dtype=torch.float32)) / (half_dim - 1)
    emb = torch.exp(torch.arange(half_dim, dtype=torch.float32) * -emb).to(t.device)
    emb = t.to(torch.float32)[:, None] * emb[None, :]
    return torch.cat([torch.sin(emb), torch.cos(emb)], dim=-1)
