"""Graph-structural linear layer: per-node-type weight banks mixed across the
skeleton by a learnable, row-L1-normalized influence matrix G.

Port of ``skeletondiffusion_tpu/ops/graph_linear.py`` (reference
``StaticGraphLinear``, `src/core/network/layers/graph_structural.py:7-114`),
node-major only: activations are ``[N, B, F]`` and

    y = G · (x·W[type] + b[type])

is one batched matmul over nodes followed by one [N,N]·[N, B·F] matmul.
Weights keep the JAX layout ``[types, in, out]`` and the flax parameter names.
With ``compute_dtype`` (e.g. ``torch.bfloat16``) the parameters stay float32
and x, W, b and G are cast to it where the flax module casts them, so the
products, the mix and the output run in that dtype.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from .initializers import graph_linear_bias, graph_linear_weight, torch_linear


def l1_normalize_rows(g: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """torch ``F.normalize(p=1, dim=1)``: each row over max(‖row‖₁, eps)
    (`graph_structural.py:30-32`)."""
    return g / torch.clamp(g.abs().sum(dim=1, keepdim=True), min=eps)


def gmm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Per-node matmul in the batch-major layout: [B,N,i]·[N,i,o] → [B,N,o]
    (reference `graph_structural.py:7-8`, the weight as [N,in,out])."""
    return torch.einsum("bni,nio->bno", x, w)


def gmm_nm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Node-major per-node matmul: [N,B,i]·[N,i,o] → [N,B,o]."""
    return torch.bmm(x, w)


def gmix_nm(g: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Influence mix [N,N]·[N,B,F] → [N,B,F] as one [N, B·F] matmul."""
    n, b, f = x.shape
    return (g @ x.reshape(n, b * f)).reshape(g.shape[0], b, f)


def type_index(node_types: Optional[np.ndarray], num_nodes: int):
    """(index [N] of each node's weight bank, number of banks)."""
    if node_types is None:
        return np.zeros(num_nodes, dtype=np.int64), 1
    nt = np.asarray(node_types, dtype=np.int64)
    return nt, int(nt.max()) + 1


class StaticGraphLinear(nn.Module):
    """Parameters ``weight`` [types,in,out], ``bias`` [types,out] and, with
    ``learn_influence``, ``G`` [N,N] (identity init, L1-normalized at use)."""

    def __init__(
        self,
        in_features: int,
        out_features: int,
        num_nodes: int,
        generator: torch.Generator,
        node_types: Optional[np.ndarray] = None,
        learn_influence: bool = False,
        use_bias: bool = True,
        compute_dtype: Optional[torch.dtype] = None,
    ):
        super().__init__()
        self.compute_dtype = compute_dtype
        index, n_types = type_index(node_types, num_nodes)
        self.register_buffer("type_index", torch.as_tensor(index), persistent=False)
        self.weight = nn.Parameter(
            graph_linear_weight(n_types, in_features, out_features, generator)
        )
        self.bias = (
            nn.Parameter(graph_linear_bias(n_types, in_features, out_features, generator))
            if use_bias else None
        )
        self.G = nn.Parameter(torch.eye(num_nodes)) if learn_influence else None

    def influence(self) -> Optional[torch.Tensor]:
        """The row-normalized G (float32), or None for the identity."""
        return None if self.G is None else l1_normalize_rows(self.G)

    def _cast(self, t: torch.Tensor) -> torch.Tensor:
        return t if self.compute_dtype is None else t.to(self.compute_dtype)

    def partial(self, x: torch.Tensor, input_offset: int = 0) -> torch.Tensor:
        """Weight product of an input SLICE (columns ``input_offset:`` …
        ``+x.shape[-1]``) without bias or G — the hoisted conditioning
        product that re-enters ``forward`` as ``partial_in``; in the compute
        dtype."""
        w = self.weight[:, input_offset : input_offset + x.shape[-1]]
        return gmm_nm(self._cast(x), self._cast(w[self.type_index]))

    def forward(
        self,
        x: torch.Tensor,
        input_offset: int = 0,
        partial_in: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        out = self.partial(x, input_offset)
        if partial_in is not None:
            out = out + partial_in.to(out.dtype)
        if self.bias is not None:
            out = out + self._cast(self.bias[self.type_index])[:, None, :]
        g = self.influence()
        return out if g is None else gmix_nm(self._cast(g), out)


class Dense(nn.Module):
    """flax ``nn.Dense``: ``x @ kernel + bias`` with ``kernel`` [in,out], the
    reference ``nn.Linear`` init."""

    def __init__(self, in_features: int, out_features: int, generator: torch.Generator):
        super().__init__()
        self.kernel = nn.Parameter(torch_linear((in_features, out_features), in_features, generator))
        self.bias = nn.Parameter(torch_linear((out_features,), in_features, generator))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x @ self.kernel + self.bias


class DynamicGraphLinear(nn.Module):
    """Graph linear whose influence matrix is chosen per call: an explicit
    ``g``, or the sub-graph ``G[t][:, t]`` of the learnable full-size G for a
    node-id vector ``t``; reference `graph_structural.py:46-54`, JAX
    `graph_linear.py:152-183`.  Batch-major ``[B, N, F]``; one weight bank
    and bias for every node.  Parameters ``weight`` [1,in,out], ``G``
    [max_nodes, max_nodes] (identity init, not normalized at use) and
    ``bias`` [1,out]."""

    def __init__(self, in_features: int, out_features: int, max_nodes: int,
                 generator: torch.Generator, use_bias: bool = True):
        super().__init__()
        self.weight = nn.Parameter(graph_linear_weight(1, in_features, out_features, generator))
        self.G = nn.Parameter(torch.eye(max_nodes))
        self.bias = (nn.Parameter(graph_linear_bias(1, in_features, out_features, generator))
                     if use_bias else None)

    def forward(self, x: torch.Tensor, g: Optional[torch.Tensor] = None,
                t: Optional[torch.Tensor] = None) -> torch.Tensor:
        if g is None and t is None:
            raise ValueError("Either Graph Influence Matrix or Node Type Vector is needed")
        if g is None:
            t = torch.as_tensor(t, device=self.G.device)
            g = self.G[t][:, t]
        out = x @ self.weight[0]
        if self.bias is not None:
            out = out + self.bias[0]
        return torch.einsum("nm,bmo->bno", g, out)
