"""Graph-recurrent GRU: gate pre-activations are mixed across the skeleton
joints by the influence matrix G at every step.

Port of the GRU half of ``skeletondiffusion_tpu/ops/graph_gru.py`` (reference
`src/core/network/layers/recurrent.py:208-402`), node-major ``[N, B, F]``:

    gates_x = G·(x·W_ih[type] + b_ih) ;  gates_h = G·(h·W_hh[type] + b_hh)
    r = σ(x_r+h_r), z = σ(x_z+h_z), n = tanh(x_n + r·h_n)
    h' = n − n·z + z·h ;  G' = l1norm(G + ΔG)

``graph_gru_step`` is one step on precomputed input gates; the encoder loops
it over the observed frames, and it is the plain version of the decode
rollout kernel (``ops/kernels/gru_rollout.py``).  With ``compute_dtype`` the
cell's products, mixes and gates run in that dtype and the carried hidden
state stays float32, as in the flax cell (`graph_gru.py:99-101`), rounding
where XLA rounds the flax cell's scanned step: after every op, with σ(a)
expanded as 1/(1 + exp(−a)), except that h' = (n − round(n·z)) + z·h is
float32 with z before its rounding (XLA drops the round trip of
``astype(float32)``).
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from .graph_linear import gmix_nm, gmm_nm, l1_normalize_rows, type_index
from .initializers import uniform_stdv


def graph_gru_step(
    cx: torch.Tensor,     # [N,B,3H] input gates x·W_ih + b_ih (before the G mix)
    h: torch.Tensor,      # [N,B,H]
    g: torch.Tensor,      # [N,N] row-normalized influence of this step
    w_hh: torch.Tensor,   # [N,H,3H] per-node banks
    b_hh: torch.Tensor,   # [N,3H]
) -> torch.Tensor:
    """h' of one graph-GRU step, computed in ``cx``'s dtype (h, g and the
    banks are cast to it); h' has h's dtype."""
    cdt = cx.dtype
    g = g.to(cdt)
    gi = gmix_nm(g, cx)
    gh = gmix_nm(g, gmm_nm(h.to(cdt), w_hh.to(cdt)) + b_hh.to(cdt)[:, None, :])
    if cdt == torch.float32:
        i_r, i_z, i_n = gi.chunk(3, dim=-1)
        h_r, h_z, h_n = gh.chunk(3, dim=-1)
        r = torch.sigmoid(i_r + h_r)
        z = torch.sigmoid(i_z + h_z)
        n = torch.tanh(i_n + r * h_n)
        return (n - n * z).to(h.dtype) + z.to(h.dtype) * h
    # every op in cdt rounds, as XLA evaluates the flax cell; σ is 1/(1 + e^−a),
    # here for the r and z gates at once
    hid = h.shape[-1]
    rz = 1.0 / (1.0 + torch.exp(-(gi[..., :2 * hid] + gh[..., :2 * hid]))).float()
    r, z = rz[..., :hid].to(cdt), rz[..., hid:]  # z·h takes z unrounded
    n = torch.tanh(gi[..., 2 * hid:] + r * gh[..., 2 * hid:])
    return ((n.float() - n * z.to(cdt)) + z * h.float()).to(h.dtype)


class StaticGraphGRUCell(nn.Module):
    """Parameters ``weight_ih`` [types,in,3H], ``weight_hh`` [types,H,3H],
    ``bias_ih``/``bias_hh`` [types,3H] and, with
    ``learn_additive_graph_influence``, ``G_add`` [N,N] (zero init)."""

    def __init__(
        self,
        input_size: int,
        hidden_size: int,
        num_nodes: int,
        generator: torch.Generator,
        node_types: Optional[np.ndarray] = None,
        learn_additive_graph_influence: bool = False,
        compute_dtype: Optional[torch.dtype] = None,
    ):
        super().__init__()
        self.compute_dtype = compute_dtype
        index, n_types = type_index(node_types, num_nodes)
        self.register_buffer("type_index", torch.as_tensor(index), persistent=False)
        H = hidden_size
        self.weight_ih = nn.Parameter(uniform_stdv((n_types, input_size, 3 * H), H, generator))
        self.weight_hh = nn.Parameter(uniform_stdv((n_types, H, 3 * H), H, generator))
        self.bias_ih = nn.Parameter(uniform_stdv((n_types, 3 * H), H, generator))
        self.bias_hh = nn.Parameter(uniform_stdv((n_types, 3 * H), H, generator))
        self.G_add = (
            nn.Parameter(torch.zeros(num_nodes, num_nodes))
            if learn_additive_graph_influence else None
        )

    def input_gates(self, x: torch.Tensor) -> torch.Tensor:
        """x·W_ih[type] + b_ih: [N,B,in] → [N,B,3H], in the compute dtype."""
        cast = (lambda t: t) if self.compute_dtype is None else (lambda t: t.to(self.compute_dtype))
        return (gmm_nm(cast(x), cast(self.weight_ih[self.type_index]))
                + cast(self.bias_ih[self.type_index])[:, None, :])

    def hidden_banks(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """(W_hh [N,H,3H], b_hh [N,3H]) gathered per node."""
        return self.weight_hh[self.type_index], self.bias_hh[self.type_index]

    def next_influence(self, g: torch.Tensor) -> torch.Tensor:
        """G' = l1norm(G + ΔG) (or l1norm(G) without ΔG)."""
        return l1_normalize_rows(g if self.G_add is None else g + self.G_add)

    def forward(self, cx: torch.Tensor, h: torch.Tensor, g: torch.Tensor):
        """(h', G') from input gates ``cx``, hidden ``h`` and influence ``g``."""
        w_hh, b_hh = self.hidden_banks()
        return graph_gru_step(cx, h, g, w_hh, b_hh), self.next_influence(g)


class StaticGraphGRU(nn.Module):
    """One-layer graph GRU over a time-major node-major sequence
    ``[T,N,B,F]`` (the encoder's ``rnn``); parameters ``G0`` (the initial
    influence, identity init) and ``cell0``."""

    def __init__(
        self,
        input_size: int,
        hidden_size: int,
        num_nodes: int,
        generator: torch.Generator,
        node_types: Optional[np.ndarray] = None,
        compute_dtype: Optional[torch.dtype] = None,
    ):
        super().__init__()
        self.G0 = nn.Parameter(torch.eye(num_nodes))
        self.cell0 = StaticGraphGRUCell(input_size, hidden_size, num_nodes, generator, node_types,
                                        compute_dtype=compute_dtype)

    def forward(self, x: torch.Tensor, h0: torch.Tensor,
                last_index: Optional[int] = None) -> torch.Tensor:
        """Hidden state after frame ``last_index`` (default the last), [N,B,H];
        the GRU is causal, so the frames after it are not run."""
        steps = x.shape[0] if last_index is None else last_index + 1
        if not 0 < steps <= x.shape[0]:
            raise ValueError(f"last_index {last_index} outside a sequence of {x.shape[0]} frames")
        h, g = h0, l1_normalize_rows(self.G0)
        for t in range(steps):
            h, g = self.cell0(self.cell0.input_gates(x[t]), h, g)
        return h
