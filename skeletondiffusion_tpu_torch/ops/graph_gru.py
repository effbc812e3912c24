"""Graph-recurrent GRU and LSTM: gate pre-activations are mixed across the
skeleton joints by the influence matrix G at every step.

Port of ``skeletondiffusion_tpu/ops/graph_gru.py`` (reference
`src/core/network/layers/recurrent.py:13-402`), node-major ``[N, B, F]``:

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

The graph-LSTM (``graph_lstm_step``, reference `recurrent.py:13-167`) is

    gates = G·(x·W_ih[type] + h·W_hh[type] + b_hh) ;  i, f, g, o = split(gates)
    c' = σ(f)·c + σ(i)·tanh(g) ;  h' = σ(o)·tanh(c')

with banks tied across node types at init and no input bias (the
reference's ``bias_ih`` never enters its forward pass); its carries (h, c)
stay float32 under a bf16 ``compute_dtype`` in the same way.  The sequence
modules (``StaticGraphGRU``, ``StaticGraphLSTM``) stack ``num_layers``
cells, each layer reading the one below, as the flax ``_GraphRNNBase``
(`graph_gru.py:179-257`).
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


def graph_lstm_step(
    cx: torch.Tensor,     # [N,B,4H] input gates x·W_ih (before the G mix)
    h: torch.Tensor,      # [N,B,H] float32
    c: torch.Tensor,      # [N,B,H] float32
    g: torch.Tensor,      # [N,N] row-normalized influence of this step
    w_hh: torch.Tensor,   # [N,H,4H] per-node banks
    b_hh: torch.Tensor,   # [N,4H]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(h', c') of one graph-LSTM step, the gates computed in ``cx``'s dtype
    (h, g and the banks cast to it); h' and c' have c's dtype.  In bf16 every
    op of the gates rounds, σ(a) is 1/(1 + e^−a), and a value that the flax
    cell widens with ``astype(float32)`` (σ(f), σ(i)·tanh(g), σ(o)) is taken
    before its rounding, as XLA evaluates the cell."""
    cdt = cx.dtype
    gates = gmix_nm(g.to(cdt), cx + gmm_nm(h.to(cdt), w_hh.to(cdt)) + b_hh.to(cdt)[:, None, :])
    i, f, gg, o = gates.chunk(4, dim=-1)
    if cdt == torch.float32:
        c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(gg)
        return torch.sigmoid(o) * torch.tanh(c_new), c_new

    def sigmoid_wide(a):  # the last op (the division) in float32
        return 1.0 / (1.0 + torch.exp(-a)).float()

    sig_i = sigmoid_wide(i).to(cdt)
    c_new = sigmoid_wide(f).to(c.dtype) * c + (sig_i.float() * torch.tanh(gg).float()).to(c.dtype)
    return sigmoid_wide(o).to(c.dtype) * torch.tanh(c_new), c_new


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


class StaticGraphLSTMCell(nn.Module):
    """Parameters ``weight_ih`` [types,in,4H] and ``weight_hh`` [types,H,4H]
    (each tied across the types at init, `recurrent.py:115-124`),
    ``bias_hh`` [types,4H] and, with ``learn_additive_graph_influence``,
    ``G_add`` [N,N] (zero init); the gates split as i, f, g, o."""

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

        def tied(shape):
            w = uniform_stdv(shape, H, generator)
            return w[0:1].expand_as(w).clone()

        self.weight_ih = nn.Parameter(tied((n_types, input_size, 4 * H)))
        self.weight_hh = nn.Parameter(tied((n_types, H, 4 * H)))
        self.bias_hh = nn.Parameter(uniform_stdv((n_types, 4 * H), H, generator))
        self.G_add = (
            nn.Parameter(torch.zeros(num_nodes, num_nodes))
            if learn_additive_graph_influence else None
        )

    def input_gates(self, x: torch.Tensor) -> torch.Tensor:
        """x·W_ih[type]: [N,B,in] → [N,B,4H], in the compute dtype."""
        cast = (lambda t: t) if self.compute_dtype is None else (lambda t: t.to(self.compute_dtype))
        return gmm_nm(cast(x), cast(self.weight_ih[self.type_index]))

    def next_influence(self, g: torch.Tensor) -> torch.Tensor:
        """G' = l1norm(G + ΔG) (or l1norm(G) without ΔG)."""
        return l1_normalize_rows(g if self.G_add is None else g + self.G_add)

    def forward(self, cx: torch.Tensor, h: torch.Tensor, c: torch.Tensor, g: torch.Tensor):
        """(h', c', G') from input gates ``cx``, carries ``h``, ``c`` and
        influence ``g``."""
        h, c = graph_lstm_step(cx, h, c, g, self.weight_hh[self.type_index],
                               self.bias_hh[self.type_index])
        return h, c, self.next_influence(g)


class _GraphRNN(nn.Module):
    """``num_layers`` graph-recurrent cells over a time-major node-major
    sequence ``[T,N,B,F]`` (the encoder's ``rnn``), layer i reading layer
    i − 1's hidden states; parameters ``G{i}`` (layer i's initial influence,
    identity init) and ``cell{i}``.  Every layer starts from the same
    initial carries, as the flax encoder passes them."""

    cell_cls = StaticGraphGRUCell

    def __init__(
        self,
        input_size: int,
        hidden_size: int,
        num_nodes: int,
        generator: torch.Generator,
        node_types: Optional[np.ndarray] = None,
        num_layers: int = 1,
        compute_dtype: Optional[torch.dtype] = None,
    ):
        super().__init__()
        if num_layers < 1:
            raise ValueError(f"num_layers={num_layers}")
        self.num_layers = num_layers
        for i in range(num_layers):
            self.register_parameter(f"G{i}", nn.Parameter(torch.eye(num_nodes)))
            self.add_module(f"cell{i}", self.cell_cls(
                input_size if i == 0 else hidden_size, hidden_size, num_nodes, generator,
                node_types, compute_dtype=compute_dtype))

    def forward(self, x: torch.Tensor, *carries: torch.Tensor,
                last_index: Optional[int] = None) -> torch.Tensor:
        """The last layer's hidden state after frame ``last_index`` (default
        the last), [N,B,H]; every layer starts from ``carries`` (h0 for the
        GRU, h0 and c0 for the LSTM).  The cells are causal, so the frames
        after ``last_index`` are not run."""
        steps = x.shape[0] if last_index is None else last_index + 1
        if not 0 < steps <= x.shape[0]:
            raise ValueError(f"last_index {last_index} outside a sequence of {x.shape[0]} frames")
        out = x[:steps]
        for i in range(self.num_layers):
            cell = getattr(self, f"cell{i}")
            state, g = carries, l1_normalize_rows(getattr(self, f"G{i}"))
            hs = []
            for t in range(steps):
                *state, g = cell(cell.input_gates(out[t]), *state, g)
                hs.append(state[0])
            out = torch.stack(hs) if i + 1 < self.num_layers else None
        return state[0]


class StaticGraphGRU(_GraphRNN):
    cell_cls = StaticGraphGRUCell


class StaticGraphLSTM(_GraphRNN):
    cell_cls = StaticGraphLSTMCell
