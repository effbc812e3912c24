"""Graph-recurrent motion AutoEncoder: pose sequence [B,T,N,3] ⇄ per-joint
latent [B,N,latent].

Port of ``skeletondiffusion_tpu/models/autoencoder.py`` (reference
`src/core/network/nn/{encoder,decoder,autoencoder}.py`), GRU architecture,
one layer each side.  The encoder loops the graph-GRU step over the observed
frames; the decoder hoists its constant input gates and runs the whole
rollout (hidden state, evolving influence G ← l1norm(G + ΔG), output head) in
one call of the rollout kernel wrapper (``ops/kernels/gru_rollout.py``).
Submodule and parameter names are the flax ones.  ``compute_dtype`` runs the
encoder's graph-GRU cell in that dtype (its products, mixes and gates; the
hidden state stays float32), as the flax encoder does; the decode stays the
float32 rollout kernel, which is what the JAX package runs on its prediction
path whatever the AutoEncoder's dtype (`eval_pipeline.py:164-170`).  The
decode's hoisting lives in ``ops/kernels/gru_rollout.decode_rollout``, which
also runs the opt-in merged-gate bf16 rollout.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from ..ops.graph_gru import StaticGraphGRU, StaticGraphGRUCell
from ..ops.graph_linear import StaticGraphLinear
from ..ops.kernels import gru_rollout as rollout_kernel


class Encoder(nn.Module):
    """Hidden initialized from frame 0 by a graph linear, graph-GRU over the
    frames, output = tanh(fc(last hidden)); reference `encoder.py:10-82`."""

    def __init__(self, num_nodes: int, input_size: int, hidden_size: int, output_size: int,
                 generator: torch.Generator, node_types: Optional[np.ndarray] = None,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        common = dict(num_nodes=num_nodes, generator=generator, node_types=node_types)
        self.initial_hidden1 = StaticGraphLinear(input_size, hidden_size, learn_influence=True,
                                                 **common)
        self.rnn = StaticGraphGRU(input_size, hidden_size, compute_dtype=compute_dtype, **common)
        self.fc = StaticGraphLinear(hidden_size, output_size, learn_influence=True, **common)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x [B,T,N,F] → [B,N,latent]."""
        x_nm = x.permute(1, 2, 0, 3)  # [T,N,B,F]
        h = self.rnn(x_nm, self.initial_hidden1(x_nm[0]))
        return torch.tanh(self.fc(h)).transpose(0, 1)


class _RolloutStep(nn.Module):
    """The decoder's per-step modules: the graph-GRU cell with ΔG and the
    tanh(graph-linear) output head."""

    def __init__(self, input_size: int, hidden_size: int, output_size: int, num_nodes: int,
                 generator: torch.Generator, node_types: Optional[np.ndarray] = None):
        super().__init__()
        self.cell = StaticGraphGRUCell(input_size, hidden_size, num_nodes, generator, node_types,
                                       learn_additive_graph_influence=True)
        self.fc = StaticGraphLinear(hidden_size, output_size, num_nodes, generator, node_types,
                                    learn_influence=True)


class Decoder(nn.Module):
    """Hidden init from [x_{T-2}, z]; constant per-step input [x_{T-1}, z];
    each step emits tanh(fc(h_t)); reference `decoder.py:9-104`."""

    def __init__(self, num_nodes: int, feature_size: int, input_size: int, hidden_size: int,
                 output_size: int, generator: torch.Generator,
                 node_types: Optional[np.ndarray] = None):
        super().__init__()
        in_size = feature_size + input_size
        self.initial_hidden_h = StaticGraphLinear(in_size, hidden_size, num_nodes, generator,
                                                  node_types, learn_influence=True)
        self.G0 = nn.Parameter(torch.eye(num_nodes))
        self.rollout = _RolloutStep(in_size, hidden_size, output_size, num_nodes, generator,
                                    node_types)

    def forward(self, x: torch.Tensor, z: torch.Tensor, ph: int) -> torch.Tensor:
        """x [B,≥2,N,3] observed poses, z [B,N,latent] → [B,ph,N,3]."""
        return rollout_kernel.decode_rollout(self, x[:, -2:], z, ph)


class AutoEncoder(nn.Module):
    """seq→latent→seq; reference `autoencoder.py:8-98` (GRU both sides, z
    activation tanh)."""

    def __init__(self, num_nodes: int, encoder_hidden_size: int, decoder_hidden_size: int,
                 latent_size: int, generator: torch.Generator,
                 node_types: Optional[np.ndarray] = None, input_size: int = 3,
                 output_size: int = 3, compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.encoder = Encoder(num_nodes, input_size, encoder_hidden_size, latent_size,
                               generator, node_types, compute_dtype=compute_dtype)
        self.decoder = Decoder(num_nodes, input_size, latent_size, decoder_hidden_size,
                               output_size, generator, node_types)

    def get_past_embedding(self, past: torch.Tensor) -> torch.Tensor:
        """Detached encoder + z activation (the reference applies tanh on an
        already-tanh'd encoder output, `autoencoder.py:51-55` — kept)."""
        return torch.tanh(self.encoder(past)).detach()

    def decode(self, x: torch.Tensor, h: torch.Tensor, ph: int) -> torch.Tensor:
        """``ph`` future frames from latent ``h``, seeded by the last two
        observed poses of ``x``."""
        return self.decoder(x[:, -2:], h, ph)
