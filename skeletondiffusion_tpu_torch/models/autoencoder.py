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

The rollout kernel has no backward.  Training decodes with
``Decoder.forward_with_grad`` (``AutoEncoder.decode_with_grad``): the same
hoisting, then the plain step loop under autograd, which is what the JAX
package differentiates (the flax ``nn.scan``); the kernel's wrapper refuses
inputs that require gradients.  The training methods (``encode`` with the
curriculum's ``last_index``, ``get_train_embeddings``, ``autoencode``,
``autoencoder_loss``) are those of `autoencoder.py:238-283` there.
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

    def forward(self, x: torch.Tensor, last_index: Optional[int] = None) -> torch.Tensor:
        """x [B,T,N,F] → [B,N,latent] from the hidden state after frame
        ``last_index`` (default the last): the curriculum's encode of
        ``x[:, :last_index + 1]``."""
        x_nm = x.permute(1, 2, 0, 3)  # [T,N,B,F]
        h = self.rnn(x_nm, self.initial_hidden1(x_nm[0]), last_index=last_index)
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
        """x [B,≥2,N,3] observed poses, z [B,N,latent] → [B,ph,N,3], on the
        rollout kernel (no backward)."""
        return rollout_kernel.decode_rollout(self, x[:, -2:], z, ph)

    def forward_with_grad(self, x: torch.Tensor, z: torch.Tensor, ph: int) -> torch.Tensor:
        """The same decode as the plain step loop, differentiable."""
        ys = rollout_kernel.gru_rollout_plain(**rollout_kernel.rollout_args(self, x[:, -2:], z),
                                              ph=ph)  # [ph,N,B,3]
        return ys.permute(2, 0, 1, 3)


class AutoEncoder(nn.Module):
    """seq→latent→seq; reference `autoencoder.py:8-98` (GRU both sides, z
    activation tanh).  ``loss_pose_type`` (``l1`` or ``mse``) is the
    training loss's and the k-best choice's in input space."""

    def __init__(self, num_nodes: int, encoder_hidden_size: int, decoder_hidden_size: int,
                 latent_size: int, generator: torch.Generator,
                 node_types: Optional[np.ndarray] = None, input_size: int = 3,
                 output_size: int = 3, compute_dtype: Optional[torch.dtype] = None,
                 loss_pose_type: str = "l1"):
        super().__init__()
        self.loss_pose_type = loss_pose_type
        self.encoder = Encoder(num_nodes, input_size, encoder_hidden_size, latent_size,
                               generator, node_types, compute_dtype=compute_dtype)
        self.decoder = Decoder(num_nodes, input_size, latent_size, decoder_hidden_size,
                               output_size, generator, node_types)

    def encode(self, x: torch.Tensor, last_index: Optional[int] = None) -> torch.Tensor:
        """The encoder's latent [B,N,latent] (the reference's forward)."""
        return self.encoder(x, last_index=last_index)

    def get_past_embedding(self, past: torch.Tensor) -> torch.Tensor:
        """Detached encoder + z activation (the reference applies tanh on an
        already-tanh'd encoder output, `autoencoder.py:51-55` — kept)."""
        return torch.tanh(self.encode(past)).detach()

    def get_train_embeddings(self, y: torch.Tensor, past: torch.Tensor,
                             y_last_index: Optional[int] = None):
        """(z_past detached, z with gradient); reference `autoencoder.py:61-64`."""
        return self.get_past_embedding(past), self.encode(y, last_index=y_last_index)

    def decode(self, x: torch.Tensor, h: torch.Tensor, ph: int) -> torch.Tensor:
        """``ph`` future frames from latent ``h``, seeded by the last two
        observed poses of ``x``, on the rollout kernel."""
        return self.decoder(x[:, -2:], h, ph)

    def decode_with_grad(self, x: torch.Tensor, h: torch.Tensor, ph: int) -> torch.Tensor:
        """``decode`` as the differentiable step loop (training)."""
        return self.decoder.forward_with_grad(x[:, -2:], h, ph)

    def autoencode(self, y: torch.Tensor, past: torch.Tensor, ph: int,
                   y_last_index: Optional[int] = None):
        """(decode of the future's latent, z_past, z), on the rollout kernel;
        reference `autoencoder.py:66-78`."""
        z_past, z = self.get_train_embeddings(y, past, y_last_index=y_last_index)
        return self.decode(past, z, ph), z_past, z


def autoencoder_loss(y_pred: torch.Tensor, y: torch.Tensor, loss_type: str = "l1",
                     reduction: str = "mean") -> torch.Tensor:
    """L1/MSE summed over xyz, mean over joints and time; reference
    `autoencoder.py:80-98`.  ``reduction='none'`` keeps the leading axes."""
    if loss_type == "mse":
        out = (y_pred - y) ** 2
    elif loss_type in ("l1", "L1"):
        out = torch.abs(y_pred - y)
    else:
        raise NotImplementedError(loss_type)
    loss = out.sum(-1).mean(-1).mean(-1)
    if reduction == "mean":
        return loss.mean()
    if reduction == "none":
        return loss
    raise NotImplementedError(reduction)
