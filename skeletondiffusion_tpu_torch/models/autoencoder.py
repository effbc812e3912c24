"""Graph-recurrent motion AutoEncoder: pose sequence [B,T,N,3] ⇄ per-joint
latent [B,N,latent].

Port of ``skeletondiffusion_tpu/models/autoencoder.py`` (reference
`src/core/network/nn/{encoder,decoder,autoencoder}.py`): a graph-GRU or
graph-LSTM encoder of ``enc_num_layers`` layers (``recurrent_arch_enc``),
a one-layer graph-GRU or graph-LSTM decoder (``recurrent_arch_decoder``)
and a tanh or identity latent activation (``z_activation``).  The encoder
loops the recurrent step over the observed frames; a GRU decoder hoists its
constant input gates and runs the whole rollout (hidden state, evolving
influence G ← l1norm(G + ΔG), output head) in one call of the rollout kernel
wrapper (``ops/kernels/gru_rollout.py``), and an LSTM decoder, which no
kernel runs, its plain step loop.
Submodule and parameter names are the flax ones.  ``compute_dtype`` runs the
encoder's graph-GRU cell and the decoder's cell and output head in that dtype
(their products, mixes and gates; the hidden states and the decoder's initial
hidden state stay float32), as the flax modules do.  The decode
(``Decoder.forward``) stays the float32 rollout kernel whatever the dtype,
which is what the JAX package runs on its prediction path
(`eval_pipeline.py:164-170`); its hoisting lives in
``ops/kernels/gru_rollout.decode_rollout``, which also runs the opt-in
merged-gate bf16 rollout.  The plain decode (``Decoder.forward_plain``,
``AutoEncoder.decode_plain``) is the step loop in the compute dtype, the flax
``Decoder``'s ``nn.scan`` (`autoencoder.py:124-192`).

The rollout kernel has no backward.  Training decodes with the plain decode
under autograd (``AutoEncoder.decode_plain``), which is what the JAX
package differentiates; the kernel's wrapper refuses inputs that require
gradients.  The training methods (``encode`` with the
curriculum's ``last_index``, ``get_train_embeddings``, ``autoencode``,
``autoencoder_loss``) are those of `autoencoder.py:238-283` there.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from ..ops.graph_gru import (
    StaticGraphGRU,
    StaticGraphGRUCell,
    StaticGraphLSTM,
    StaticGraphLSTMCell,
)
from ..ops.graph_linear import StaticGraphLinear, l1_normalize_rows
from ..ops.kernels import gru_rollout as rollout_kernel

RECURRENT_ARCHS = ("StaticGraphGRU", "StaticGraphLSTM")


def _check_arch(name: str) -> bool:
    """True for the LSTM (``name`` one of ``RECURRENT_ARCHS``)."""
    if name not in RECURRENT_ARCHS:
        raise ValueError(f"recurrent architecture {name!r} (use one of {RECURRENT_ARCHS})")
    return name == "StaticGraphLSTM"


class Encoder(nn.Module):
    """Hidden (and, for the LSTM, cell) state initialized from frame 0 by a
    graph linear, ``enc_num_layers`` graph-GRU or graph-LSTM layers over the
    frames, output = tanh(fc(last hidden)); reference `encoder.py:10-82`."""

    def __init__(self, num_nodes: int, input_size: int, hidden_size: int, output_size: int,
                 generator: torch.Generator, node_types: Optional[np.ndarray] = None,
                 compute_dtype: Optional[torch.dtype] = None, enc_num_layers: int = 1,
                 recurrent_arch: str = "StaticGraphGRU"):
        super().__init__()
        self.is_lstm = _check_arch(recurrent_arch)
        common = dict(num_nodes=num_nodes, generator=generator, node_types=node_types)
        self.initial_hidden1 = StaticGraphLinear(input_size, hidden_size, learn_influence=True,
                                                 **common)
        if self.is_lstm:
            self.initial_hidden_c = StaticGraphLinear(input_size, hidden_size,
                                                      learn_influence=True, **common)
        rnn = StaticGraphLSTM if self.is_lstm else StaticGraphGRU
        self.rnn = rnn(input_size, hidden_size, num_layers=enc_num_layers,
                       compute_dtype=compute_dtype, **common)
        self.fc = StaticGraphLinear(hidden_size, output_size, learn_influence=True, **common)

    def forward(self, x: torch.Tensor, last_index: Optional[int] = None) -> torch.Tensor:
        """x [B,T,N,F] → [B,N,latent] from the hidden state after frame
        ``last_index`` (default the last): the curriculum's encode of
        ``x[:, :last_index + 1]``."""
        x_nm = x.permute(1, 2, 0, 3)  # [T,N,B,F]
        carries = [self.initial_hidden1(x_nm[0])]
        if self.is_lstm:
            carries.append(self.initial_hidden_c(x_nm[0]))
        h = self.rnn(x_nm, *carries, last_index=last_index)
        return torch.tanh(self.fc(h)).transpose(0, 1)


class _RolloutStep(nn.Module):
    """The decoder's per-step modules: the graph-GRU or graph-LSTM cell with
    ΔG and the tanh(graph-linear) output head."""

    def __init__(self, input_size: int, hidden_size: int, output_size: int, num_nodes: int,
                 generator: torch.Generator, node_types: Optional[np.ndarray] = None,
                 compute_dtype: Optional[torch.dtype] = None, is_lstm: bool = False):
        super().__init__()
        cell = StaticGraphLSTMCell if is_lstm else StaticGraphGRUCell
        self.cell = cell(input_size, hidden_size, num_nodes, generator, node_types,
                         learn_additive_graph_influence=True, compute_dtype=compute_dtype)
        self.fc = StaticGraphLinear(hidden_size, output_size, num_nodes, generator, node_types,
                                    learn_influence=True, compute_dtype=compute_dtype)


class Decoder(nn.Module):
    """Hidden (and, for the LSTM, cell) init from [x_{T-2}, z]; constant
    per-step input [x_{T-1}, z]; each step emits tanh(fc(h_t)); reference
    `decoder.py:9-104`.  One recurrent layer (the flax Decoder asserts
    ``dec_num_layers == 1``)."""

    def __init__(self, num_nodes: int, feature_size: int, input_size: int, hidden_size: int,
                 output_size: int, generator: torch.Generator,
                 node_types: Optional[np.ndarray] = None,
                 compute_dtype: Optional[torch.dtype] = None,
                 recurrent_arch_decoder: str = "StaticGraphGRU"):
        super().__init__()
        self.is_lstm = _check_arch(recurrent_arch_decoder)
        in_size = feature_size + input_size
        self.initial_hidden_h = StaticGraphLinear(in_size, hidden_size, num_nodes, generator,
                                                  node_types, learn_influence=True)
        self.G0 = nn.Parameter(torch.eye(num_nodes))
        if self.is_lstm:
            self.initial_hidden_c = StaticGraphLinear(in_size, hidden_size, num_nodes,
                                                      generator, node_types, learn_influence=True)
        self.rollout = _RolloutStep(in_size, hidden_size, output_size, num_nodes, generator,
                                    node_types, compute_dtype=compute_dtype, is_lstm=self.is_lstm)

    def forward(self, x: torch.Tensor, z: torch.Tensor, ph: int) -> torch.Tensor:
        """x [B,≥2,N,3] observed poses, z [B,N,latent] → [B,ph,N,3], on the
        float32 rollout kernel (no backward); a GRU decoder only, an LSTM one
        raises."""
        return rollout_kernel.decode_rollout(self, x[:, -2:], z, ph)

    def forward_plain(self, x: torch.Tensor, z: torch.Tensor, ph: int) -> torch.Tensor:
        """The same decode as the plain step loop in the compute dtype,
        differentiable: h₀ (and c₀) = initial_hidden_h (_c)([x_{T-2}, z]) in
        float32, the constant input gates of [x_{T-1}, z] hoisted, then per
        step the cell (carries float32, G ← l1norm(G + ΔG) float32) and
        y = tanh(fc(h)) widened to float32."""
        x_t, x_t_1, z_nm = x[:, -1].transpose(0, 1), x[:, -2].transpose(0, 1), z.transpose(0, 1)
        seed = torch.cat([x_t_1, z_nm], dim=-1)
        state = [self.initial_hidden_h(seed)]
        if self.is_lstm:
            state.append(self.initial_hidden_c(seed))
        cell, fc = self.rollout.cell, self.rollout.fc
        cx = cell.input_gates(torch.cat([x_t, z_nm], dim=-1))
        g = l1_normalize_rows(self.G0)
        ys = []
        for _ in range(ph):
            *state, g = cell(cx, *state, g)
            ys.append(torch.tanh(fc(state[0])).float())
        return torch.stack(ys).permute(2, 0, 1, 3)


class AutoEncoder(nn.Module):
    """seq→latent→seq; reference `autoencoder.py:8-98`.  ``loss_pose_type``
    (``l1`` or ``mse``) is the training loss's and the k-best choice's in
    input space; ``z_activation`` (``tanh``, else the identity) is applied
    to the past embedding."""

    def __init__(self, num_nodes: int, encoder_hidden_size: int, decoder_hidden_size: int,
                 latent_size: int, generator: torch.Generator,
                 node_types: Optional[np.ndarray] = None, input_size: int = 3,
                 output_size: int = 3, compute_dtype: Optional[torch.dtype] = None,
                 loss_pose_type: str = "l1", z_activation: str = "tanh",
                 enc_num_layers: int = 1, recurrent_arch_enc: str = "StaticGraphGRU",
                 recurrent_arch_decoder: str = "StaticGraphGRU"):
        super().__init__()
        self.loss_pose_type = loss_pose_type
        self.z_activation = z_activation
        self.encoder = Encoder(num_nodes, input_size, encoder_hidden_size, latent_size,
                               generator, node_types, compute_dtype=compute_dtype,
                               enc_num_layers=enc_num_layers, recurrent_arch=recurrent_arch_enc)
        self.decoder = Decoder(num_nodes, input_size, latent_size, decoder_hidden_size,
                               output_size, generator, node_types, compute_dtype=compute_dtype,
                               recurrent_arch_decoder=recurrent_arch_decoder)

    @property
    def decodes_on_kernel(self) -> bool:
        """Whether ``decode`` runs the rollout kernel by default: a GRU
        decoder does, an LSTM one runs the plain step loop (the JAX predictor
        takes its fused rollout for a GRU decoder only,
        `eval_pipeline.py:58-65`)."""
        return not self.decoder.is_lstm

    def encode(self, x: torch.Tensor, last_index: Optional[int] = None) -> torch.Tensor:
        """The encoder's latent [B,N,latent] (the reference's forward)."""
        return self.encoder(x, last_index=last_index)

    def get_past_embedding(self, past: torch.Tensor) -> torch.Tensor:
        """Detached encoder + z activation (the reference applies tanh on an
        already-tanh'd encoder output, `autoencoder.py:51-55` — kept)."""
        z = self.encode(past)
        return (torch.tanh(z) if self.z_activation == "tanh" else z).detach()

    def get_train_embeddings(self, y: torch.Tensor, past: torch.Tensor,
                             y_last_index: Optional[int] = None):
        """(z_past detached, z with gradient); reference `autoencoder.py:61-64`."""
        return self.get_past_embedding(past), self.encode(y, last_index=y_last_index)

    def decode(self, x: torch.Tensor, h: torch.Tensor, ph: int) -> torch.Tensor:
        """``ph`` future frames from latent ``h``, seeded by the last two
        observed poses of ``x``: on the rollout kernel for a GRU decoder, as
        the plain step loop for an LSTM one (``decodes_on_kernel``)."""
        if self.decodes_on_kernel:
            return self.decoder(x[:, -2:], h, ph)
        return self.decode_plain(x, h, ph)

    def decode_plain(self, x: torch.Tensor, h: torch.Tensor, ph: int) -> torch.Tensor:
        """``decode`` as the plain step loop in the compute dtype
        (``Decoder.forward_plain``), differentiable."""
        return self.decoder.forward_plain(x[:, -2:], h, ph)

    def autoencode(self, y: torch.Tensor, past: torch.Tensor, ph: int,
                   y_last_index: Optional[int] = None):
        """(decode of the future's latent, z_past, z), decoded as ``decode``
        does by default; reference `autoencoder.py:66-78`."""
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
