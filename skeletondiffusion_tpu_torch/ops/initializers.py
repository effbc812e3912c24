"""Parameter initializers with the reference's torch init scales, drawn from
an explicit ``torch.Generator`` (port of ``skeletondiffusion_tpu/ops/initializers.py``).

* ``graph_linear_weight``: U(±1/√(out·in)) on a [types, in, out] bank — torch's
  3-D fan-in (`graph_structural.py:17-28`) — with every type bank tied to
  bank 0 (`graph_structural.py:23-24`).
* ``uniform_stdv``: U(±1/√H), the recurrent-cell init (`recurrent.py:310-319`).
* ``torch_linear``: U(±1/√in), ``nn.Linear``'s default (`nn/generator.py:50-55`).
"""
from __future__ import annotations

import math
from typing import Sequence

import torch


def uniform(shape: Sequence[int], bound: float, generator: torch.Generator) -> torch.Tensor:
    """U(−bound, bound) in float32 on the generator's device."""
    u = torch.rand(tuple(shape), generator=generator, dtype=torch.float32,
                   device=generator.device)
    return (2.0 * u - 1.0) * bound


def graph_linear_weight(num_types: int, in_features: int, out_features: int,
                        generator: torch.Generator) -> torch.Tensor:
    w = uniform((num_types, in_features, out_features),
                1.0 / math.sqrt(out_features * in_features), generator)
    return w[0:1].expand_as(w).clone()


def graph_linear_bias(num_types: int, in_features: int, out_features: int,
                      generator: torch.Generator) -> torch.Tensor:
    return uniform((num_types, out_features), 1.0 / math.sqrt(out_features * in_features),
                   generator)


def uniform_stdv(shape: Sequence[int], hidden_size: int,
                 generator: torch.Generator) -> torch.Tensor:
    return uniform(shape, 1.0 / math.sqrt(hidden_size), generator)


def torch_linear(shape: Sequence[int], in_features: int,
                 generator: torch.Generator) -> torch.Tensor:
    return uniform(shape, 1.0 / math.sqrt(in_features), generator)
