"""Weight bridge: the JAX package's flax parameter trees → the port's modules.

The port's modules carry the flax submodule and parameter names and the JAX
layouts (graph-linear and recurrent banks ``[types, in, out]``, Dense
``kernel`` ``[in, out]``; see ``skeletondiffusion_tpu/utils/torch_port.py:11-16``
for how those relate to the reference's own torch layouts).  So a flax tree,
given as nested dicts of numpy arrays, flattens with ``.`` into the module's
``state_dict``, and it is loaded with ``strict=True``: no parameter is left
at its init and no array is left unused.  The variants' parameters carry the
flax names as well: a self-conditioned denoiser's wider ``init_lin``, an
attention-free one's ``attn{i}_norm`` and ``attn{i}_lin``, the narrower
layers of an unconditioned one.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch
from torch import nn

from .models.autoencoder import AutoEncoder
from .models.denoiser import Denoiser


def flatten_params(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, torch.Tensor]:
    """Nested dicts of arrays → ``{'a.b.c': float32 tensor}``; a top-level
    ``'params'`` collection (flax ``init`` output) is unwrapped."""
    if not prefix and set(tree) == {"params"}:
        tree = tree["params"]
    out: Dict[str, torch.Tensor] = {}
    for key, value in tree.items():
        name = f"{prefix}{key}"
        if isinstance(value, Mapping):
            out.update(flatten_params(value, prefix=f"{name}."))
        else:
            out[name] = torch.as_tensor(np.array(value, dtype=np.float32))
    return out


def _load(module: nn.Module, params: Mapping[str, Any]) -> nn.Module:
    module.load_state_dict(flatten_params(params), strict=True)
    return module


def load_autoencoder_params(module: AutoEncoder, params: Mapping[str, Any]) -> AutoEncoder:
    """Load a flax ``AutoEncoder`` parameter tree into ``module``."""
    return _load(module, params)


def load_denoiser_params(module: Denoiser, params: Mapping[str, Any]) -> Denoiser:
    """Load a flax ``Denoiser`` parameter tree into ``module``."""
    return _load(module, params)
