"""Reference-named weights: the reference's torch ``state_dict``s loaded into
the port's ``Denoiser`` and ``AutoEncoder``.

The reference distributes trained checkpoints as torch ``state_dict``s
(HuggingFace, README.md:154-157).  This module renames and transposes those
arrays, given as ``{name: np.ndarray}`` (as in ``tests/goldens/*_fwd.npz``),
into the port's parameter names and layouts, which are the flax ones, and
loads them through ``weights.py`` with ``strict=True``.  It is a copy of
what the port needs from ``skeletondiffusion_tpu/utils/torch_port.py``
(`:25-123`; the port's recurrent cells are GRUs, so the LSTM's unused
``bias_ih`` rule is left out).  Layouts translated:

* graph-linear ``weight`` [types, out, in] → [types, in, out];
* recurrent ``weight_ih`` / ``weight_hh`` [types, gates·H, in] → [types, in, gates·H];
* ``nn.Linear`` ``weight`` [out, in] → ``kernel`` [in, out];
* the recurrent ``G`` lives on the cell in the reference
  (`recurrent.py:246-251`) and on the sequence module here (``G0``); the
  decoder's ``G`` goes to ``decoder.G0``.
"""
from __future__ import annotations

from typing import Dict

import numpy as np

from ..models.autoencoder import AutoEncoder
from ..models.denoiser import Denoiser
from ..weights import load_autoencoder_params, load_denoiser_params


def _glin(sd: Dict[str, np.ndarray], prefix: str) -> Dict[str, np.ndarray]:
    out = {"weight": np.swapaxes(sd[f"{prefix}.weight"], -1, -2)}
    for extra in ("bias", "G"):
        if f"{prefix}.{extra}" in sd:
            out[extra] = sd[f"{prefix}.{extra}"]
    return out


def _dense(sd: Dict[str, np.ndarray], prefix: str) -> Dict[str, np.ndarray]:
    return {"kernel": sd[f"{prefix}.weight"].T, "bias": sd[f"{prefix}.bias"]}


def _gru_cell(sd: Dict[str, np.ndarray], prefix: str) -> Dict[str, np.ndarray]:
    out = {name: np.swapaxes(sd[f"{prefix}.{name}"], -1, -2)
           for name in ("weight_ih", "weight_hh")}
    for extra in ("bias_ih", "bias_hh", "G_add"):
        if f"{prefix}.{extra}" in sd:
            out[extra] = sd[f"{prefix}.{extra}"]
    return out


def port_denoiser(sd: Dict[str, np.ndarray], depth: int, use_attention: bool = True) -> Dict:
    """A reference ``Denoiser`` state_dict → the port's parameter tree;
    without ``use_attention`` each attention residual's RMSNorm and graph
    linear (``layers.i.1.fn.norm``, ``layers.i.1.fn.fn``) go to
    ``attn{i}_norm`` and ``attn{i}_lin``."""
    p: Dict[str, Dict] = {
        "init_lin": _glin(sd, "init_lin"),
        "time_mlp0": _dense(sd, "time_mlp.1"),
        "time_mlp1": _dense(sd, "time_mlp.3"),
    }
    n_pairs = 2 * depth
    for i in range(n_pairs):
        res = {
            "mlp": _dense(sd, f"layers.{i}.0.mlp.1"),
            "block1": {"proj": _glin(sd, f"layers.{i}.0.block1.proj")},
            "block2": {"proj": _glin(sd, f"layers.{i}.0.block2.proj")},
        }
        if f"layers.{i}.0.res_linear.weight" in sd:
            res["res_linear"] = _glin(sd, f"layers.{i}.0.res_linear")
        p[f"res{i}"] = res
        if i == n_pairs - 1:
            continue
        if use_attention:
            p[f"attn{i}"] = {
                "norm": {"g": sd[f"layers.{i}.1.fn.norm.g"]},
                "attn": {
                    "to_qkv": _glin(sd, f"layers.{i}.1.fn.fn.to_qkv"),
                    "to_out": _glin(sd, f"layers.{i}.1.fn.fn.to_out"),
                },
            }
        else:
            p[f"attn{i}_norm"] = {"g": sd[f"layers.{i}.1.fn.norm.g"]}
            p[f"attn{i}_lin"] = _glin(sd, f"layers.{i}.1.fn.fn")
    p["final_res_block"] = {
        "mlp": _dense(sd, "final_res_block.mlp.1"),
        "block1": {"proj": _glin(sd, "final_res_block.block1.proj")},
        "block2": {"proj": _glin(sd, "final_res_block.block2.proj")},
        "res_linear": _glin(sd, "final_res_block.res_linear"),
    }
    p["final_glin"] = _glin(sd, "final_glin")
    return p


def port_autoencoder(sd: Dict[str, np.ndarray]) -> Dict:
    """A reference ``AutoEncoder`` state_dict (GRU, one layer each side) →
    the port's parameter tree."""
    return {
        "encoder": {
            "initial_hidden1": _glin(sd, "encoder.initial_hidden1"),
            "fc": _glin(sd, "encoder.fc"),
            "rnn": {"cell0": _gru_cell(sd, "encoder.rnn.layers.0"),
                    "G0": sd["encoder.rnn.layers.0.G"]},
        },
        "decoder": {
            "initial_hidden_h": _glin(sd, "decoder.initial_hidden_h"),
            "rollout": {"cell": _gru_cell(sd, "decoder.rnn.layers.0"),
                        "fc": _glin(sd, "decoder.fc")},
            "G0": sd["decoder.rnn.layers.0.G"],
        },
    }


def load_reference_denoiser(module: Denoiser, sd: Dict[str, np.ndarray]) -> Denoiser:
    """Load a reference ``Denoiser`` state_dict into ``module`` (its depth
    and whether it has attention read from the module)."""
    return load_denoiser_params(module, port_denoiser(sd, depth=module.n_pairs // 2,
                                                      use_attention=module.use_attention))


def load_reference_autoencoder(module: AutoEncoder, sd: Dict[str, np.ndarray]) -> AutoEncoder:
    """Load a reference ``AutoEncoder`` state_dict into ``module``."""
    if any(k.startswith("encoder.rnn.layers.1.") for k in sd):
        raise NotImplementedError(
            "the port's encoder has one recurrent layer (ROADMAP Queue A item 4b)")
    return load_autoencoder_params(module, port_autoencoder(sd))
