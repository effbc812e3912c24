"""Reference-named weights: the reference's torch ``state_dict``s loaded into
the port's ``Denoiser`` and ``AutoEncoder``.

The reference distributes trained checkpoints as torch ``state_dict``s
(HuggingFace, README.md:154-157).  This module renames and transposes those
arrays, given as ``{name: np.ndarray}`` (as in ``tests/goldens/*_fwd.npz``),
into the port's parameter names and layouts, which are the flax ones, and
loads them through ``weights.py`` with ``strict=True``.  It is a copy of
``skeletondiffusion_tpu/utils/torch_port.py`` (`:25-123`): every
AutoEncoder variant (the LSTM cells, whose reference ``bias_ih`` never
enters the forward pass and has no parameter here, and an encoder of
several layers).  Layouts translated:

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


def _rnn_cell(sd: Dict[str, np.ndarray], prefix: str) -> Dict[str, np.ndarray]:
    out = {name: np.swapaxes(sd[f"{prefix}.{name}"], -1, -2)
           for name in ("weight_ih", "weight_hh")}
    # an LSTM cell (4H gates) has no bias_ih: the reference defines it but
    # never uses it (`recurrent.py:149-150`)
    hidden = out["weight_hh"].shape[-2]
    is_lstm = out["weight_hh"].shape[-1] == 4 * hidden
    for extra in (("bias_hh", "G_add") if is_lstm else ("bias_ih", "bias_hh", "G_add")):
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


def port_autoencoder(sd: Dict[str, np.ndarray], enc_num_layers: int = 1) -> Dict:
    """A reference ``AutoEncoder`` state_dict (GRU or LSTM cells,
    ``enc_num_layers`` encoder layers) → the port's parameter tree."""
    enc: Dict[str, Dict] = {
        "initial_hidden1": _glin(sd, "encoder.initial_hidden1"),
        "fc": _glin(sd, "encoder.fc"),
        "rnn": {},
    }
    for i in range(enc_num_layers):
        enc["rnn"][f"cell{i}"] = _rnn_cell(sd, f"encoder.rnn.layers.{i}")
        enc["rnn"][f"G{i}"] = sd[f"encoder.rnn.layers.{i}.G"]
    if "encoder.initial_hidden_c.weight" in sd:
        enc["initial_hidden_c"] = _glin(sd, "encoder.initial_hidden_c")
    dec: Dict[str, Dict] = {
        "initial_hidden_h": _glin(sd, "decoder.initial_hidden_h"),
        "rollout": {"cell": _rnn_cell(sd, "decoder.rnn.layers.0"),
                    "fc": _glin(sd, "decoder.fc")},
        "G0": sd["decoder.rnn.layers.0.G"],
    }
    if "decoder.initial_hidden_c.weight" in sd:
        dec["initial_hidden_c"] = _glin(sd, "decoder.initial_hidden_c")
    return {"encoder": enc, "decoder": dec}


def load_reference_denoiser(module: Denoiser, sd: Dict[str, np.ndarray]) -> Denoiser:
    """Load a reference ``Denoiser`` state_dict into ``module`` (its depth
    and whether it has attention read from the module)."""
    return load_denoiser_params(module, port_denoiser(sd, depth=module.n_pairs // 2,
                                                      use_attention=module.use_attention))


def load_reference_autoencoder(module: AutoEncoder, sd: Dict[str, np.ndarray]) -> AutoEncoder:
    """Load a reference ``AutoEncoder`` state_dict into ``module`` (its
    encoder's number of layers read from the module)."""
    return load_autoencoder_params(
        module, port_autoencoder(sd, enc_num_layers=module.encoder.rnn.num_layers))
