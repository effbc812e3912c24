#!/usr/bin/env python3
"""Writes ``tests/goldens/wide_bf16.npz``: the JAX package's fused prediction
chain at the flagship's widths (``tests/torch_parity.py::WIDE``: the 21-node
AMASS skeleton, latent 96, denoiser depth 2 with 8 heads × 32, the weights of
``wide_model_pair``), in bf16 and in fp32, on the inputs the port's bf16
predictor tests give it:

* ``fused_s8``: the single-stage chain on the inputs of seed 8
  (``tests/test_torch_fused.py::test_bf16_predictor_matches_jax_fused_chain``);
* ``fused_s21``: the same on seed 21 (``...spread_depends_on_the_inputs``);
* ``layer_fused_s9``: the chain with ``SKELDIFF_LAYER_FUSED=1`` on seed 9
  (``tests/test_torch_layer_fused.py::test_layer_fused_bf16_predictor_matches_jax_chain``);
* ``fused_s8_1step``: the single-stage chain of a one-step model on seed 8,
  which ``tests/test_torch_fused.py::test_the_golden_holds_the_live_jax_chain``
  runs live and holds to this file.

    JAX_PLATFORMS=cpu python3 scripts/wide_bf16_golden.py   # ~5 min

The chain is ``tests/torch_parity.py::jax_fused_chain`` (its Pallas kernels
in interpret mode on the CPU, the bf16 core op by op, the fp32 one compiled)
with ``TIMESTEPS`` diffusion steps (1 for ``fused_s8_1step``), 2 observations
× 4 samples, observe 6, predict 10, and the injected noise of
``predictor_inputs``.  Each run keeps the latents (the sampler's final
state) and the metric-space predictions, as ``<name>_<fp32|bf16>_<latents|
predictions>``.  Regenerate it after a change to the JAX package's chain or
to ``torch_parity``'s models or inputs.
"""
from __future__ import annotations

import os
import pathlib
import sys
import time
from unittest import mock

import jax

jax.config.update("jax_platforms", "cpu")

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path[:0] = [str(REPO), str(REPO / "tests")]

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import torch_parity as tp  # noqa: E402


def chain_runs(seed: int, layer_fused: bool) -> dict:
    """{"fp32" | "bf16": (latents, predictions)} of the JAX chain on the
    inputs of ``seed``, the layer-fused core when ``layer_fused``."""
    jsk, sk, m = tp.wide_model_pair()
    inputs = tp.predictor_inputs(sk.num_nodes, m[None]["latent"], seed)
    with mock.patch.dict(os.environ, {"SKELDIFF_LAYER_FUSED": "1" if layer_fused else "0"}):
        return {name: tp.jax_fused_chain(jsk, m[d], *map(jnp.asarray, inputs),
                                         compiled=d is None)
                for name, d in (("fp32", None), ("bf16", "bfloat16"))}


def main() -> int:
    start = time.perf_counter()
    runs = {name: chain_runs(seed, layer_fused)
            for name, (seed, layer_fused) in tp.WIDE_GOLDEN_RUNS.items()}
    with mock.patch.object(tp, "TIMESTEPS", 1):
        runs[tp.WIDE_GOLDEN_LIVE] = chain_runs(tp.WIDE_GOLDEN_RUNS["fused_s8"][0], False)
    tp.WIDE_GOLDEN.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(tp.WIDE_GOLDEN, **{
        f"{name}_{dt}_{what}": run[dt][i] for name, run in runs.items() for dt in run
        for i, what in enumerate(("latents", "predictions"))})
    print(f"wrote {tp.WIDE_GOLDEN} in {time.perf_counter() - start:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
