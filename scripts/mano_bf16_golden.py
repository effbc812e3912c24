#!/usr/bin/env python3
"""Writes ``tests/goldens/mano_bf16.npz``: the JAX package's fused prediction
chain at AMASS-MANO's 51 nodes, in bf16 and in fp32, on the inputs that
``tests/test_torch_mano_paths.py::test_bf16_predictor_holds_the_jax_golden``
gives the port's bf16 predictor.

    JAX_PLATFORMS=cpu python3 scripts/mano_bf16_golden.py   # ~2 min

The chain is ``tests/torch_parity.py::jax_fused_chain``: the past embedding,
the fused denoiser core and ``posterior_step_pallas`` each step, the decode,
the metric-space transform, its Pallas kernels in interpret mode on the CPU
(the bf16 core op by op, the fp32 one compiled); at ``MANO_SMALL``'s widths
(latent 32, hidden 16, depth 1 with 4 heads × 32), ``MANO_GOLDEN_STEPS``
diffusion steps, 2 observations × 4 samples, observe 6, predict 10, with
the injected noise of ``predictor_inputs`` from ``MANO_GOLDEN_INPUT_SEED``
and the weights of ``model_pair`` from ``MANO_GOLDEN_WEIGHT_SEED``.  The
file keeps both seeds, the step count, and each run's latents (the
sampler's final state) and predictions.
"""
from __future__ import annotations

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


def main() -> int:
    start = time.perf_counter()
    with mock.patch.object(tp, "TIMESTEPS", tp.MANO_GOLDEN_STEPS):
        jsk, sk = tp.skeletons_of("amass-mano", 52)
        m = tp.model_pair(jsk, sk, tp.MANO_SMALL, seed=tp.MANO_GOLDEN_WEIGHT_SEED)
        inputs = tp.predictor_inputs(sk.num_nodes, m[None]["latent"], tp.MANO_GOLDEN_INPUT_SEED)
        runs = {name: tp.jax_fused_chain(jsk, m[d], *map(jnp.asarray, inputs), compiled=d is None)
                for name, d in (("fp32", None), ("bf16", "bfloat16"))}
    tp.MANO_GOLDEN.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(
        tp.MANO_GOLDEN, input_seed=tp.MANO_GOLDEN_INPUT_SEED,
        weight_seed=tp.MANO_GOLDEN_WEIGHT_SEED, timesteps=tp.MANO_GOLDEN_STEPS,
        **{f"{name}_{what}": run[i] for name, run in runs.items()
           for i, what in enumerate(("latents", "predictions"))})
    dev = {what: np.abs(runs["bf16"][i] - runs["fp32"][i]) for i, what in
           enumerate(("latents", "predictions"))}
    print(f"wrote {tp.MANO_GOLDEN} in {time.perf_counter() - start:.1f} s; JAX bf16 vs fp32 "
          + ", ".join(f"{k} max {v.max():.3e} mean {v.mean():.3e}" for k, v in dev.items()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
