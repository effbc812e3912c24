"""The bf16 prediction path on the CPU: the port's fused denoiser core
against the JAX one, the bf16 plain modules against the flax modules with
``compute_dtype="bfloat16"``, and the bf16 predictor end to end against the
JAX fused chain composed by hand as ``tests/test_fused_sampling.py`` composes
it (Pallas kernels with ``interpret=True``).

Size: the 21-node AMASS skeleton at the flagship's widths (latent 96, so
F = 192; 8 heads × 32) with denoiser depth 2, encoder/decoder hidden 16 and
4 diffusion steps; 2 observations × 4 samples.

Tolerances: the fused core in float32 at 5e-5 (atol, rtol 1e-4), the
tolerance of ``test_fused_denoiser_matches_flax``; bf16 results at the bf16
criteria of ``torch_parity.assert_bf16_close``; the bf16 predictor end to
end against the JAX chain's own bf16-vs-fp32 deviation on the same inputs
(``torch_parity.BF16_SPREAD``).

The denoiser's weights are spread to N(0, 1/fan_in) (``spread_weights``) so
that its x̂₀ is O(1) as a trained model's is; at the init's scale (~1e-2)
every bf16 effect would sit in the last rounding of the output."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skeletondiffusion_tpu.models import AutoEncoder as JaxAutoEncoder
from skeletondiffusion_tpu.ops.pallas import denoiser_fused as jax_fused
from skeletondiffusion_tpu_torch.ops.kernels import denoiser_fused

from torch_parity import (BF16_SPREAD, OBS_LEN, TIMESTEPS, WIDE, assert_bf16_close,
                          bf16_predictor_ratios, hold_bf16_predictor, wide_model_pair)

N, L, B, S = 21, WIDE["latent"], 2, 4
ROWS = B * S


def pad_to(a, size):
    return jnp.pad(a, [(0, 0)] * (a.ndim - 1) + [(0, size - a.shape[-1])])


@pytest.fixture(scope="module")
def models():
    """(JAX skeleton, port skeleton, {dtype: models}) with the same weights
    for float32 and bfloat16 (compute_dtype adds no parameter)."""
    return wide_model_pair()


def _inputs(seed: int):
    rng = np.random.default_rng(seed)
    x = 0.5 * rng.standard_normal((N, ROWS, L), dtype=np.float32)
    xc = np.tanh(rng.standard_normal((ROWS, N, L), dtype=np.float32))
    return x, xc


@pytest.mark.parametrize("dtype", [None, "bfloat16"])
@pytest.mark.parametrize("t", [0, TIMESTEPS - 1])
def test_fused_core_matches_jax(models, dtype, t):
    _, _, m = models
    m = m[dtype]
    x, xc = _inputs(t)
    u = m["jden"].apply(m["den_params"], jnp.asarray(xc), method=m["jden"].cond_embedding)
    want = jax_fused.fused_denoiser_core_nm(
        m["jden"], m["den_params"], pad_to(jnp.asarray(x), 128), jnp.asarray(t, jnp.int32),
        pad_to(u, 256), batch_tile=8, interpret=True)[:, :, :L]
    with torch.no_grad():
        u_port = m["den"].cond_embedding(torch.from_numpy(xc))
        got = denoiser_fused.fused_denoiser_core_nm(m["den"], torch.from_numpy(x), t, u_port)
    assert got.shape == (N, ROWS, L)
    want = np.asarray(want.astype(jnp.float32))
    if dtype is None:
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, atol=5e-5, rtol=1e-4)
    else:
        assert got.dtype == torch.bfloat16
        assert_bf16_close(got.float().numpy(), want)


def test_fused_core_matches_the_plain_module(models):
    """The kernel chain computes the Denoiser module's forward (float32)."""
    _, _, m = models
    den = m[None]["den"]
    x, xc = _inputs(5)
    with torch.no_grad():
        u = den.cond_embedding(torch.from_numpy(xc))
        want = den(torch.from_numpy(x), 2, u)
        got = denoiser_fused.fused_denoiser_core_nm(den, torch.from_numpy(x), 2, u,
                                                    denoiser_fused.prep_fused_denoiser(den))
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=5e-5, rtol=1e-4)


def test_bf16_denoiser_module_matches_flax(models):
    _, _, m = models
    m = m["bfloat16"]
    x, xc = _inputs(6)
    x_bm = np.ascontiguousarray(x.transpose(1, 0, 2))
    u = m["jden"].apply(m["den_params"], jnp.asarray(xc), method=m["jden"].cond_embedding)
    want = m["jden"].apply(m["den_params"], jnp.asarray(x_bm), jnp.asarray(1, jnp.int32),
                           u_cond=u)
    with torch.no_grad():
        got = m["den"](torch.from_numpy(x), 1, m["den"].cond_embedding(torch.from_numpy(xc)))
    assert got.dtype == torch.float32
    assert_bf16_close(got.transpose(0, 1).numpy(), np.asarray(want), "denoiser")


def test_bf16_encoder_matches_flax(models):
    _, _, m = models
    m = m["bfloat16"]
    obs = 0.3 * np.random.default_rng(7).standard_normal((B, OBS_LEN, N, 3), dtype=np.float32)
    want = m["jae"].apply(m["ae_params"], jnp.asarray(obs),
                          method=JaxAutoEncoder.get_past_embedding)
    with torch.no_grad():
        got = m["ae"].get_past_embedding(torch.from_numpy(obs))
    assert_bf16_close(got.numpy(), np.asarray(want), "past embedding")


def test_bf16_predictor_matches_jax_fused_chain(models):
    jsk, sk, m = models
    hold_bf16_predictor(jsk, sk, m, seed=8)


def test_bf16_predictor_spread_depends_on_the_inputs(models):
    """``BF16_SPREAD`` holds on the inputs of seed 8 (above) but not on every
    input: on those of seed 21 the port's bf16 predictions lie up to 1.54×
    as far from the JAX fp32 chain as the JAX bf16 chain's do, while the
    means stay within the bound.  Whether that maximum is an artefact of the
    random weights is ROADMAP Queue C item 1; when it changes, so does this
    reading."""
    jsk, sk, m = models
    ratios = bf16_predictor_ratios(jsk, sk, m, seed=21)
    assert ratios["predictions"]["vs_fp32_max"] > BF16_SPREAD
    for what, r in ratios.items():
        assert r["vs_fp32_mean"] <= BF16_SPREAD and r["vs_jax_bf16_mean"] <= BF16_SPREAD, what
