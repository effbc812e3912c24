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
(see ``BF16_SPREAD``).

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
from skeletondiffusion_tpu.ops.pallas.gru_rollout import decode_rollout
from skeletondiffusion_tpu.ops.pallas.posterior_step import posterior_step_pallas
from skeletondiffusion_tpu_torch.eval_pipeline import SkeletonDiffusionPredictor
from skeletondiffusion_tpu_torch.ops.kernels import denoiser_fused

from torch_parity import (OBS_LEN, PRED_LEN, TIMESTEPS, WIDE, as_jax, assert_bf16_close,
                          jax_models, port_models, skeletons)

N, L, B, S = 21, WIDE["latent"], 2, 4
ROWS = B * S
# Two bf16 chains that round at the same points but sum in another order
# drift apart: a sum lands on the other side of a rounding point now and
# then, and the next layers carry the flip on, so over the 15 layers of depth
# 2 their difference grows to the size of their rounding error itself.  The
# port's plain bf16 encoder also rounds after every PyTorch op where XLA
# keeps fused elementwise chains in fp32.  Measured on these inputs: port vs
# JAX bf16 mean |Δ| 0.85× (latents) and 1.04× (predictions) the JAX
# bf16-vs-fp32 mean; port bf16 vs JAX fp32 1.24× the JAX bf16-vs-fp32 max
# (latents) and 1.42× (predictions).  So each deviation is held within this
# factor of the JAX bf16 path's own deviation from fp32.
BF16_SPREAD = 1.5


def pad_to(a, size):
    return jnp.pad(a, [(0, 0)] * (a.ndim - 1) + [(0, size - a.shape[-1])])


@pytest.fixture(scope="module")
def models():
    """{dtype: (JAX models, port models)} with the same weights for float32
    and bfloat16 (compute_dtype adds no parameter)."""
    jsk, sk = skeletons()
    out = {}
    for dtype in (None, "bfloat16"):
        jae, ae_params, jengine, jden, den_params = jax_models(
            jsk, seed=3, latent=L, hidden=WIDE["hidden"], arch=WIDE["arch"], compute_dtype=dtype,
            spread=True)
        ae, engine, den = port_models(sk, ae_params, den_params, latent=L, hidden=WIDE["hidden"],
                                      arch=WIDE["arch"], compute_dtype=dtype)
        out[dtype] = dict(jae=jae, ae_params=as_jax(ae_params), jengine=jengine, jden=jden,
                          den_params=as_jax(den_params), ae=ae, engine=engine, den=den)
    return jsk, sk, out


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


def _jax_chain(jsk, m, obs, start, steps):
    """The JAX package's fused prediction path composed by hand: past
    embedding, the fused core and ``posterior_step_pallas`` for each step,
    ``decode_rollout``, the metric-space transform."""
    jden, params = m["jden"], m["den_params"]
    z = m["jae"].apply(m["ae_params"], obs, method=JaxAutoEncoder.get_past_embedding)
    x_cond = jnp.repeat(z, S, axis=0)
    u_pad = pad_to(jden.apply(params, x_cond, method=jden.cond_embedding), 256)
    prepped = jax_fused.prep_fused_denoiser(jden, params)
    tables = m["jengine"].process.posterior_step_tables()
    img = pad_to(jnp.swapaxes(start, 0, 1), 128)
    for t in range(TIMESTEPS - 1, -1, -1):
        mo = jax_fused.fused_denoiser_core_nm(jden, params, img, jnp.asarray(t, jnp.int32),
                                              u_pad, prepped=prepped, batch_tile=8,
                                              interpret=True)
        noise = steps[:, TIMESTEPS - 1 - t] if t > 0 else jnp.zeros_like(start)
        img = posterior_step_pallas(mo, img, pad_to(jnp.swapaxes(noise, 0, 1), 128), tables[t],
                                    batch_tile=8, interpret=True)
    latents = jnp.swapaxes(img[:, :, :L], 0, 1)
    pred = decode_rollout(m["ae_params"]["params"]["decoder"], jsk.nodes_type_id,
                          jnp.repeat(obs, S, axis=0)[:, -2:], latents, PRED_LEN, batch_tile=8,
                          interpret=True)
    return (np.asarray(latents).reshape(B, S, N, L),
            np.asarray(jsk.transform_to_metric_space(pred.reshape(B, S, PRED_LEN, N, 3))))


def test_bf16_predictor_matches_jax_fused_chain(models):
    jsk, sk, m = models
    rng = np.random.default_rng(8)
    obs = 0.3 * rng.standard_normal((B, OBS_LEN, N, 3), dtype=np.float32)
    start = rng.standard_normal((ROWS, N, L), dtype=np.float32)
    steps = rng.standard_normal((ROWS, TIMESTEPS - 1, N, L), dtype=np.float32)
    chain = {d: _jax_chain(jsk, m[d], *map(jnp.asarray, (obs, start, steps)))
             for d in (None, "bfloat16")}

    bf16 = m["bfloat16"]
    pred = SkeletonDiffusionPredictor(sk, bf16["ae"], bf16["engine"], num_samples=S,
                                      pred_length=PRED_LEN, device="cpu")
    assert pred.diffusion.fused is not None  # the fused branch is taken
    got, got_lat = pred(None, torch.from_numpy(obs), start_noise=torch.from_numpy(start),
                        step_noise=torch.from_numpy(steps))
    got = sk.transform_to_metric_space(got).numpy()
    assert got.shape == (B, S, PRED_LEN, N, 3) and np.isfinite(got).all()

    for what, mine, i in (("latents", got_lat.numpy(), 0), ("predictions", got, 1)):
        ref, fp32 = chain["bfloat16"][i], chain[None][i]
        vs_jax_bf16, jax_err, port_err = (np.abs(mine - ref), np.abs(ref - fp32),
                                          np.abs(mine - fp32))
        print(f"{what}: port bf16 vs JAX bf16 max |Δ| {vs_jax_bf16.max():.3e} mean "
              f"{vs_jax_bf16.mean():.3e}; JAX bf16 vs JAX fp32 max {jax_err.max():.3e} mean "
              f"{jax_err.mean():.3e}; port bf16 vs JAX fp32 max {port_err.max():.3e} mean "
              f"{port_err.mean():.3e}")
        # the port's bf16 path is as close to fp32 as the JAX package's is
        assert port_err.max() <= BF16_SPREAD * jax_err.max(), what
        assert port_err.mean() <= BF16_SPREAD * jax_err.mean(), what
        # and no farther from the JAX bf16 path than the bf16 rounding noise
        assert vs_jax_bf16.mean() <= BF16_SPREAD * jax_err.mean(), what
