"""The port's diffusion variants on the CPU against the JAX package, at a small
size (21 AMASS nodes, latent 12, denoiser depth 1 × 2 heads × 4, 4 steps):

* the engine matrix of `tests/test_objective_matrix.py:29-35` (the isotropic
  process with pred_noise, pred_x0 and pred_v, the nonisotropic one with
  pred_noise and pred_x0, and tanh on the nonisotropic pred_x0): the loss,
  its gradients and injected-noise samples, ≤ 1e-5 a module and ≤ 1e-4 end
  to end; pred_v on the nonisotropic process refused as in JAX;
* ``ddim_sample`` with injected noise, the η = 1 full-schedule identity
  (`tests/test_ddim_equivalence.py:40`) and η = 0 determinism;
* ``p_sample_loop_interpolating`` on the JAX sampler's own step noise;
* the predictor without conditioning, with the plain decode and with DDIM,
  against the JAX predictor at 1e-4;
* one isotropic pred_noise k-best training step against the JAX trainer.

The modules (the denoiser variants, the plain decode) are held in
``tests/test_torch_process_variants.py``, whose ``diffusion_pair`` this file
shares.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skeletondiffusion_tpu.eval_pipeline import SkeletonDiffusionPredictor as JaxPredictor
from skeletondiffusion_tpu_torch.diffusion.manager import create_diffusion
from skeletondiffusion_tpu_torch.eval_pipeline import SkeletonDiffusionPredictor
from skeletondiffusion_tpu_torch.train.trainer_diffusion import TrainerDiffusion
from skeletondiffusion_tpu_torch.weights import flatten_params
from test_torch_process_variants import (E2E_TOL, ISO, MODULE_TOL, NONISO, L, N, T,
                                         assert_close, diffusion_pair, noise)
from torch_parity import OBS_LEN, PRED_LEN, as_jax, jax_models, port_models, skeletons

MATRIX = [(ISO, "pred_noise", "identity"), (ISO, "pred_x0", "identity"),
          (ISO, "pred_v", "identity"), (NONISO, "pred_noise", "identity"),
          (NONISO, "pred_x0", "identity"), (NONISO, "pred_x0", "tanh")]


@pytest.mark.parametrize("diffusion_type,objective,activation", MATRIX,
                         ids=[f"{d[:3]}-{o}-{a}" for d, o, a in MATRIX])
def test_engine_matrix_meets_jax(diffusion_type, objective, activation):
    jengine, _, params, engine, den = diffusion_pair(diffusion_type, objective,
                                                     diffusion_activation=activation,
                                                     diffusion_loss_type="l1")
    b, k = 3, 2
    x, x_cond = 0.5 * noise((b, N, L), 1), 0.5 * noise((b, N, L), 2)
    t, eps = np.array([0, 3, 2]), noise((b * k, N, L), 3)

    def jax_loss(p):
        loss, w, out = jengine.loss(p, jax.random.key(0), jnp.asarray(x), jnp.asarray(x_cond),
                                    n_train_samples=k, t=jnp.asarray(t), noise=jnp.asarray(eps))
        return jnp.mean(loss * jnp.repeat(w, k)), (loss, w, out)

    (jtotal, (jl, jw, jout)), jgrads = jax.value_and_grad(jax_loss, has_aux=True)(params)
    loss, w, out = engine.loss(torch.from_numpy(x), torch.from_numpy(x_cond), n_train_samples=k,
                               t=torch.from_numpy(t), noise=torch.from_numpy(eps))
    total = (loss * w.repeat_interleave(k)).mean()
    total.backward()
    for what, got, want in (("loss", loss.detach(), jl), ("weights", w, jw),
                            ("model output", out.detach(), jout),
                            ("total", total.detach(), jtotal)):
        assert_close(got, want, MODULE_TOL, what)
    jgrads = flatten_params(jax.device_get(jgrads))
    for name, p in den.named_parameters():
        assert_close(p.grad, jgrads[name], MODULE_TOL, f"gradient of {name}")

    rows = 4
    start, steps = noise((rows, N, L), 4), noise((rows, T - 1, N, L), 5)
    want, _ = jengine.sample(params, jax.random.key(1), batch_size=rows,
                             x_cond=jnp.asarray(x_cond[:1].repeat(rows, 0)),
                             start_noise=jnp.asarray(start), step_noise=jnp.asarray(steps))
    got, got_start = engine.sample(torch.from_numpy(x_cond[:1].repeat(rows, 0)), None,
                                   torch.from_numpy(start), torch.from_numpy(steps))
    assert torch.equal(got_start, torch.from_numpy(start))
    assert_close(got, want, E2E_TOL, "samples")


def test_nonisotropic_pred_v_refused_as_in_jax():
    with pytest.raises(NotImplementedError):
        diffusion_pair(NONISO, "pred_v")
    with pytest.raises(NotImplementedError):
        create_diffusion(skeletons()[1], torch.Generator(), diffusion_objective="pred_v",
                         device="cpu")


@pytest.mark.parametrize("objective", ["pred_x0", "pred_noise"])
def test_ddim_meets_jax_with_injected_noise(objective):
    """DDIM over 3 of 4 steps (pairs (3, 1), (1, 0), (0, −1)) at η = 0.5."""
    jengine, _, params, engine, _ = diffusion_pair(ISO, objective, sampling_timesteps=3,
                                                   ddim_sampling_eta=0.5)
    assert engine.is_ddim_sampling and engine.ddim_time_pairs() == [(3, 1), (1, 0), (0, -1)]
    rows = 4
    x_cond, start, steps = (noise(s, i) for i, s in enumerate(
        [(rows, N, L), (rows, N, L), (rows, 2, N, L)], start=6))
    want, _ = jengine.sample(params, jax.random.key(2), batch_size=rows,
                             x_cond=jnp.asarray(x_cond), start_noise=jnp.asarray(start),
                             step_noise=jnp.asarray(steps))
    got, _ = engine.sample(torch.from_numpy(x_cond), None, torch.from_numpy(start),
                           torch.from_numpy(steps))
    assert_close(got, want, E2E_TOL, f"DDIM {objective}")


def test_ddim_eta1_full_schedule_is_ancestral_and_eta0_deterministic():
    """`tests/test_ddim_equivalence.py` on the port: with η = 1 over all T
    steps DDIM's update is the posterior step (pathwise, the same noise);
    with η = 0 it draws nothing."""
    _, _, _, engine, den = diffusion_pair(ISO, "pred_x0", sampling_timesteps=T,
                                          ddim_sampling_eta=1.0)
    assert not engine.is_ddim_sampling
    rows = 4
    x_cond, start = (torch.from_numpy(noise((rows, N, L), seed)) for seed in (9, 10))
    steps = torch.from_numpy(noise((rows, T - 1, N, L), 11))
    want, _ = engine.p_sample_loop(x_cond, None, start, steps)
    got, _ = engine.ddim_sample(x_cond, None, start, steps)
    assert_close(got, want, 2e-5, "η = 1 DDIM against ancestral")
    engine.ddim_sampling_eta = 0.0
    a, _ = engine.ddim_sample(x_cond, torch.Generator().manual_seed(1), start)
    b, _ = engine.ddim_sample(x_cond, torch.Generator().manual_seed(2), start)
    c, _ = engine.ddim_sample(x_cond, None, start)
    assert torch.equal(a, b) and torch.equal(a, c) and torch.isfinite(a).all()


def test_interpolating_sampler_meets_jax():
    """``p_sample_loop_interpolating`` with the JAX sampler's own per-step
    noise (fold_in of the step key at t) injected into the port."""
    jengine, _, params, engine, _ = diffusion_pair(NONISO, "pred_x0")
    rows = 3
    shape = (rows, N, L)
    x_cond, start = noise(shape, 12), noise(shape, 13)
    other = noise((rows, T - 1, N, L), 14)
    key = jax.random.key(3)
    _, rng_steps = jax.random.split(key)
    own = np.stack([np.asarray(jax.random.normal(jax.random.fold_in(rng_steps, t), shape))
                    for t in range(T - 1, 0, -1)], axis=1)  # row T-1-t
    mix = lambda a, b: 0.6 * a + 0.8 * b  # noqa: E731
    want, _ = jengine.p_sample_loop_interpolating(
        params, key, shape, jnp.asarray(other), mix, x_cond=jnp.asarray(x_cond),
        start_noise=jnp.asarray(start))
    got, _ = engine.p_sample_loop_interpolating(
        torch.from_numpy(x_cond), torch.from_numpy(other), mix, start_noise=torch.from_numpy(start),
        step_noise=torch.from_numpy(own))
    assert_close(got, want, E2E_TOL, "interpolating sampler")


PREDICTORS = {
    "unconditioned": dict(diffusion_conditioning=False),
    "plain_decode": dict(use_fused_decode=False),
    "ddim_pred_noise": dict(diffusion_type=ISO, diffusion_objective="pred_noise",
                            sampling_timesteps=2),
}


@pytest.mark.parametrize("variant", sorted(PREDICTORS))
def test_predictor_variant_meets_jax(variant):
    """The port's predictor against the JAX one (jitted), same weights and
    injected sampler noise: latents and metric-space predictions at 1e-4."""
    kw = dict(PREDICTORS[variant])
    use_fused_decode = kw.pop("use_fused_decode", None)
    conditioning = kw.get("diffusion_conditioning", True)
    jsk, sk = skeletons()
    jae, ae_params, _, _, den_params = jax_models(jsk, seed=6, latent=L)
    ae, _, _ = port_models(sk, ae_params, den_params, latent=L)
    jengine, _, params, engine, _ = diffusion_pair(kw.pop("diffusion_type", NONISO),
                                                   kw.pop("diffusion_objective", "pred_x0"), **kw)
    b, s = 2, 3
    opts = dict(num_samples=s, pred_length=PRED_LEN, use_fused_decode=use_fused_decode)
    jpred = JaxPredictor(jsk, jae, as_jax(ae_params), jengine, params,
                         diffusion_conditioning=conditioning, **opts)
    pred = SkeletonDiffusionPredictor(sk, ae, engine, device="cpu", **opts)
    assert not pred.use_fused_denoiser
    assert pred.diffusion_conditioning == conditioning
    steps = (engine.sampling_timesteps if engine.is_ddim_sampling else T) - 1
    obs, start, step_noise = (noise(shape, i) for i, shape in enumerate(
        [(b, OBS_LEN, N, 3), (b * s, N, L), (b * s, steps, N, L)], start=19))
    obs = 0.3 * obs
    want, want_lat = jpred(jax.random.key(0), jnp.asarray(obs), start_noise=jnp.asarray(start),
                           step_noise=jnp.asarray(step_noise))
    got, got_lat = pred(None, torch.from_numpy(obs), start_noise=torch.from_numpy(start),
                        step_noise=torch.from_numpy(step_noise))
    assert_close(got_lat, want_lat, E2E_TOL, "latents")
    assert_close(sk.transform_to_metric_space(got), jsk.transform_to_metric_space(want), E2E_TOL,
                 "predictions, metric space")


def test_isotropic_kbest_step_meets_the_jax_trainer():
    """One k-best (k = 3, input space) step of the isotropic pred_noise model
    with the l1 loss: the raw model output, a noise prediction, is decoded
    for the choice, as in JAX and the reference.  The loss at 1e-5, the
    gradients at 1e-4 (the choice decodes 10 steps); an unconditioned model
    is refused, as the JAX trainer asserts."""
    from skeletondiffusion_tpu.train.trainer_diffusion import TrainerDiffusion as JaxTrainer

    jsk, sk = skeletons()
    jae, ae_params, _, _, den_params = jax_models(jsk, seed=7, latent=L)
    ae, _, _ = port_models(sk, ae_params, den_params, latent=L)
    jengine, _, params, engine, den = diffusion_pair(ISO, "pred_noise", diffusion_loss_type="l1")
    k, b = 3, 2
    opts = dict(train_pick_best_sample_among_k=k, similarity_space="input_space",
                if_use_ema=False, prediction_horizon_eval=PRED_LEN, lr=1e-3)
    jtr = JaxTrainer(jengine, jae, as_jax(ae_params), skeleton=jsk, **opts)
    tr = TrainerDiffusion(engine, ae, skeleton=sk, **opts)
    x, y = 0.3 * noise((b, OBS_LEN, N, 3), 22), 0.3 * noise((b, PRED_LEN, N, 3), 23)
    t, eps = np.array([1, 3]), noise((b * k, N, L), 24)
    jx, jy = jnp.asarray(x), jnp.asarray(y)
    z_past, z = jtr._embed(jx, jy)
    jloss, jgrads = jax.value_and_grad(lambda p: jtr.loss(
        p, jax.random.key(0), jx, jy, z, z_past, t=jnp.asarray(t), noise=jnp.asarray(eps)))(params)
    x_t, y_t = torch.from_numpy(x), torch.from_numpy(y)
    zp, zz = tr.embed(x_t, y_t)
    loss = tr.loss(x_t, y_t, zz, zp, t=torch.from_numpy(t), noise=torch.from_numpy(eps))
    loss.backward()
    assert_close(loss.detach(), jloss, MODULE_TOL, "k-best loss")
    jgrads = flatten_params(jax.device_get(jgrads))
    for name, p in den.named_parameters():
        assert_close(p.grad, jgrads[name], E2E_TOL, f"gradient of {name}")
    uncond = diffusion_pair(ISO, "pred_noise", diffusion_conditioning=False)[3]
    with pytest.raises(ValueError, match="conditioning"):
        TrainerDiffusion(uncond, ae, skeleton=sk, **opts)
