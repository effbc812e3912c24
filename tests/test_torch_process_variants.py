"""The port's diffusion processes and variant modules on the CPU:

* ``IsotropicProcess`` against the reference's ``iso.npz``, the nonisotropic
  process's pred_noise and noise combination against ``noniso_amass.npz``,
  both processes against the JAX builders over objectives × beta schedules,
  the run-as-isotropic identity (`tests/test_isotropic_equivalence.py`), and
  the step tables: the posterior-step kernel's plain version on them equals
  the JAX engine's q_posterior step;
* the unconditioned, self-conditioned and attention-free denoisers through
  both weight bridges (flax trees, reference-named ``state_dict``s) at 1e-5,
  at a small size (21 AMASS nodes, latent 12, depth 1 × 2 heads × 4, 4
  steps; ``diffusion_pair``, shared with
  ``tests/test_torch_engine_variants.py``);
* the plain decode in bf16 within ``BF16_SPREAD`` of the flax decode's own
  bf16-vs-fp32 deviation.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skeletondiffusion_tpu.diffusion.manager import create_diffusion as jax_create_diffusion
from skeletondiffusion_tpu.models import AutoEncoder as JaxAutoEncoder
from skeletondiffusion_tpu.utils.torch_port import port_denoiser as jax_port_denoiser
from skeletondiffusion_tpu.diffusion import (
    build_isotropic_process as jax_build_isotropic,
    build_nonisotropic_process as jax_build_nonisotropic,
    get_cov_from_corr as jax_get_cov_from_corr,
)
from skeletondiffusion_tpu_torch.diffusion.covariance import get_cov_from_corr
from skeletondiffusion_tpu_torch.diffusion.manager import create_diffusion
from skeletondiffusion_tpu_torch.diffusion.engine import posterior_update_plain
from skeletondiffusion_tpu_torch.diffusion.process import (
    IsotropicProcess,
    build_isotropic_process,
    build_nonisotropic_process,
)
from skeletondiffusion_tpu_torch.ops.kernels.posterior_step import posterior_step_plain
from skeletondiffusion_tpu_torch.utils.torch_port import load_reference_denoiser
from skeletondiffusion_tpu_torch.weights import flatten_params, load_denoiser_params
from torch_parity import (BF16_SPREAD, OBS_LEN, PRED_LEN, as_jax, jax_models,
                          perturb_influence, port_models, skeletons, spread_weights)

GOLD = os.path.join(os.path.dirname(__file__), "goldens")
ISO_TABLES = ("betas", "alphas_cumprod", "alphas_cumprod_prev", "sqrt_alphas_cumprod",
              "sqrt_one_minus_alphas_cumprod", "sqrt_recip_alphas_cumprod",
              "sqrt_recipm1_alphas_cumprod", "posterior_variance",
              "posterior_log_variance_clipped", "posterior_mean_coef1", "posterior_mean_coef2",
              "loss_weight")
STEPS = 10
# (schedule, steps): the linear schedule's betas exceed 1 below ~20 steps
SCHEDULES = [("cosine", 10), ("linear", 50), ("exp", 10)]


def golden(name):
    return np.load(os.path.join(GOLD, name))


def t_(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a))


def close(got, want, atol, what=""):
    """|Δ| ≤ atol + 1e-6·|want| (float32 sums in another order)."""
    np.testing.assert_allclose(np.asarray(got, dtype=np.float64),
                               np.asarray(want, dtype=np.float64), atol=atol, rtol=1e-6,
                               err_msg=what)


def test_isotropic_process_meets_iso_golden():
    """Tables at `tests/test_diffusion_goldens.py:127`'s 2e-5; q_sample and
    the posterior mean and (log-)variance at its 1e-5."""
    g = golden("iso.npz")
    proc = build_isotropic_process(21, timesteps=STEPS, objective="pred_x0",
                                   beta_schedule="cosine", device="cpu")
    for name in ISO_TABLES:
        close(getattr(proc, name), g[name].astype(np.float32), 2e-5, name)
    x0, xt, noise = (t_(g[k]) for k in ("x0", "xt", "noise"))
    t = t_(g["t"]).long()
    close(proc.q_sample(x0, t, noise), g["q_sample"], 1e-5, "q_sample")
    mean, var, logvar = proc.q_posterior(x0, xt, t)
    close(mean, g["post_mean"], 1e-5, "post_mean")
    close(var, g["post_var"], 1e-5, "post_var")
    close(logvar, g["post_logvar"], 1e-4, "post_logvar")


def test_nonisotropic_pred_noise_and_combination_meet_noniso_golden():
    """The reference's ``predict_noise_from_start`` and
    ``combine_mean_var_noise`` (at `tests/test_diffusion_goldens.py`'s 1e-3
    and 1e-4), on the golden's own eigensystem; with pred_noise the loss
    weight is 1 and the x₀ ↔ noise conversions invert each other."""
    g = golden("noniso_amass.npz")
    proc = build_nonisotropic_process(g["Sigma_N"], g["Lambda_N"], g["U"], timesteps=STEPS,
                                      objective="pred_noise", device="cpu")
    x0, xt, noise = (t_(g[k]) for k in ("x0", "xt", "noise"))
    t = t_(g["t"]).long()
    close(proc.predict_noise_from_start(xt, t, x0), g["pred_noise"], 1e-3, "pred_noise")
    mean, _, logvar = proc.q_posterior(x0, xt, t)
    close(proc.combine_mean_var_noise(mean, logvar, noise), g["combined"], 1e-4, "combined")
    assert torch.equal(proc.loss_weight, torch.ones(STEPS))
    eps = proc.predict_noise_from_start(xt, t, x0)
    close(proc.predict_start_from_noise(xt, t, eps), x0, 1e-3, "x0 from its noise")


def inputs(n=21, d=12, b=5, seed=0):
    rng = np.random.default_rng(seed)
    x0, xt, noise = (rng.standard_normal((b, n, d), dtype=np.float32) for _ in range(3))
    return x0, xt, noise, rng.integers(0, 4, b)


@pytest.mark.parametrize("objective", ["pred_noise", "pred_x0", "pred_v"])
@pytest.mark.parametrize("schedule,steps", SCHEDULES, ids=[s for s, _ in SCHEDULES])
def test_isotropic_process_meets_jax(objective, schedule, steps):
    """Every table and method against the JAX ``IsotropicProcess``, per-item
    and shared t, both loss types."""
    for loss_type in ("mse", "l1"):
        kw = dict(timesteps=steps, objective=objective, beta_schedule=schedule,
                  loss_type=loss_type)
        proc, jproc = build_isotropic_process(21, device="cpu", **kw), jax_build_isotropic(**kw)
        for name in ISO_TABLES:
            close(getattr(proc, name), getattr(jproc, name), 1e-7, name)
        x0, xt, noise, t = inputs()
        for tt in (t_(t), 3):
            jt = jnp.asarray(tt.numpy() if isinstance(tt, torch.Tensor) else tt)
            for method, args in (("q_sample", (x0, noise)),
                                 ("predict_start_from_noise", (xt, noise)),
                                 ("predict_noise_from_start", (xt, x0)),
                                 ("predict_v", (x0, noise)), ("predict_start_from_v", (xt, noise))):
                a, b = args
                close(getattr(proc, method)(t_(a), tt, t_(b)),
                      getattr(jproc, method)(jnp.asarray(a), jt, jnp.asarray(b)), 1e-5, method)
            for got, want in zip(proc.q_posterior(t_(x0), t_(xt), tt),
                                 jproc.q_posterior(jnp.asarray(x0), jnp.asarray(xt), jt)):
                close(np.broadcast_to(got, x0.shape), np.broadcast_to(want, x0.shape), 1e-5)
            close(proc.loss_terms(t_(x0), t_(xt), tt),
                  jproc.loss_terms(jnp.asarray(x0), jnp.asarray(xt), jt), 1e-6, loss_type)


@pytest.mark.parametrize("objective", ["pred_noise", "pred_x0"])
@pytest.mark.parametrize("schedule,steps", SCHEDULES, ids=[s for s, _ in SCHEDULES])
def test_nonisotropic_process_meets_jax(objective, schedule, steps):
    """The nonisotropic tables, step tables and methods against the JAX
    builder on the AMASS adjacency, per-item t."""
    jsk, sk = skeletons()
    cov = get_cov_from_corr(sk.adj_matrix)
    for got, want in zip(cov, jax_get_cov_from_corr(jsk.adj_matrix)):
        close(got, want, 1e-6, "covariance")
    kw = dict(timesteps=steps, objective=objective, beta_schedule=schedule)
    proc = build_nonisotropic_process(*cov, device="cpu", **kw)
    jproc = jax_build_nonisotropic(*cov, **kw)
    for name in ("loss_weight", "posterior_mean_coef1_x0", "posterior_mean_coef2_xt",
                 "Umm_sqrt_Lambda_bar_t_sqrt_recip_alphas_cumprod", "mahalanobis_S_sqrt_recip"):
        close(getattr(proc, name), getattr(jproc, name), 1e-6, name)
    close(proc.posterior_step_tables(), jproc.posterior_step_tables(), 1e-6, "step tables")
    x0, xt, noise, t = inputs()
    jt = jnp.asarray(t)
    close(proc.predict_start_from_noise(t_(xt), t_(t), t_(noise)),
          jproc.predict_start_from_noise(jnp.asarray(xt), jt, jnp.asarray(noise)), 1e-4)
    close(proc.predict_noise_from_start(t_(xt), t_(t), t_(x0)),
          jproc.predict_noise_from_start(jnp.asarray(xt), jt, jnp.asarray(x0)), 1e-4)
    close(proc.loss_terms(t_(x0), t_(xt), t_(t)),
          jproc.loss_terms(jnp.asarray(x0), jnp.asarray(xt), jt), 1e-5)


def test_nonisotropic_pred_v_refused_as_in_jax():
    cov = get_cov_from_corr(skeletons()[1].adj_matrix)
    with pytest.raises(NotImplementedError):
        build_nonisotropic_process(*cov, objective="pred_v", device="cpu")
    with pytest.raises(NotImplementedError):
        jax_build_nonisotropic(*cov, objective="pred_v")
    with pytest.raises(ValueError):
        build_isotropic_process(21, objective="pred_eps", device="cpu")


def test_run_as_isotropic_equals_the_isotropic_process():
    """`tests/test_isotropic_equivalence.py:16` on the port: Λ_N = 1, U = I
    degenerate the skeleton-diffusion schedule to DDPM's."""
    N, D, B = 7, 12, 5
    cov = get_cov_from_corr(np.zeros((N, N)), if_run_as_isotropic=True,
                            diffusion_covariance_type="skeleton-diffusion")
    noniso = build_nonisotropic_process(*cov, timesteps=STEPS, device="cpu")
    iso = build_isotropic_process(N, timesteps=STEPS, device="cpu")
    rng = np.random.default_rng(0)
    x0, xt, noise = (t_(rng.standard_normal((B, N, D)).astype(np.float32)) for _ in range(3))
    t = t_(rng.integers(0, STEPS, B))
    close(noniso.q_sample(x0, t, noise), iso.q_sample(x0, t, noise), 1e-5)
    m1, _, lv1 = noniso.q_posterior(x0, xt, t)
    m2, _, lv2 = iso.q_posterior(x0, xt, t)
    close(m1, m2, 1e-5)
    close(lv1.expand_as(m1), lv2.expand_as(m2), 1e-4)
    close(noniso.predict_noise_from_start(xt, t, x0), iso.predict_noise_from_start(xt, t, x0),
          2e-4)
    close(noniso.combine_mean_var_noise(m1, lv1, noise), iso.combine_mean_var_noise(m2, lv2, noise),
          1e-5)
    close(noniso.posterior_step_tables(), iso.posterior_step_tables(), 1e-5, "step tables")


@pytest.mark.parametrize("process", ["isotropic", "nonisotropic"])
def test_step_tables_are_the_q_posterior_step(process):
    """The posterior-step kernel's plain version on the engine's tables
    equals clip → q_posterior → combine_mean_var_noise at every t (no noise
    at t = 0), node-major."""
    _, sk = skeletons()
    if process == "isotropic":
        proc = build_isotropic_process(sk.num_nodes, timesteps=STEPS, device="cpu")
        assert isinstance(proc, IsotropicProcess)
    else:
        proc = build_nonisotropic_process(*get_cov_from_corr(sk.adj_matrix), timesteps=STEPS,
                                          device="cpu")
    tables = proc.posterior_step_tables()
    assert tables.shape == (STEPS, 21, 63)
    x0, xt, noise, _ = inputs()
    x0 = 1.5 * x0  # some |x̂₀| > 1: the clip matters
    nm = [t_(a).transpose(0, 1).contiguous() for a in (x0, xt, noise)]
    for t in range(STEPS):
        close(posterior_step_plain(*nm, tables[t]), posterior_update_plain(proc, *nm, t), 2e-6,
              f"t={t}")


# ---- the variant modules ------------------------------------------------------------

L, T, N = 12, 4, 21
ARCH = {"depth": 1, "attn_heads": 2, "attn_dim_head": 4, "use_attention": True,
        "learn_influence": True, "self_condition": False, "norm_type": "none"}
ISO, NONISO = "IsotropicGaussianDiffusion", "NonisotropicGaussianDiffusion"
MODULE_TOL, E2E_TOL = 1e-5, 1e-4


def diffusion_pair(diffusion_type=NONISO, objective="pred_x0", arch=ARCH, seed=0, **kw):
    """(JAX engine, JAX denoiser, params as jax arrays, port engine, port
    denoiser) with the same weights: influences moved off their init and the
    weights spread, so that x̂₀ is O(1) and the clip acts."""
    jsk, sk = skeletons()
    common = dict(diffusion_type=diffusion_type, latent_size=L, diffusion_timesteps=T,
                  diffusion_objective=objective, diffusion_arch=dict(arch),
                  diffusion_conditioning=kw.pop("diffusion_conditioning", True), **kw)
    jengine, jden = jax_create_diffusion(jsk, **common)
    cond = jnp.zeros((1, N, L)) if common["diffusion_conditioning"] else None
    params = jden.init(jax.random.key(seed), jnp.zeros((1, N, L)), jnp.zeros((1,), jnp.int32),
                       cond)
    rng = np.random.default_rng(seed)
    params = spread_weights(perturb_influence(jax.device_get(params), rng), rng)
    engine, den = create_diffusion(sk, torch.Generator().manual_seed(0), device="cpu", **common)
    load_denoiser_params(den, params)
    return jengine, jden, as_jax(params), engine, den


def noise(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape, dtype=np.float32)


def assert_close(got, want, tol, what=""):
    """|Δ| ≤ tol·max(1, max|want|)."""
    got, want = np.asarray(got, dtype=np.float64), np.asarray(want, dtype=np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert np.isfinite(got).all(), what
    err, scale = np.abs(got - want).max(), max(1.0, np.abs(want).max())
    assert err <= tol * scale, (what, err, scale)



def reference_names(tree, depth: int, use_attention: bool) -> dict:
    """A flax denoiser tree → the reference's ``state_dict`` names and layouts
    (the inverse of ``utils/torch_port.port_denoiser``)."""
    sd = {}

    def glin(prefix, p):
        sd[f"{prefix}.weight"] = np.swapaxes(p["weight"], -1, -2)
        for extra in ("bias", "G"):
            if extra in p:
                sd[f"{prefix}.{extra}"] = p[extra]

    def dense(prefix, p):
        sd[f"{prefix}.weight"], sd[f"{prefix}.bias"] = p["kernel"].T, p["bias"]

    p = tree["params"]
    glin("init_lin", p["init_lin"])
    dense("time_mlp.1", p["time_mlp0"])
    dense("time_mlp.3", p["time_mlp1"])
    for i in range(2 * depth):
        res = p[f"res{i}"]
        dense(f"layers.{i}.0.mlp.1", res["mlp"])
        for part in ("block1", "block2"):
            glin(f"layers.{i}.0.{part}.proj", res[part]["proj"])
        if "res_linear" in res:
            glin(f"layers.{i}.0.res_linear", res["res_linear"])
        if i == 2 * depth - 1:
            continue
        if use_attention:
            sd[f"layers.{i}.1.fn.norm.g"] = p[f"attn{i}"]["norm"]["g"]
            for part in ("to_qkv", "to_out"):
                glin(f"layers.{i}.1.fn.fn.{part}", p[f"attn{i}"]["attn"][part])
        else:
            sd[f"layers.{i}.1.fn.norm.g"] = p[f"attn{i}_norm"]["g"]
            glin(f"layers.{i}.1.fn.fn", p[f"attn{i}_lin"])
    fb = p["final_res_block"]
    dense("final_res_block.mlp.1", fb["mlp"])
    for part in ("block1", "block2"):
        glin(f"final_res_block.{part}.proj", fb[part]["proj"])
    glin("final_res_block.res_linear", fb["res_linear"])
    glin("final_glin", p["final_glin"])
    return {k: np.asarray(v) for k, v in sd.items()}


VARIANTS = {
    "unconditioned": dict(diffusion_conditioning=False),
    "self_conditioned": dict(arch={**ARCH, "self_condition": True}),
    "self_conditioned_unconditioned": dict(arch={**ARCH, "self_condition": True},
                                           diffusion_conditioning=False),
    "attention_free": dict(arch={**ARCH, "use_attention": False, "depth": 2}),
}


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_denoiser_variant_meets_flax_through_both_bridges(variant):
    kw = dict(VARIANTS[variant])
    arch = kw.pop("arch", ARCH)
    _, jden, params, _, den = diffusion_pair(arch=arch, **kw)
    rows = 5
    x, x_cond = noise((rows, N, L), 15), noise((rows, N, L), 16)
    t = np.array([0, 1, 2, 3, 1])
    cond = jnp.asarray(x_cond) if den.cond_dim else None
    want = np.asarray(jden.apply(params, jnp.asarray(x), jnp.asarray(t), cond))
    sd = reference_names(jax.device_get(params), arch["depth"], arch["use_attention"])
    assert {k: np.asarray(v).shape for k, v in flatten_params(jax_port_denoiser(
        sd, depth=arch["depth"], use_attention=arch["use_attention"])).items()} == {
        k: tuple(v.shape) for k, v in den.state_dict().items()}
    via_reference = create_diffusion(skeletons()[1], torch.Generator().manual_seed(5), device="cpu",
                                     latent_size=L, diffusion_timesteps=T, diffusion_arch=arch,
                                     **kw)[1]
    load_reference_denoiser(via_reference, sd)
    for which, module in (("flax tree", den), ("reference state_dict", via_reference)):
        with torch.no_grad():
            u = module.cond_embedding(torch.from_numpy(x_cond)) if module.cond_dim else None
            got = module(torch.from_numpy(x).transpose(0, 1), torch.from_numpy(t), u)
        assert_close(got.transpose(0, 1), want, MODULE_TOL, f"{variant} via the {which}")


def test_bf16_plain_decode_within_the_spread():
    """The plain decode in bf16 (the Decoder's ``compute_dtype``) against the
    jitted flax bf16 decode of the same weights: its deviation from the flax
    bf16 decode and from the flax fp32 one within ``BF16_SPREAD`` × the flax
    bf16-vs-fp32 deviation (max and mean); in fp32 it meets the flax decode
    at 1e-5 and is the rollout kernel's plain version."""
    jsk, sk = skeletons()
    rows, hidden = 6, 16
    x, z = 0.3 * noise((rows, OBS_LEN, N, 3), 17), np.tanh(noise((rows, N, hidden), 18))
    _, ae_params, _, _, den_params = jax_models(jsk, seed=4)
    outs = {}
    for dtype in (None, "bfloat16"):
        jae = JaxAutoEncoder(num_nodes=N, encoder_hidden_size=hidden, decoder_hidden_size=hidden,
                             latent_size=hidden, node_types=jsk.nodes_type_id,
                             compute_dtype=dtype)
        decode = jax.jit(lambda p, x, z: jae.apply(p, x, z, None, ph=PRED_LEN,
                                                   method=JaxAutoEncoder.decode))
        ae, _, _ = port_models(sk, ae_params, den_params, compute_dtype=dtype)
        with torch.no_grad():
            outs[dtype] = (np.asarray(decode(as_jax(ae_params), jnp.asarray(x), jnp.asarray(z))),
                           ae.decode_plain(torch.from_numpy(x), torch.from_numpy(z), PRED_LEN)
                           .numpy(),
                           ae.decode(torch.from_numpy(x), torch.from_numpy(z), PRED_LEN).numpy())
    (j32, p32, k32), (j16, p16, _) = outs[None], outs["bfloat16"]
    assert_close(p32, j32, 1e-5, "fp32 plain decode")
    np.testing.assert_array_equal(p32, k32)  # the rollout kernel's plain version on the CPU
    jax_err = np.abs(j16 - j32)
    assert jax_err.max() > 0
    for against, ref in (("flax bf16", j16), ("flax fp32", j32)):
        d = np.abs(p16 - ref)
        assert d.max() <= BF16_SPREAD * jax_err.max(), (against, d.max(), jax_err.max())
        assert d.mean() <= BF16_SPREAD * jax_err.mean(), (against, d.mean(), jax_err.mean())
