"""The training slice of the port against the JAX trainers and the
reference's own training objectives (``goldens/train_objective.npz``, made by
``tests/make_train_golden.py``).

At the golden's size (obs 6, pred 12, latent and hidden 16, denoiser depth
2 × 2 heads × 8, 10 diffusion steps, batch 4, k 3) and with the weights of
its reference ``state_dict``s (carried into flax trees by
``skeletondiffusion_tpu/utils/torch_port.py`` and into the port by its
``weights.py``, in this test only), at the tolerances of
``tests/test_train_objective_parity.py``:

* stage 1: the curriculum's rollout prefix and loss at ph 1, 6 and 12
  (atol 2e-6, loss rtol 1e-5) and the three-step AdamW/AMSGrad trajectory;
* stage 2: the frozen-AE embeddings (atol 2e-6), ``p_losses`` (rtol 2e-4,
  atol 1e-6), the k-best loss in all three similarity spaces with equal
  argmins (rtol 2e-5), and the three-step Adam trajectory (loss rtol 5e-4,
  grad norm rtol 1e-3, parameters atol 3·lr);
* the port's trainers against the JAX trainers on injected inputs: fp32
  steps of both stages at the same bounds, and one bf16 stage-2 step within
  ``BF16_SPREAD`` × the JAX trainer's own bf16-vs-fp32 deviation (its
  per-entry means against the JAX bf16 step taken op by op);
* EMA (≤ 1e-6 over a schedule that crosses ``update_after_step``), the LR
  scheduler and ``CurriculumPH`` against the JAX ones, sequence for
  sequence;
* the two traps of the JAX package's training port (the subgradient of |G|
  at the identity-init influence, AMSGrad's max of the raw second moment),
  and the rollout kernel's refusal to build a graph it cannot give.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import BF16_SPREAD

from skeletondiffusion_tpu_torch.diffusion.engine import GaussianDiffusion
from skeletondiffusion_tpu_torch.diffusion.manager import create_diffusion
from skeletondiffusion_tpu_torch.diffusion.process import build_nonisotropic_process
from skeletondiffusion_tpu_torch.models import AutoEncoder
from skeletondiffusion_tpu_torch.ops.graph_linear import l1_normalize_rows
from skeletondiffusion_tpu_torch.ops.kernels import gru_rollout as rollout_mod
from skeletondiffusion_tpu_torch.skeleton import create_skeleton
from skeletondiffusion_tpu_torch.train import ema as ema_mod
from skeletondiffusion_tpu_torch.train import schedulers
from skeletondiffusion_tpu_torch.train.trainer_autoencoder import AutoEncoderTrainer
from skeletondiffusion_tpu_torch.train.trainer_diffusion import TrainerDiffusion
from skeletondiffusion_tpu_torch.weights import flatten_params, load_autoencoder_params
from skeletondiffusion_tpu_torch.weights import load_denoiser_params

GOLD = os.path.join(os.path.dirname(__file__), "goldens", "train_objective.npz")
ARCH = {"use_attention": True, "self_condition": False, "norm_type": "none", "depth": 2,
        "attn_dim_head": 8, "attn_heads": 2, "learn_influence": True}
SPACES = ["latent_space", "input_space", "metric_space"]


@pytest.fixture(scope="module")
def golden():
    return np.load(GOLD, allow_pickle=False)


@pytest.fixture(scope="module")
def cfg(golden):
    return json.loads(str(golden["config_json"]))


def skeleton_kw(cfg):
    return dict(dataset_name="amass", motion_repr_type="SkeletonRescalePose",
                num_joints=cfg["num_joints"], pose_box_size=cfg["pose_box"],
                obs_length=cfg["obs"], pred_length=cfg["pred"], if_consider_hip=False)


@pytest.fixture(scope="module")
def flax_trees(golden):
    """The golden's reference state_dicts as flax trees (before and after
    the recorded optimizer steps)."""
    from skeletondiffusion_tpu.utils.torch_port import port_autoencoder, port_denoiser

    def sd(prefix):
        return {k[len(prefix):]: golden[k] for k in golden.files if k.startswith(prefix)}

    return {"ae": {"params": port_autoencoder(sd("ae."))},
            "den": {"params": port_denoiser(sd("den."), depth=2)},
            "ae_after": {"params": port_autoencoder(sd("ae_after."))},
            "den_after": {"params": port_denoiser(sd("den_after."), depth=2)}}


def port_pair(golden, cfg, flax_trees, compute_dtype=None):
    """(skeleton, AutoEncoder, engine) of the port with the golden's weights
    (a new pair at each call: training moves them) and the reference's
    eigensystem (the injected noise is expressed in U's
    basis, which is unique only up to column signs)."""
    sk = create_skeleton(**skeleton_kw(cfg))
    gen = torch.Generator().manual_seed(0)
    ae = AutoEncoder(sk.num_nodes, cfg["hidden"], cfg["hidden"], cfg["latent"], gen,
                     node_types=sk.nodes_type_id)
    load_autoencoder_params(ae, flax_trees["ae"])
    _, den = create_diffusion(sk, gen, latent_size=cfg["latent"],
                              diffusion_timesteps=cfg["t_diff"], diffusion_arch=dict(ARCH),
                              device="cpu", compute_dtype=compute_dtype)
    load_denoiser_params(den, flax_trees["den"])
    process = build_nonisotropic_process(golden["cov_Sigma_N"], golden["cov_Lambda_N"],
                                         golden["cov_U"], timesteps=cfg["t_diff"], device="cpu")
    engine = GaussianDiffusion(process, den, channels=sk.num_nodes, latent_size=cfg["latent"])
    return sk, ae, engine


@pytest.fixture(scope="module")
def port(golden, cfg, flax_trees):
    return port_pair(golden, cfg, flax_trees)


@pytest.fixture(scope="module")
def inputs(golden):
    return torch.from_numpy(golden["x"]), torch.from_numpy(golden["y"])


def diffusion_trainer(port, cfg, **kw):
    sk, ae, engine = port
    return TrainerDiffusion(engine, ae, skeleton=sk, if_use_ema=False,
                            prediction_horizon_eval=cfg["pred"], **kw)


def assert_params(module, tree, atol, what):
    want = flatten_params(tree)
    got = module.state_dict()
    assert want.keys() == got.keys()
    for name in want:
        np.testing.assert_allclose(got[name].numpy(), want[name].numpy(), atol=atol, rtol=0,
                                   err_msg=f"{what}: {name}")


# ---- stage 1 -----------------------------------------------------------------------


@pytest.mark.parametrize("ph", [1, 6, 12])
def test_stage1_curriculum_rollout_and_loss_match_reference(golden, cfg, port, inputs, ph):
    """The encoder up to frame ph − 1 and the ph-step decode, differentiable
    and on the rollout wrapper, equal the reference's ``autoencode(y[:, :ph],
    ph=ph)``; the trainer's loss equals its ``ae.loss``."""
    _, ae, _ = port
    x, y = inputs
    tr = AutoEncoderTrainer(ae, lr=5e-3, iter_per_epoch=1, prediction_horizon_train=cfg["pred"],
                            prediction_horizon_eval=cfg["pred"])
    z = ae.encode(y, last_index=ph - 1)
    pred = ae.decode_plain(x, z, ph)
    np.testing.assert_allclose(pred.detach().numpy(), golden[f"ae_pred_ph{ph}"], atol=2e-6,
                               err_msg=f"ph={ph} rollout")
    with torch.no_grad():
        np.testing.assert_allclose(ae.decode(x, z, ph).numpy(), golden[f"ae_pred_ph{ph}"],
                                   atol=2e-6, err_msg=f"ph={ph} decode")
        # the encode of the truncated future is the encode up to ph − 1
        np.testing.assert_array_equal(ae.encode(y[:, :ph]).numpy(), z.detach().numpy())
    np.testing.assert_allclose(float(tr.loss(x, y, ph).detach()), float(golden[f"ae_loss_ph{ph}"]),
                               rtol=1e-5, err_msg=f"ph={ph} loss")


def test_stage1_optimizer_trajectory_matches_reference(golden, cfg, flax_trees, inputs):
    """Three reference stage-1 steps (sliced autoencode → L1 → clip → AdamW
    with AMSGrad): losses, pre-clip gradient norms and the parameters after."""
    _, ae, _ = port_pair(golden, cfg, flax_trees)
    lr, ph = 5e-3, int(golden["ae_opt_ph"])
    tr = AutoEncoderTrainer(ae, lr=lr, iter_per_epoch=1, prediction_horizon_train=cfg["pred"],
                            prediction_horizon_eval=cfg["pred"],
                            clip_grad_norm=float(golden["opt_clip1"]))
    x, y = inputs
    for s in range(golden["ae_opt_step_losses"].shape[0]):
        loss = tr.loss(x, y, ph)
        gnorm = tr.optimizer_step(loss)
        np.testing.assert_allclose(float(loss.detach()), golden["ae_opt_step_losses"][s], rtol=5e-4,
                                   err_msg=f"step {s} loss")
        np.testing.assert_allclose(float(gnorm), golden["ae_opt_step_gnorms"][s], rtol=1e-3,
                                   err_msg=f"step {s} grad norm")
    assert_params(ae, flax_trees["ae_after"], 3 * lr, "AE after 3 steps")


def test_stage1_train_step_reaches_every_decoder_parameter(golden, cfg, flax_trees, inputs):
    """A training step's decode is differentiable: every parameter of the
    AutoEncoder, the decoder's included, gets a nonzero gradient (at the
    identity-init influence too), and the step moves them."""
    _, ae, _ = port_pair(golden, cfg, flax_trees)
    tr = AutoEncoderTrainer(ae, lr=5e-3, iter_per_epoch=1, prediction_horizon_train=cfg["pred"],
                            prediction_horizon_eval=cfg["pred"], curriculum_it=0,
                            random_prediction_horizon=False)
    before = {k: v.clone() for k, v in ae.state_dict().items()}
    loss, ph = tr.train_step(inputs, epoch=1, iteration=0)
    assert ph == cfg["pred"] and loss.requires_grad is False
    for name, p in ae.named_parameters():
        assert p.grad is not None and float(p.grad.abs().sum()) > 0, name
        assert not torch.equal(p.detach(), before[name]), name
    assert float(tr.last_grad_norm) > 0


def test_gru_rollout_refuses_a_graph_it_cannot_give(port, inputs):
    """The rollout kernel's wrapper has no backward: with gradients enabled
    and an input that requires them it raises, on the CPU as on the card;
    under no_grad, or on inputs that need no gradient, it decodes."""
    _, ae, _ = port
    x, y = inputs
    z = torch.zeros(x.shape[0], x.shape[2], 16)
    with pytest.raises(RuntimeError, match="no backward"):
        ae.decode(x, z, 3)
    with pytest.raises(RuntimeError, match="no backward"):
        ae.autoencode(y, x, ph=3)
    with torch.no_grad():
        args = {k: v.detach() for k, v in rollout_mod.rollout_args(ae.decoder, x[:, -2:],
                                                                   z).items()}
    assert rollout_mod.gru_rollout(**args, ph=3).shape == (3, x.shape[2], x.shape[0], 3)
    with torch.no_grad():
        assert ae.decode(x, z, 3).shape == (x.shape[0], 3, x.shape[2], 3)


def test_stage1_validation_step_matches_jax(golden, cfg, flax_trees, port, inputs):
    """``validation_step``: the autoencode at the eval horizon on the rollout
    wrapper, against the JAX trainer's (prediction and latent, atol 2e-6)."""
    from skeletondiffusion_tpu.train.trainer_autoencoder import AutoEncoderTrainer as JaxTrainer

    _, jae, _ = jax_models(golden, cfg, flax_trees)
    jtr = JaxTrainer(model=jae, lr=5e-3, iter_per_epoch=1,
                     prediction_horizon_train=cfg["pred"], prediction_horizon_eval=cfg["pred"])
    want_pred, want_z = jtr._jit_val(jax.tree.map(jnp.asarray, flax_trees["ae"]),
                                     jnp.asarray(golden["x"]), jnp.asarray(golden["y"]))
    tr = AutoEncoderTrainer(port[1], lr=5e-3, iter_per_epoch=1,
                            prediction_horizon_train=cfg["pred"],
                            prediction_horizon_eval=cfg["pred"])
    pred, y, x, z = tr.validation_step(inputs)
    assert y is inputs[1] and x is inputs[0]
    np.testing.assert_allclose(pred.numpy(), np.asarray(want_pred), rtol=0, atol=2e-6)
    np.testing.assert_allclose(z.numpy(), np.asarray(want_z), rtol=0, atol=2e-6)


# ---- stage 2 -----------------------------------------------------------------------


def test_stage2_embeddings_match_reference(golden, cfg, port, inputs):
    tr = diffusion_trainer(port, cfg)
    z_past, z = tr.embed(*inputs)
    assert not z.requires_grad and not z_past.requires_grad
    np.testing.assert_allclose(z.numpy(), golden["z"], atol=2e-6)
    np.testing.assert_allclose(z_past.numpy(), golden["z_past"], atol=2e-6)


@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("space", SPACES)
def test_stage2_kbest_loss_matches_reference(golden, cfg, port, inputs, k, space):
    """The trainer's loss (embeddings → p_losses → similarity argmin →
    weighted mean) on the golden's t and noise, the per-sample losses and
    weights, and the chosen samples."""
    _, _, engine = port
    tr = diffusion_trainer(port, cfg, train_pick_best_sample_among_k=k, similarity_space=space)
    x, y = inputs
    t = torch.from_numpy(golden["t"])
    noise = torch.from_numpy(golden["noise"] if k == cfg["k"] else golden["noise_k1"])
    z_past, z = tr.embed(x, y)
    with torch.no_grad():
        loss = tr.loss(x, y, z, z_past, t=t, noise=noise)
        lv, dw, _ = engine.p_losses(z, t, z_past, n_train_samples=k, noise=noise)
    np.testing.assert_allclose(float(loss), float(golden[f"train_loss_k{k}_{space}"]),
                               rtol=2e-5, err_msg=f"k={k} space={space}")
    np.testing.assert_allclose(lv.numpy(), golden[f"plosses_vec_k{k}"], rtol=2e-4, atol=1e-6)
    np.testing.assert_allclose(dw.numpy(), golden[f"plosses_weights_k{k}"], rtol=1e-5)
    if k > 1:
        np.testing.assert_array_equal(tr.last_choice["index"].numpy(),
                                      golden[f"argmin_k{k}_{space}"])


def test_stage2_optimizer_trajectory_matches_reference(golden, cfg, flax_trees, inputs):
    """Three reference stage-2 steps (k = 3, input space; backward → clip →
    Adam with coupled L2) on the recorded t and noise."""
    pair = port_pair(golden, cfg, flax_trees)
    lr = 1e-3
    tr = diffusion_trainer(pair, cfg, lr=lr, weight_decay=0.01, adam_betas=(0.9, 0.99),
                           train_pick_best_sample_among_k=cfg["k"],
                           similarity_space="input_space",
                           max_grad_norm=float(golden["opt_clip2"]))
    for s in range(golden["opt_t_steps"].shape[0]):
        loss = tr.train_step(inputs, t=torch.from_numpy(golden["opt_t_steps"][s]),
                             noise=torch.from_numpy(golden["opt_noise_steps"][s]))
        np.testing.assert_allclose(float(loss), golden["opt_step_losses"][s], rtol=5e-4,
                                   err_msg=f"step {s} loss")
        np.testing.assert_allclose(float(tr.last_grad_norm), golden["opt_step_gnorms"][s],
                                   rtol=1e-3, err_msg=f"step {s} grad norm")
    assert_params(tr.denoiser, flax_trees["den_after"], 3 * lr, "denoiser after 3 steps")


def test_validation_step_samples_with_the_ema_weights(golden, cfg, flax_trees, inputs):
    """``validation_step`` on a bf16 denoiser is the prediction path (its
    fused chain, plain on the CPU) on the EMA weights as they are at the
    call: equal to a predictor built from a copy of the EMA module, with
    injected noise, before and after the EMA moves; never the live
    weights."""
    import copy

    from skeletondiffusion_tpu_torch.eval_pipeline import SkeletonDiffusionPredictor

    sk, ae, engine = port_pair(golden, cfg, flax_trees, torch.bfloat16)
    samples = 3
    tr = TrainerDiffusion(engine, ae, skeleton=sk, prediction_horizon_eval=cfg["pred"],
                          num_prob_samples=samples, train_pick_best_sample_among_k=cfg["k"],
                          similarity_space="input_space", ema_update_every=1,
                          step_start_ema=0, ema_decay=0.5, lr=1e-2)
    rng = np.random.default_rng(8)
    rows, n, latent = inputs[0].shape[0] * samples, sk.num_nodes, cfg["latent"]
    noise = dict(start_noise=torch.from_numpy(
                     rng.standard_normal((rows, n, latent), dtype=np.float32)),
                 step_noise=torch.from_numpy(
                     rng.standard_normal((rows, cfg["t_diff"] - 1, n, latent),
                                         dtype=np.float32)))

    def reference(module):
        den = copy.deepcopy(module)
        eng = GaussianDiffusion(engine.process, den, channels=n, latent_size=latent)
        pred = SkeletonDiffusionPredictor(sk, ae, eng, num_samples=samples,
                                          pred_length=cfg["pred"], device="cpu")
        assert pred.diffusion.fused is not None
        return pred(None, inputs[0], **noise)[0]

    outs = []
    gen = torch.Generator().manual_seed(0)
    for steps in (3, 2):  # the EMA copies the live weights up to its second update
        for _ in range(steps):
            tr.train_step(inputs, gen)
        out = tr.validation_step(inputs, **noise)[0]
        assert out.shape == (inputs[0].shape[0], samples, cfg["pred"], n, 3)
        assert torch.equal(out, reference(tr.ema.module))
        assert not torch.equal(out, reference(tr.denoiser))
        outs.append(out)
    assert not torch.equal(outs[0], outs[1])


# ---- against the JAX trainers ---------------------------------------------------------


def jax_models(golden, cfg, flax_trees, compute_dtype=None):
    """The JAX AutoEncoder and engine of the golden (the AutoEncoder fp32;
    the denoiser in ``compute_dtype``), as tests/test_train_objective_parity.py
    builds them."""
    from skeletondiffusion_tpu.diffusion.manager import create_diffusion as jax_create_diffusion
    from skeletondiffusion_tpu.diffusion.process import (
        build_nonisotropic_process as jax_build_process,
    )
    from skeletondiffusion_tpu.models import AutoEncoder as JaxAutoEncoder
    from skeletondiffusion_tpu.skeleton import create_skeleton as jax_create_skeleton

    jsk = jax_create_skeleton(**skeleton_kw(cfg))
    ae = JaxAutoEncoder(num_nodes=jsk.num_nodes, encoder_hidden_size=cfg["hidden"],
                        decoder_hidden_size=cfg["hidden"], latent_size=cfg["latent"],
                        node_types=jsk.nodes_type_id)
    diffusion, _ = jax_create_diffusion(
        jsk, diffusion_type="NonisotropicGaussianDiffusion", covariance_matrix_type="adjacency",
        latent_size=cfg["latent"], diffusion_conditioning=True,
        diffusion_timesteps=cfg["t_diff"], diffusion_arch=dict(ARCH),
        compute_dtype=compute_dtype)
    diffusion.process = jax_build_process(
        golden["cov_Sigma_N"], golden["cov_Lambda_N"], golden["cov_U"],
        timesteps=cfg["t_diff"], objective="pred_x0", beta_schedule="cosine",
        diffusion_covariance_type="skeleton-diffusion", gamma_scheduler="cosine",
        loss_reduction_type="l1")
    return jsk, ae, diffusion


def jax_stage2_steps(golden, cfg, flax_trees, ts, noises, lr, compute_dtype=None,
                     jit=True):
    """The JAX trainer's stage-2 steps (k = 3, input space) on injected t and
    noise: (losses, grad norms, gradients of the first step, params after),
    the gradients under ``jax.jit`` (a bf16 denoiser's rounding points are
    then those of the port's plain bf16 modules) or, with ``jit=False``, op
    by op.  The jitted fp32 step on the CPU lands ~1e-4 (relative) from a
    float64 evaluation of the same loss; the eager one and the port's fp32
    step agree with it to ~1e-10 (the order of the jitted sums flips the
    sign of L1 terms near 0)."""
    import optax

    from skeletondiffusion_tpu.train.trainer_diffusion import TrainerDiffusion as JaxTrainer

    jsk, ae, diffusion = jax_models(golden, cfg, flax_trees, compute_dtype)
    tr = JaxTrainer(diffusion, ae, flax_trees["ae"], train_pick_best_sample_among_k=cfg["k"],
                    similarity_space="input_space", skeleton=jsk, if_use_ema=False,
                    prediction_horizon_eval=cfg["pred"], lr=lr, weight_decay=0.01)
    x, y = jnp.asarray(golden["x"]), jnp.asarray(golden["y"])
    z_past, z = tr._embed(x, y)
    params = jax.tree.map(jnp.asarray, flax_trees["den"])
    opt_state = tr.tx.init(params)

    def grad_step(p, t, noise):
        return jax.value_and_grad(
            lambda p: tr.loss(p, jax.random.key(0), x, y, z, z_past, t=t, noise=noise))(p)

    if jit:
        grad_step = jax.jit(grad_step)

    losses, gnorms, grads0 = [], [], None
    for t, noise in zip(ts, noises):
        loss, grads = grad_step(params, jnp.asarray(t), jnp.asarray(noise))
        losses.append(float(loss))
        gnorms.append(float(optax.global_norm(grads)))
        if grads0 is None:
            grads0 = flatten_params(jax.device_get(grads))
        updates, opt_state = tr.tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, jax.tree.map(lambda u: -lr * u, updates))
    return losses, gnorms, grads0, jax.device_get(params)


def port_stage2_steps(golden, cfg, flax_trees, ts, noises, lr, compute_dtype=None):
    pair = port_pair(golden, cfg, flax_trees, compute_dtype)
    tr = diffusion_trainer(pair, cfg, lr=lr, weight_decay=0.01,
                           train_pick_best_sample_among_k=cfg["k"],
                           similarity_space="input_space")
    x, y = torch.from_numpy(golden["x"]), torch.from_numpy(golden["y"])
    losses, gnorms, grads0 = [], [], None
    for t, noise in zip(ts, noises):
        z_past, z = tr.embed(x, y)
        loss = tr.loss(x, y, z, z_past, t=torch.from_numpy(t), noise=torch.from_numpy(noise))
        gnorm = tr.optimizer_step(loss)
        losses.append(float(loss.detach()))
        gnorms.append(float(gnorm))
        if grads0 is None:
            # the clipped gradients scaled back (clip_grad_norm_ divides by
            # norm + 1e-6; the JAX grads are taken before clipping)
            scale = max(1.0, float(gnorm) / tr.max_grad_norm)
            grads0 = {k: p.grad.detach().clone() * scale
                      for k, p in tr.denoiser.named_parameters()}
    return losses, gnorms, grads0, tr.denoiser


def test_stage2_steps_match_the_jax_trainer(golden, cfg, flax_trees):
    """Two fp32 stage-2 steps of the port's trainer against the JAX
    trainer's, both on the golden's injected t and noise: per-step losses,
    gradient norms and the parameters after."""
    lr = 1e-3
    ts, noises = golden["opt_t_steps"][:2], golden["opt_noise_steps"][:2]
    jl, jg, _, jparams = jax_stage2_steps(golden, cfg, flax_trees, ts, noises, lr)
    pl, pg, _, den = port_stage2_steps(golden, cfg, flax_trees, ts, noises, lr)
    np.testing.assert_allclose(pl, jl, rtol=5e-4)
    np.testing.assert_allclose(pg, jg, rtol=1e-3)
    assert_params(den, jparams, 3 * lr, "denoiser after 2 steps")


def test_stage1_steps_match_the_jax_trainer(golden, cfg, flax_trees, inputs):
    """Three fp32 stage-1 steps of the port's trainer (truncated encode and
    decode) against the JAX trainer's jitted step (full-horizon decode, the
    loss masked to ph), at ph 4, 12 and 7."""
    from skeletondiffusion_tpu.train.trainer_autoencoder import AutoEncoderTrainer as JaxTrainer

    lr, phs = 5e-3, [4, cfg["pred"], 7]
    _, jae, _ = jax_models(golden, cfg, flax_trees)
    jtr = JaxTrainer(model=jae, lr=lr, iter_per_epoch=1, prediction_horizon_train=cfg["pred"],
                     prediction_horizon_eval=cfg["pred"])
    x, y = jnp.asarray(golden["x"]), jnp.asarray(golden["y"])
    state = jtr.init(jax.random.key(0), x, y)
    state = state._replace(params=jax.tree.map(jnp.asarray, flax_trees["ae"]),
                           opt_state=jtr.tx.init(jax.tree.map(jnp.asarray, flax_trees["ae"])))
    _, ae, _ = port_pair(golden, cfg, flax_trees)
    tr = AutoEncoderTrainer(ae, lr=lr, iter_per_epoch=1, prediction_horizon_train=cfg["pred"],
                            prediction_horizon_eval=cfg["pred"])
    for ph in phs:
        state, jloss, jgnorm = jtr._jit_step(state, jax.random.key(0), x, y,
                                             jnp.asarray(ph, jnp.int32),
                                             jnp.asarray(lr, jnp.float32))
        loss = tr.loss(*inputs, ph)
        gnorm = tr.optimizer_step(loss)
        np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=5e-4,
                                   err_msg=f"ph {ph}")
        np.testing.assert_allclose(float(gnorm), float(jgnorm), rtol=1e-3, err_msg=f"ph {ph}")
    assert_params(ae, jax.device_get(state.params), 3 * lr, "AE after 3 steps")


def test_bf16_stage2_step_within_the_jax_trainers_spread(golden, cfg, flax_trees):
    """One bf16 stage-2 step (the denoiser in bf16, its parameters and Adam
    state fp32) against the JAX trainer's bf16 step and its fp32 step (op by
    op: the exact fp32 step), with ``hold_bf16_predictor``'s criteria — the
    port's max and mean deviation from the fp32 step within ``BF16_SPREAD``
    × the JAX bf16 step's own, and its mean deviation from the JAX bf16 step
    within ``BF16_SPREAD`` × that mean — for the loss, the gradient norm,
    the gradients and the parameters after the step (flattened over all
    entries).  The scalars and the maxima are held against the jitted JAX
    bf16 step (the one the JAX trainer runs); the per-entry means against
    the JAX bf16 step op by op: the port's autograd rounds each op of the
    bf16 backward as eager JAX does, where XLA's fusions keep float32 between
    ops (the jitted step's per-entry means are half the port's and the
    eager step's, which agree with each other to 1/20 of either's deviation
    from fp32)."""
    lr = 1e-3
    ts, noises = golden["opt_t_steps"][:1], golden["opt_noise_steps"][:1]
    fp32 = jax_stage2_steps(golden, cfg, flax_trees, ts, noises, lr, jit=False)
    jax_bf16 = {jit: jax_stage2_steps(golden, cfg, flax_trees, ts, noises, lr, "bfloat16",
                                      jit=jit)
                for jit in (True, False)}
    port = port_stage2_steps(golden, cfg, flax_trees, ts, noises, lr, torch.bfloat16)

    def flat(tree):
        return torch.cat([tree[k].reshape(-1) for k in sorted(tree)]).double().numpy()

    def values(step):
        loss, gnorm, grads, params = step
        if isinstance(params, torch.nn.Module):
            params = params.state_dict()
        else:
            params = flatten_params(params)
        return {"loss": np.array(loss), "grad norm": np.array(gnorm), "grads": flat(grads),
                "params": flat(params)}

    mine, want32 = values(port), values(fp32)
    refs = {jit: values(step) for jit, step in jax_bf16.items()}
    every = ("vs_fp32_max", "vs_fp32_mean", "vs_jax_bf16_mean")
    held = [("loss", True, every), ("grad norm", True, every), ("grads", True, every[:1]),
            ("params", True, every[:1]), ("grads", False, every), ("params", False, every)]
    for what, jit, keys in held:
        ref = refs[jit][what]
        jax_err, port_err = np.abs(ref - want32[what]), np.abs(mine[what] - want32[what])
        ratios = dict(vs_fp32_max=port_err.max() / jax_err.max(),
                      vs_fp32_mean=port_err.mean() / jax_err.mean(),
                      vs_jax_bf16_mean=np.abs(mine[what] - ref).mean() / jax_err.mean())
        print(f"bf16 stage-2 step, {what}, against the JAX bf16 step "
              f"{'jitted' if jit else 'op by op'}: JAX bf16 vs fp32 max {jax_err.max():.3e} "
              f"mean {jax_err.mean():.3e}; ratios "
              + ", ".join(f"{k} {v:.3f}" for k, v in ratios.items()))
        assert all(ratios[k] <= BF16_SPREAD for k in keys), (what, jit, ratios)


@pytest.mark.parametrize("loss_type", ["l1", "mse"])
def test_process_training_half_matches_jax(golden, cfg, loss_type):
    """``q_sample``, ``predict_start_from_noise``, ``predict_noise_from_start``
    and ``loss_terms`` of the port's process against the JAX process's on
    the same eigensystem, at per-item timesteps and at one shared by the
    batch (≤ 1e-6 relative to the values' scale)."""
    from skeletondiffusion_tpu.diffusion.process import (
        build_nonisotropic_process as jax_build_process,
    )

    kw = dict(timesteps=cfg["t_diff"], objective="pred_x0", beta_schedule="cosine",
              diffusion_covariance_type="skeleton-diffusion", gamma_scheduler="cosine",
              loss_reduction_type=loss_type)
    eig = (golden["cov_Sigma_N"], golden["cov_Lambda_N"], golden["cov_U"])
    jproc = jax_build_process(*eig, **kw)
    proc = build_nonisotropic_process(*eig, device="cpu", **kw)
    rng = np.random.default_rng(4)
    a, b = (rng.standard_normal((6, 21, 16)).astype(np.float32) for _ in range(2))
    for t in (np.array([0, 9, 3, 5, 1, 7]), 4):
        jt = jnp.asarray(t)
        tt = torch.from_numpy(t) if isinstance(t, np.ndarray) else t
        pairs = [
            (proc.q_sample(torch.from_numpy(a), tt, torch.from_numpy(b)),
             jproc.q_sample(jnp.asarray(a), jt, jnp.asarray(b))),
            (proc.predict_start_from_noise(torch.from_numpy(a), tt, torch.from_numpy(b)),
             jproc.predict_start_from_noise(jnp.asarray(a), jt, jnp.asarray(b))),
            (proc.predict_noise_from_start(torch.from_numpy(a), tt, torch.from_numpy(b)),
             jproc.predict_noise_from_start(jnp.asarray(a), jt, jnp.asarray(b))),
            (proc.loss_terms(torch.from_numpy(a), torch.from_numpy(b), tt),
             jproc.loss_terms(jnp.asarray(a), jnp.asarray(b), jt)),
        ]
        for got, want in pairs:
            want = np.asarray(want)
            np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                       atol=1e-6 * float(np.abs(want).max()))


def test_derived_generators_are_fixed_functions_of_their_position():
    """The per-epoch and per-iteration generators: the same (seed, epoch,
    iteration, stream) draws the same numbers in any order of creation; any
    other position draws other ones."""
    from skeletondiffusion_tpu_torch.utils import reproducibility as rep

    def draw(gen):
        return torch.rand(4, generator=gen)

    first = draw(rep.iteration_generator(3, 2, 5, 1, device="cpu"))
    for other in [(4, 2, 5, 1), (3, 1, 5, 1), (3, 2, 4, 1), (3, 2, 5, 0)]:
        assert not torch.equal(draw(rep.iteration_generator(*other, device="cpu")), first)
    assert torch.equal(draw(rep.iteration_generator(3, 2, 5, 1, device="cpu")), first)
    epoch = draw(rep.epoch_generator(3, 2, device="cpu"))
    assert torch.equal(draw(rep.epoch_generator(3, 2, device="cpu")), epoch)
    assert not torch.equal(draw(rep.epoch_generator(3, 3, device="cpu")), epoch)
    assert rep.set_seed(7) == 7
    assert 0 <= rep.derived_seed(7, 1, 2) < 2 ** 63


# ---- EMA, schedules, traps ------------------------------------------------------------


def test_ema_matches_jax_over_a_schedule_crossing_update_after_step():
    """Twelve updates with update_every 2 and update_after_step 4: no-ops,
    hard copies, then the warm-up decay, against the JAX ``ema_update`` on
    the same parameter trajectory; and the EMA module's parameters change
    in place (their version counters move)."""
    from skeletondiffusion_tpu.train.ema import ema_init as jax_ema_init
    from skeletondiffusion_tpu.train.ema import ema_update as jax_ema_update

    schedule = dict(beta=0.9, update_every=2, update_after_step=4, power=0.75, min_value=0.1)
    live = torch.nn.Linear(5, 3)
    state = ema_mod.ema_init(live)
    jstate = jax_ema_init({k: jnp.asarray(v.detach().numpy())
                           for k, v in live.named_parameters()})
    rng = np.random.default_rng(0)
    versions = [p._version for p in state.module.parameters()]
    for _ in range(12):
        with torch.no_grad():
            for p in live.parameters():
                p.add_(torch.from_numpy(rng.standard_normal(p.shape).astype(np.float32)))
        ema_mod.ema_update(state, live, **schedule)
        jstate = jax_ema_update(jstate, {k: jnp.asarray(v.detach().numpy())
                                         for k, v in live.named_parameters()}, **schedule)
        for k, v in state.module.named_parameters():
            np.testing.assert_allclose(v.numpy(), np.asarray(jstate.params[k]), rtol=0,
                                       atol=1e-6)
    assert state.step == int(jstate.step) == 12
    assert all(p._version > v for p, v in zip(state.module.parameters(), versions))
    assert not any(p.requires_grad for p in state.module.parameters())
    assert [ema_mod.ema_decay(s, **schedule) for s in (1, 2, 4, 6, 8, 40)] == [
        1.0, 0.0, 0.0, pytest.approx(1 - 2 ** -0.75), pytest.approx(1 - 4 ** -0.75),
        pytest.approx(0.9)]


def test_lr_scheduler_and_curriculum_match_jax():
    """The copied schedules give the JAX sequences, and their state round
    trips (the curriculum's RNG included)."""
    from skeletondiffusion_tpu.train import schedulers as jax_schedulers

    kw = dict(lr_scheduler_type="ExponentialLRSchedulerWarmup", lr=5e-3, warmup_duration=3,
              update_every=2, min_lr=1e-3, gamma_decay=0.5)
    ours, theirs = schedulers.make_lr_scheduler(**kw), jax_schedulers.make_lr_scheduler(**kw)
    assert [ours.step(e) for e in range(1, 15)] == [theirs.step(e) for e in range(1, 15)]
    assert ours.state_dict() == theirs.state_dict()

    ckw = dict(prediction_horizon_train=12, prediction_horizon_train_min=4,
               prediction_horizon_train_min_from_epoch=3, curriculum_it=2,
               random_prediction_horizon=True, iter_per_epoch=5, seed=7)
    cur, jcur = schedulers.CurriculumPH(**ckw), jax_schedulers.CurriculumPH(**ckw)
    grid = [(e, i) for e in range(1, 5) for i in range(0, 25, 3)]
    seq = [cur(e, i) for e, i in grid[:10]]
    assert seq == [jcur(e, i) for e, i in grid[:10]]
    saved = cur.state_dict()
    rest = [cur(e, i) for e, i in grid[10:]]
    again = schedulers.CurriculumPH(**ckw)
    again.load_state_dict(saved)
    assert rest == [again(e, i) for e, i in grid[10:]] == [jcur(e, i) for e, i in grid[10:]]
    assert schedulers.cosine_annealing_factor(5, 10) == jax_schedulers.cosine_annealing_factor(
        5, 10)


def test_l1_normalize_rows_subgradient_at_the_identity_init():
    """The gradient of the row normalization at G = I (every off-diagonal at
    the |·| kink) is torch's sign(0) = 0 subgradient, as the JAX package
    pins with g·sign(g); and off the kink the two agree as well."""
    from skeletondiffusion_tpu.ops.graph_linear import l1_normalize_rows as jax_l1

    n = 5
    cot = np.random.default_rng(2).standard_normal((n, n)).astype(np.float32)
    for g0 in (np.eye(n, dtype=np.float32),
               np.random.default_rng(3).standard_normal((n, n)).astype(np.float32)):
        g = torch.from_numpy(g0.copy()).requires_grad_(True)
        (l1_normalize_rows(g) * torch.from_numpy(cot)).sum().backward()
        want = jax.grad(lambda a: jnp.sum(jax_l1(a) * jnp.asarray(cot)))(jnp.asarray(g0))
        np.testing.assert_allclose(g.grad.numpy(), np.asarray(want), atol=1e-6)


@pytest.mark.parametrize("stage", [1, 2])
def test_optimizers_match_the_jax_chains(stage):
    """Ten steps of each trainer's torch optimizer on random gradients
    against the JAX trainer's optax chain: stage 1 AdamW with AMSGrad over
    the raw second moment (``scale_by_amsgrad_torch``; optax's own
    ``scale_by_amsgrad`` maxes the bias-corrected one and fails within two
    steps) and decoupled decay, stage 2 Adam with coupled L2."""
    import optax

    from skeletondiffusion_tpu.train.trainer_autoencoder import scale_by_amsgrad_torch

    rng = np.random.default_rng(stage)
    shapes = [(7, 5), (5,), (3, 4, 2)]
    params0 = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    grads = [[rng.standard_normal(s).astype(np.float32) for s in shapes] for _ in range(10)]
    lr, wd = 5e-3, 1e-2
    ps = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in params0]
    if stage == 1:
        opt = torch.optim.AdamW(ps, lr=lr, amsgrad=True, weight_decay=wd)
        tx = optax.chain(scale_by_amsgrad_torch(), optax.add_decayed_weights(wd))
    else:
        opt = torch.optim.Adam(ps, lr=lr, betas=(0.9, 0.99), weight_decay=wd)
        tx = optax.chain(optax.add_decayed_weights(wd), optax.scale_by_adam(b1=0.9, b2=0.99))
    jp = [jnp.asarray(p) for p in params0]
    state = tx.init(jp)
    for gs in grads:
        for p, g in zip(ps, gs):
            p.grad = torch.from_numpy(g.copy())
        opt.step()
        updates, state = tx.update([jnp.asarray(g) for g in gs], state, jp)
        jp = optax.apply_updates(jp, jax.tree.map(lambda u: -lr * u, updates))
    for p, q in zip(ps, jp):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(q), atol=1e-6)
