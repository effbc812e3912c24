"""The port's training loop held to the JAX CLIs over a whole small run.

(a) The schedule.  Each stage's training CLI of both packages runs on one
tiny synthetic tree (``tests/test_torch_cli.py``'s), long enough to cross
the LR warmup, several gamma decays and the LR floor, the stage-1
curriculum's cosine ramp and its ph_min ramp, validations every
``eval_frequency`` epochs with the top-k checkpoints rotating, and, in
stage 2, an EMA that goes from no-ops and hard copies into decaying updates.
Wrapped step methods record, per step, the epoch, the iteration, the LR the
optimizer applies and the ph (stage 1; the JAX ``_jit_step``'s ``lr`` and
``ph`` arguments), and the EMA's step counter and the decay that step's
update applies (stage 2; each package's own EMA code at that counter).
Validation is replaced by a recorder that returns a score fixed by the
epoch, so that checkpoint retention depends on the schedule alone; it
records the epochs and splits validated and the EMA counter of the weights
it would read.  None of this depends on the random draws, which differ
between the packages by design: the LR is held to 1e-7 relative,
everything else exactly.

(b) The trajectory.  32 fp32 stage-2 steps of both trainers on the golden
of ``tests/test_torch_train.py`` (k 3, input space), with injected t and
noise from a numpy seed, the LR from each package's scheduler stepped at
every epoch (warmup, then decays), and the EMA from hard copies into decay;
then ``validation_step`` on the EMA weights with injected sampler noise.
The per-step losses, the EMA and live parameters and the validation output
are held to the JAX trainer (tolerances below, with what they measured).
"""
import json
import math
import os
import sys
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_cli import LOADERS, OBS, PRED, TASK, run
from test_torch_train import assert_params, flax_trees, golden, jax_models, port_pair  # noqa: F401

from skeletondiffusion_tpu_torch.cli import train_autoencoder, train_diffusion
from skeletondiffusion_tpu_torch.data import make_synthetic_amass
from skeletondiffusion_tpu_torch.train import ema as ema_mod
from skeletondiffusion_tpu_torch.train import trainer_diffusion as port_trainer_mod
from skeletondiffusion_tpu_torch.train.trainer_autoencoder import AutoEncoderTrainer
from skeletondiffusion_tpu_torch.train.trainer_diffusion import TrainerDiffusion
from skeletondiffusion_tpu_torch.weights import flatten_params

AE_SCHEDULE = [
    "dataset=amass", "model.batch_size=4", "model.num_iter_perepoch=3", "model.num_epochs=9",
    "model.latent_size=8", "model.autoenc_arch.encoder_hidden_size=8",
    "model.autoenc_arch.decoder_hidden_size=8",
    # the cosine ph ramp over 2 epochs, the ph_min ramp over 5
    "model.curriculum_it=2", "model.prediction_horizon_train_min=4",
    "model.prediction_horizon_train_min_from_epoch=5",
    "model.if_run_validation=True", "model.eval_frequency=2", "model.save_frequency=3",
    "model.num_iteration_eval=1", "model.batch_size_eval=4",
    # lr 5e-3: flat for 2 epochs, then halved each epoch down to the 1e-4 floor,
    # which the scheduler takes at the epoch after the one that went below it
    "model.lr_scheduler_kwargs.warmup_duration=3", "model.lr_scheduler_kwargs.gamma_decay=0.5",
    "model.lr_scheduler_kwargs.update_every=1", "model.lr_scheduler_kwargs.min_lr=0.0001",
    "model.log_every_iters=1",
]
DIFF_SCHEDULE = [
    "model.batch_size=4", "model.num_iter_perepoch=2", "model.num_epochs=12",
    # the k-best choice in latent space: the schedule does not depend on it
    "model.train_pick_best_sample_among_k=2", "model.similarity_space=latent_space",
    "model.diffusion_timesteps=4",
    "model.diffusion_arch.depth=1", "model.diffusion_arch.attn_heads=2",
    "model.diffusion_arch.attn_dim_head=4", "model.compute_dtype=null",
    # every epoch validates: 12 scored checkpoints rotate through the 10 kept
    "model.if_run_validation=True", "model.eval_frequency=1", "model.num_iteration_eval=1",
    "model.batch_size_eval=4", "model.num_prob_samples=3",
    # updates on every third call; hard copies through call 5, decay after
    "model.step_start_ema=5", "model.ema_update_every=3",
    # lr 1e-3: flat for 3 epochs, ×0.7 every second epoch to the 3e-4 floor
    "model.lr_scheduler_kwargs.warmup_duration=4", "model.lr_scheduler_kwargs.gamma_decay=0.7",
    "model.lr_scheduler_kwargs.update_every=2", "model.lr_scheduler_kwargs.min_lr=0.0003",
    "model.log_every_iters=1",
]


def score_of(epoch: int) -> float:
    """The validation score both packages' recorders return (lower is
    better): a ranking that keeps neither the first nor the last epochs."""
    return float((epoch * 7) % 11 + 1)


class Recorder:
    """What one CLI run did, step by step."""

    def __init__(self):
        self.epoch = 0
        self.iteration = 0
        self.steps = []        # one dict a step
        self.validated = []    # (epoch, prefix, EMA counter of the weights read or None)

    def epoch_started(self, epoch):
        self.epoch, self.iteration = epoch, 0

    def step(self, **values):
        self.steps.append(dict(epoch=self.epoch, iteration=self.iteration, **values))
        self.iteration += 1


def checkpoints(exp: str):
    """The kept checkpoints: (name, step, score) from the index, each with its
    file or directory present."""
    directory = os.path.join(exp, "checkpoints")
    with open(os.path.join(directory, "index.json")) as f:
        index = json.load(f)
    for e in index:
        assert any(os.path.exists(os.path.join(directory, e["name"] + ext))
                   for ext in ("", ".pt")), e
    return sorted((e["name"], e["step"], e["score"]) for e in index)


@pytest.fixture(scope="module", autouse=True)
def no_tensorboard():
    """Both packages' metrics loggers without TensorBoard's writer (which
    imports TensorFlow where it is installed), as on the card's machine: the
    JSONL log is what the tests read."""
    key, missing = "torch.utils.tensorboard", object()
    saved = sys.modules.get(key, missing)
    sys.modules[key] = None  # the import raises ImportError; the loggers go on without it
    yield
    if saved is missing:
        del sys.modules[key]
    else:
        sys.modules[key] = saved


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("schedule_tree")
    return make_synthetic_amass(str(root), obs_length=OBS, pred_length=PRED, clip_len=60,
                                seed=3)


def common(tree):
    return [f"dataset_main_path={tree}", "device=cpu", "device_mesh.n_devices=1", *TASK,
            *LOADERS]


# ---- stage 1 ------------------------------------------------------------------------


def port_stage1(args):
    rec = Recorder()
    step, started = AutoEncoderTrainer.train_step, AutoEncoderTrainer.epoch_started

    def train_step(self, batch, epoch, iteration):
        loss, ph = step(self, batch, epoch, iteration)
        rec.step(epoch_arg=epoch, it_global=iteration, ph=ph,
                 lr=self.optimizer.param_groups[0]["lr"])
        return loss, ph

    def epoch_started(self, epoch):
        rec.epoch_started(epoch)
        return started(self, epoch)

    def validate(cfg, skeleton, trainer, logger, epoch, device, prefix="valid", **kw):
        rec.validated.append((epoch, prefix, None))
        return score_of(epoch)

    with mock.patch.object(AutoEncoderTrainer, "train_step", train_step), \
            mock.patch.object(AutoEncoderTrainer, "epoch_started", epoch_started), \
            mock.patch.object(train_autoencoder, "validate", validate):
        exp = run(train_autoencoder.main, "config_train_autoencoder", args)
    return rec, exp


def jax_stage1(args):
    from skeletondiffusion_tpu.cli import train_autoencoder as jax_cli
    from skeletondiffusion_tpu.train.trainer_autoencoder import AutoEncoderTrainer as JaxTrainer

    rec = Recorder()
    step, started = JaxTrainer.train_step, JaxTrainer.epoch_started

    def train_step(self, state, rng, batch, epoch, iteration):
        jit_step = self._jit_step
        applied = {}

        def recording(state, rng, x, y, ph, lr):
            applied.update(ph=int(ph), lr=float(lr))
            return jit_step(state, rng, x, y, ph, lr)

        self._jit_step = recording
        try:
            out = step(self, state, rng, batch, epoch, iteration)
        finally:
            self._jit_step = jit_step
        rec.step(epoch_arg=epoch, it_global=iteration, **applied)
        return out

    def epoch_started(self, epoch):
        rec.epoch_started(epoch)
        return started(self, epoch)

    def validate(cfg, skeleton, trainer, state, logger, epoch, prefix="valid", **kw):
        rec.validated.append((epoch, prefix, None))
        return score_of(epoch)

    with mock.patch.object(JaxTrainer, "train_step", train_step), \
            mock.patch.object(JaxTrainer, "epoch_started", epoch_started), \
            mock.patch.object(jax_cli, "validate", validate):
        exp = run(jax_cli.main, "config_train_autoencoder", args)
    return rec, exp


def assert_same_schedule(port, jax_rec, n_steps):
    assert len(port.steps) == len(jax_rec.steps) == n_steps
    for i, (a, b) in enumerate(zip(port.steps, jax_rec.steps)):
        assert a.keys() == b.keys(), i
        for k in a:
            if k == "lr":
                assert math.isclose(a[k], b[k], rel_tol=1e-7), (i, a, b)
            else:
                assert a[k] == b[k], (i, k, a, b)
    assert port.validated == jax_rec.validated


@pytest.fixture(scope="module")
def stage1(tree, tmp_path_factory):
    out = tmp_path_factory.mktemp("schedule_ae")
    args = common(tree) + AE_SCHEDULE
    port = port_stage1(args + [f"output_log_path={out / 'port'}"])
    jax_run = jax_stage1(args + [f"output_log_path={out / 'jax'}"])
    return port, jax_run


def test_stage1_schedule_equals_the_jax_cli(stage1):
    """Per step the epoch, the iteration, the LR applied and the ph; the
    epochs validated; the checkpoints kept; the per-epoch rows' LR and ph."""
    (port, port_exp), (jax_rec, jax_exp) = stage1
    assert_same_schedule(port, jax_rec, 9 * 3)
    steps = port.steps
    assert [s["it_global"] for s in steps] == list(range(27))
    lrs = [s["lr"] for s in steps[::3]]
    assert lrs[:2] == [5e-3] * 2 and lrs[-1] == 1e-4 and len(set(lrs)) >= 5
    phs = [s["ph"] for s in steps]
    assert phs[0] < phs[5] and min(phs) >= 1 and max(phs) < PRED
    assert port.validated == [(e, p, None) for e in (2, 4, 6, 8)
                              for p in ("valid", "train_eval")]
    assert checkpoints(port_exp) == checkpoints(jax_exp)
    rows = {}
    for name, exp in (("port", port_exp), ("jax", jax_exp)):
        with open(os.path.join(exp, "metrics.jsonl")) as f:
            rows[name] = [(r["step"], r["lr"], r["ph"]) for r in map(json.loads, f)
                          if r["prefix"] == "train"]
    assert len(rows["port"]) == 9
    for a, b in zip(rows["port"], rows["jax"], strict=True):
        assert a[0] == b[0] and a[2] == b[2] and math.isclose(a[1], b[1], rel_tol=1e-7)


# ---- stage 2 ------------------------------------------------------------------------


def port_stage2(args):
    rec = Recorder()
    step, started = TrainerDiffusion.train_step, TrainerDiffusion.epoch_started
    update = port_trainer_mod.ema_update

    def ema_update(state, module, **schedule):
        rec.ema = (state.step, ema_mod.ema_decay(state.step, **schedule))
        return update(state, module, **schedule)

    def train_step(self, batch, generator=None, **kw):
        loss = step(self, batch, generator, **kw)
        counter, decay = rec.ema
        rec.step(lr=self.optimizer.param_groups[0]["lr"], ema_step=counter, ema_decay=decay,
                 step=self.step - 1)
        return loss

    def epoch_started(self, epoch):
        rec.epoch_started(epoch)
        return started(self, epoch)

    def validate(cfg, skeleton, trainer, logger, epoch, device, prefix="valid", **kw):
        # the predictor validation samples with runs on the EMA module
        assert trainer.predictor().diffusion.denoiser is trainer.ema.module
        rec.validated.append((epoch, prefix, trainer.ema.step))
        return score_of(epoch)

    with mock.patch.object(TrainerDiffusion, "train_step", train_step), \
            mock.patch.object(TrainerDiffusion, "epoch_started", epoch_started), \
            mock.patch.object(port_trainer_mod, "ema_update", ema_update), \
            mock.patch.object(train_diffusion, "validate", validate):
        exp = run(train_diffusion.main, "config_train_diffusion", args)
    return rec, exp


def jax_decay(step: int, schedule: dict) -> float:
    """The decay the JAX ``ema_update`` applies at update call ``step``: its
    own code on a one-number tree (ema 0, live 1 → 1 − decay)."""
    from skeletondiffusion_tpu.train.ema import EMAState
    from skeletondiffusion_tpu.train.ema import ema_update as jax_ema_update

    state = EMAState(params={"w": jnp.zeros((), jnp.float32)},
                     step=jnp.asarray(step, jnp.int32))
    return float(np.float32(1) - np.float32(
        jax_ema_update(state, {"w": jnp.ones((), jnp.float32)}, **schedule).params["w"]))


def jax_stage2(args):
    from skeletondiffusion_tpu.cli import train_diffusion as jax_cli
    from skeletondiffusion_tpu.train.trainer_diffusion import TrainerDiffusion as JaxTrainer

    rec = Recorder()
    step, started = JaxTrainer.train_step, JaxTrainer.epoch_started

    def train_step(self, state, rng, batch):
        jit_step = self._jit_step
        applied = {}

        def recording(state, rng, x, y, lr):
            applied.update(lr=float(lr), ema_step=int(state.ema.step),
                           step=int(state.step))
            return jit_step(state, rng, x, y, lr)

        self._jit_step = recording
        try:
            out = step(self, state, rng, batch)
        finally:
            self._jit_step = jit_step
        rec.step(lr=applied["lr"], ema_step=applied["ema_step"],
                 ema_decay=jax_decay(applied["ema_step"], self.ema_kwargs), step=applied["step"])
        return out

    def epoch_started(self, epoch):
        rec.epoch_started(epoch)
        return started(self, epoch)

    def validate(cfg, skeleton, trainer, state, logger, epoch, prefix="valid", **kw):
        assert trainer.if_use_ema  # the JAX validation reads state.ema.params
        rec.validated.append((epoch, prefix, int(state.ema.step)))
        return score_of(epoch)

    with mock.patch.object(JaxTrainer, "train_step", train_step), \
            mock.patch.object(JaxTrainer, "epoch_started", epoch_started), \
            mock.patch.object(jax_cli, "validate", validate):
        exp = run(jax_cli.main, "config_train_diffusion", args)
    return rec, exp


@pytest.fixture(scope="module")
def stage2(stage1, tree, tmp_path_factory):
    out = tmp_path_factory.mktemp("schedule_diff")
    (_, port_ae), (_, jax_ae) = stage1
    args = common(tree) + DIFF_SCHEDULE
    port = port_stage2(args + [f"output_log_path={out / 'port'}",
                               f"model.pretrained_autoencoder_path={port_ae}/checkpoints"])
    jax_run = jax_stage2(args + [f"output_log_path={out / 'jax'}",
                                 f"model.pretrained_autoencoder_path={jax_ae}/checkpoints"])
    return port, jax_run


def test_stage2_schedule_equals_the_jax_cli(stage2):
    """Per step the epoch, the iteration, the LR applied, the EMA's counter
    and the decay its update applies; the epochs validated and the EMA
    counter of the weights they read; the checkpoints kept."""
    (port, port_exp), (jax_rec, jax_exp) = stage2
    assert_same_schedule(port, jax_rec, 12 * 2)
    steps = port.steps
    assert [s["step"] for s in steps] == [s["ema_step"] for s in steps] == list(range(24))
    decays = [s["ema_decay"] for s in steps]
    # no-ops off every third call, hard copies through call 5, then decay
    assert decays[:7] == [0.0, 1.0, 1.0, 0.0, 1.0, 1.0, 0.0]
    assert all(0.0 < d < 1.0 for d in decays[9::3]) and decays[9] < decays[-3]
    lrs = [s["lr"] for s in steps[::2]]
    assert lrs[:3] == [1e-3] * 3 and lrs[-1] == 3e-4 and len(set(lrs)) >= 5
    assert [(e, p) for e, p, _ in port.validated] == [
        (e, p) for e in range(1, 13) for p in ("valid", "train_eval")]
    assert [c for _, _, c in port.validated[::2]] == list(range(2, 26, 2))
    kept = checkpoints(port_exp)
    assert kept == checkpoints(jax_exp)
    scored = [step for name, step, score in kept if score is not None]
    assert len(scored) == 10 and sorted(set(range(1, 13)) - set(scored)) == sorted(
        sorted(range(1, 13), key=score_of)[-2:])


# ---- (b) the trajectory ---------------------------------------------------------------

STEPS, ITERS = 32, 4
EMA = dict(ema_update_every=2, step_start_ema=6, ema_decay=0.995, ema_power=2 / 3)
LR = dict(lr_scheduler_type="ExponentialLRSchedulerWarmup", warmup_duration=3,
          update_every=1, min_lr=2e-4, gamma_decay=0.8)
SAMPLES = 3


def injected(cfg, golden, seed=11):
    rng = np.random.default_rng(seed)
    b, n, latent = golden["x"].shape[0], golden["x"].shape[2], cfg["latent"]
    ts = rng.integers(0, cfg["t_diff"], size=(STEPS, b))
    noises = rng.standard_normal((STEPS, b * cfg["k"], n, latent), dtype=np.float32)
    start = rng.standard_normal((b * SAMPLES, n, latent), dtype=np.float32)
    steps = rng.standard_normal((b * SAMPLES, cfg["t_diff"] - 1, n, latent), dtype=np.float32)
    return ts, noises, start, steps


def jax_trajectory(golden, cfg, flax_trees, ts, noises, start, steps):
    """The JAX trainer's ``_train_step`` composition (value_and_grad of its
    loss, its optax chain at the scheduler's LR, its EMA update) with the
    loss's t and noise injected, jitted; then its validation on the EMA
    weights with injected sampler noise."""
    import optax

    from skeletondiffusion_tpu.train.trainer_diffusion import TrainerDiffusion as JaxTrainer

    jsk, ae, diffusion = jax_models(golden, cfg, flax_trees)
    tr = JaxTrainer(diffusion, ae, flax_trees["ae"], train_pick_best_sample_among_k=cfg["k"],
                    similarity_space="input_space", skeleton=jsk, lr=1e-3, weight_decay=0.01,
                    use_lr_scheduler=True, lr_scheduler_kwargs=dict(LR),
                    prediction_horizon_eval=cfg["pred"], num_prob_samples=SAMPLES,
                    **EMA)
    from skeletondiffusion_tpu.train.ema import ema_update as jax_ema_update

    x, y = jnp.asarray(golden["x"]), jnp.asarray(golden["y"])
    z_past, z = tr._embed(x, y)
    state = tr.init(jax.tree.map(jnp.asarray, flax_trees["den"]))

    @jax.jit
    def step(state, t, noise, lr):
        loss, grads = jax.value_and_grad(
            lambda p: tr.loss(p, jax.random.key(0), x, y, z, z_past, t=t, noise=noise))(
            state.params)
        updates, opt_state = tr.tx.update(grads, state.opt_state, state.params)
        params = optax.apply_updates(state.params, jax.tree.map(lambda u: -lr * u, updates))
        ema = jax_ema_update(state.ema, params, **tr.ema_kwargs)
        return state._replace(params=params, opt_state=opt_state, ema=ema,
                              step=state.step + 1), loss

    losses, lrs = [], []
    for i in range(STEPS):
        if i % ITERS == 0:
            tr.epoch_started(i // ITERS + 1)
        lrs.append(tr.lr_scheduler._current)
        state, loss = step(state, jnp.asarray(ts[i]), jnp.asarray(noises[i]),
                           jnp.asarray(lrs[-1], jnp.float32))
        losses.append(float(loss))
    from skeletondiffusion_tpu.eval_pipeline import SkeletonDiffusionPredictor as JaxPredictor

    pred = JaxPredictor(jsk, ae, flax_trees["ae"], diffusion, state.ema.params,
                        num_samples=SAMPLES, pred_length=cfg["pred"])
    out, latents = pred(jax.random.key(0), x, start_noise=jnp.asarray(start),
                        step_noise=jnp.asarray(steps))
    return dict(losses=losses, lrs=lrs, ema=jax.device_get(state.ema.params),
                params=jax.device_get(state.params), ema_step=int(state.ema.step),
                out=np.asarray(out), latents=np.asarray(latents))


def port_trajectory(golden, cfg, flax_trees, ts, noises, start, steps):
    sk, ae, engine = port_pair(golden, cfg, flax_trees)
    tr = TrainerDiffusion(engine, ae, skeleton=sk, train_pick_best_sample_among_k=cfg["k"],
                          similarity_space="input_space", lr=1e-3, weight_decay=0.01,
                          use_lr_scheduler=True, lr_scheduler_kwargs=dict(LR),
                          prediction_horizon_eval=cfg["pred"], num_prob_samples=SAMPLES, **EMA)
    x, y = torch.from_numpy(golden["x"]), torch.from_numpy(golden["y"])
    losses, lrs = [], []
    for i in range(STEPS):
        if i % ITERS == 0:
            tr.epoch_started(i // ITERS + 1)
        loss = tr.train_step((x, y), t=torch.from_numpy(ts[i]),
                             noise=torch.from_numpy(noises[i]))
        lrs.append(tr.optimizer.param_groups[0]["lr"])
        losses.append(float(loss))
    out, _, latents, _ = tr.validation_step((x, y), start_noise=torch.from_numpy(start),
                                            step_noise=torch.from_numpy(steps))
    return dict(losses=losses, lrs=lrs, trainer=tr, out=out.numpy(), latents=latents.numpy())


@pytest.fixture(scope="module")
def trajectories(golden, flax_trees):  # noqa: F811
    cfg = json.loads(str(golden["config_json"]))
    draws = injected(cfg, golden)
    return (cfg, port_trajectory(golden, cfg, flax_trees, *draws),
            jax_trajectory(golden, cfg, flax_trees, *draws))


def test_stage2_trajectory_holds_the_jax_trainer(trajectories):
    """32 steps across the EMA's switch from hard copies to decay and seven
    LR decays: the losses at rtol 5e-4 (test_torch_train's two-step bound;
    measured 1.2e-5), the live and EMA parameters after at atol 1e-3
    (a third of its 3·lr; measured 2.0e-4 and 7.7e-5, against entries up to
    0.98) and the EMA's counter.  The EMA ends 4.2e-3 off the live weights,
    so the EMA comparison cannot pass on a copy of them."""
    cfg, port, jax_run = trajectories
    tr = port["trainer"]
    np.testing.assert_allclose(port["lrs"], jax_run["lrs"], rtol=1e-7)
    assert port["lrs"][0] == 1e-3 and port["lrs"][-1] < 4e-4
    decays = [ema_mod.ema_decay(s, beta=0.995, update_every=2, update_after_step=6,
                                power=2 / 3) for s in range(STEPS)]
    assert decays[6] == 0.0 and 0.0 < decays[8] < decays[-2] < 1.0
    np.testing.assert_allclose(port["losses"], jax_run["losses"], rtol=5e-4)
    assert tr.ema.step == jax_run["ema_step"] == STEPS
    assert_params(tr.denoiser, jax_run["params"], 1e-3, "live weights after 32 steps")
    assert_params(tr.ema.module, jax_run["ema"], 1e-3, "EMA weights after 32 steps")
    live, ema = flatten_params(jax_run["params"]), flatten_params(jax_run["ema"])
    assert max(float((live[k] - ema[k]).abs().max()) for k in live) > 2e-3


def test_validation_on_the_ema_weights_holds_the_jax_trainer(trajectories):
    """``validation_step`` after the 32 steps (the EMA weights, injected
    sampler noise) against the JAX predictor on the JAX trainer's EMA
    weights: latents and decoded predictions at atol 5e-5, the fp32
    predictor bound of test_torch_cli (measured 5.2e-6 on latents up to
    0.056 and 5.0e-7 on predictions up to 0.29)."""
    cfg, port, jax_run = trajectories
    assert port["out"].shape == jax_run["out"].shape == (
        4, SAMPLES, cfg["pred"], port["out"].shape[3], 3)
    np.testing.assert_allclose(port["latents"], jax_run["latents"], atol=5e-5)
    np.testing.assert_allclose(port["out"], jax_run["out"], atol=5e-5)
