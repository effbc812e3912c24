"""Bit-faithful resume of the port's two trainers, and its checkpoint
manager's retention.

Each stage runs a small training loop over the port's synthetic AMASS train
split as the JAX CLIs run theirs (``DataLoader`` → ``cycled_batches`` →
``prefetch_iterator`` → ``preprocess_batch`` with mirroring and rotation,
per-iteration generators from ``utils/reproducibility``, the LR scheduler
stepped at each epoch, the AE's curriculum and stage 2's EMA active): four
epochs straight, against two epochs, a checkpoint (``CheckpointManager`` and
``host_state.json``), fresh objects restored from it and the last two
epochs.  On the CPU the two runs are bit for bit equal: the losses, the
parameters, the optimizer state and the EMA.  The checkpoint manager's test
mirrors the JAX one's retention (``tests/test_aux_rows.py``,
``tests/test_isotropic_equivalence.py``): top-k by score plus the rolling
latest, ``index.json``, a re-saved step replacing its entry, and the partial
restore stage 2 loads the AE with.
"""
import json
import os

import pytest
import torch

from skeletondiffusion_tpu_torch.data import AMASSDataset, DataLoader, make_synthetic_amass
from skeletondiffusion_tpu_torch.data.batch import (
    cycled_batches,
    prefetch_iterator,
    preprocess_batch,
)
from skeletondiffusion_tpu_torch.diffusion.manager import create_diffusion
from skeletondiffusion_tpu_torch.models import AutoEncoder
from skeletondiffusion_tpu_torch.skeleton import create_skeleton
from skeletondiffusion_tpu_torch.train.checkpoint import (
    CheckpointManager,
    load_host_state,
    save_host_state,
)
from skeletondiffusion_tpu_torch.train.trainer_autoencoder import AutoEncoderTrainer
from skeletondiffusion_tpu_torch.train.trainer_diffusion import TrainerDiffusion
from skeletondiffusion_tpu_torch.utils.reproducibility import iteration_generator, set_seed

OBS, PRED, LATENT, SEED = 6, 12, 8, 11
ITERS, EPOCHS = 2, 4
ARCH = {"depth": 1, "attn_heads": 2, "attn_dim_head": 4, "learn_influence": True}
LR_SCHEDULE = dict(lr_scheduler_type="ExponentialLRSchedulerWarmup", warmup_duration=1,
                   update_every=1, min_lr=1e-4, gamma_decay=0.5)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = make_synthetic_amass(str(tmp_path_factory.mktemp("resume_tree")), obs_length=OBS,
                                pred_length=PRED, clip_len=60, seed=3)
    return os.path.join(root, "processed", "AMASS", "hmp")


def skeleton():
    return create_skeleton(dataset_name="amass", motion_repr_type="SkeletonRescalePose",
                           num_joints=22, pose_box_size=1.1, obs_length=OBS, pred_length=PRED,
                           if_consider_hip=False)


def data(tree, sk):
    ds = AMASSDataset(datasets=["ACCAD", "CMU"], split="train", precomputed_folder=tree,
                      skeleton=sk, obs_length=OBS, pred_length=PRED, if_consider_hip=False,
                      stride=4, augmentation=2, rng_seed=SEED, silent=True)
    return ds, DataLoader(ds, batch_size=4, shuffle=True, drop_last=True, seed=SEED)


def batches(sk, loader, epoch):
    """The epoch's (iteration, generator of the train step, (x, y)) in input
    space, augmented."""
    for it, batch in enumerate(prefetch_iterator(cycled_batches(loader, ITERS), device="cpu")):
        x, y, _ = preprocess_batch(sk, iteration_generator(SEED, epoch, it, 0, "cpu"),
                                   batch["obs"], batch["pred"], train=True, da_mirroring=0.5,
                                   da_rotations=1.0)
        yield it, iteration_generator(SEED, epoch, it, 1, "cpu"), (x, y)


def autoencoder(sk, seed):
    return AutoEncoder(sk.num_nodes, 8, 8, LATENT, torch.Generator().manual_seed(seed),
                       node_types=sk.nodes_type_id)


def make_trainer(stage, sk):
    if stage == 1:
        return AutoEncoderTrainer(autoencoder(sk, SEED), lr=5e-3, iter_per_epoch=ITERS,
                                  prediction_horizon_train=PRED, prediction_horizon_eval=PRED,
                                  curriculum_it=2, prediction_horizon_train_min=3,
                                  prediction_horizon_train_min_from_epoch=2,
                                  use_lr_scheduler=True, lr_scheduler_kwargs=LR_SCHEDULE,
                                  seed=SEED)
    engine, _ = create_diffusion(sk, torch.Generator().manual_seed(SEED + 1),
                                 latent_size=LATENT, diffusion_timesteps=3, diffusion_arch=ARCH,
                                 device="cpu")
    return TrainerDiffusion(engine, autoencoder(sk, SEED + 2), lr=1e-3,
                            train_pick_best_sample_among_k=2, similarity_space="input_space",
                            ema_update_every=1, step_start_ema=1, use_lr_scheduler=True,
                            lr_scheduler_kwargs=LR_SCHEDULE, prediction_horizon_eval=PRED,
                            skeleton=sk)


def train(stage, tree, out_dir, epochs, resume=False):
    """Train ``epochs`` epochs (continuing from the checkpoint in ``out_dir``
    with ``resume``); returns (trainer, {global step: loss})."""
    set_seed(SEED)
    sk = skeleton()
    ds, loader = data(tree, sk)
    tr = make_trainer(stage, sk)
    ckpt = CheckpointManager(os.path.join(out_dir, "checkpoints"), n_saved=2)
    start = 1
    if resume:
        tr.load_state_dict(ckpt.restore()["trainer"])
        host = load_host_state(out_dir)
        loader.load_state_dict(host["loader"])
        ds.load_state_dict(host["dataset"])
        start = host["epoch"] + 1
    losses = {}
    for epoch in range(start, epochs + 1):
        tr.epoch_started(epoch)
        for it, gen, batch in batches(sk, loader, epoch):
            step = (epoch - 1) * ITERS + it
            if stage == 1:
                loss, _ = tr.train_step(batch, epoch, step)
            else:
                loss = tr.train_step(batch, gen)
            losses[step] = loss
        ckpt.save_latest({"trainer": tr.state_dict()}, step=epoch)
        save_host_state(out_dir, {"epoch": epoch, "loader": loader.state_dict(),
                                  "dataset": ds.state_dict()})
    return tr, losses


def assert_same(a, b, where=""):
    """Nested state dicts equal bit for bit."""
    if isinstance(a, torch.Tensor):
        assert torch.equal(a, b), where
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            assert_same(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{where}[{i}]")
    else:
        assert a == b, where


@pytest.mark.parametrize("stage", [1, 2])
def test_resume_repeats_the_uninterrupted_run(tree, tmp_path, stage):
    straight, losses = train(stage, tree, str(tmp_path / "straight"), EPOCHS)
    split = str(tmp_path / "split")
    _, first = train(stage, tree, split, EPOCHS // 2)
    resumed, rest = train(stage, tree, split, EPOCHS, resume=True)
    assert sorted(first) == list(range(ITERS * EPOCHS // 2))
    for step, loss in {**first, **rest}.items():
        assert torch.equal(loss, losses[step]), step
    assert_same(resumed.state_dict(), straight.state_dict(), "trainer")
    assert resumed.step == straight.step == ITERS * EPOCHS
    if stage == 1:  # the curriculum drew random horizons on the way
        start = make_trainer(1, skeleton()).curriculum.state_dict()
        assert straight.curriculum.state_dict() != start
    else:  # the EMA moved off the live weights and off its start
        ema = straight.ema.module.state_dict()
        assert straight.ema.step == ITERS * EPOCHS
        assert any(not torch.equal(v, straight.denoiser.state_dict()[k]) for k, v in ema.items())
    with open(os.path.join(split, "checkpoints", "index.json")) as f:
        assert [e["name"] for e in json.load(f)] == [f"latest_{EPOCHS}"]


def test_checkpoint_retention_index_and_partial_restore(tmp_path):
    sk = skeleton()
    ae = autoencoder(sk, 0)
    ckpt = CheckpointManager(str(tmp_path / "ck"), n_saved=2)
    assert ckpt.latest_path() is None and ckpt.best_path() is None
    with pytest.raises(FileNotFoundError):
        ckpt.restore()
    for step, score in [(1, -3.0), (2, -1.0), (3, -2.0), (4, -5.0)]:
        with torch.no_grad():
            ae.decoder.G0.fill_(step)
        ckpt.save({"model": ae.state_dict(), "step": step}, step=step, score=score)
    ckpt.save_latest({"model": ae.state_dict(), "step": 4}, step=4)
    # top 2 by score (ckpt_1 went when ckpt_3 came), plus the step just saved
    # (ckpt_4, last on score: pruned at the next scored save) and the rolling
    # latest
    with open(tmp_path / "ck" / "index.json") as f:
        index = json.load(f)
    assert [e["name"] for e in index] == ["ckpt_2", "ckpt_3", "ckpt_4", "latest_4"]
    assert sorted(os.listdir(tmp_path / "ck")) == ["ckpt_2.pt", "ckpt_3.pt", "ckpt_4.pt",
                                                   "index.json", "latest_4.pt"]
    assert ckpt.best_path().endswith("ckpt_2.pt")
    assert ckpt.latest_path().endswith("_4.pt")  # the highest step (ckpt_4 and latest_4)
    # a re-save of a step replaces its entry (and prunes ckpt_4); a new
    # latest replaces the old
    ckpt.save({"model": ae.state_dict(), "step": 3}, step=3, score=-0.5)
    ckpt.save_latest({"model": ae.state_dict(), "step": 5}, step=5)
    again = CheckpointManager(str(tmp_path / "ck"), n_saved=2)  # reads index.json
    assert [e["name"] for e in again._index] == ["ckpt_2", "ckpt_3", "latest_5"]
    assert again.best_path().endswith("ckpt_3.pt")
    # stage 2 takes the AE's weights alone, and loads them strictly
    part = again.restore_partial({"model": ae.state_dict()}, again.best_path())
    assert part.keys() == {"model"}
    fresh = autoencoder(sk, 1)
    fresh.load_state_dict(part["model"])
    assert float(fresh.decoder.G0[0, 0].detach()) == 4.0  # ckpt_3 was re-saved after G0 = 4
    assert again.restore(again.best_path())["step"] == 3
    with pytest.raises(KeyError):
        again.restore_partial({"ema": None})
    save_host_state(str(tmp_path), {"epoch": 3, "big": 2 ** 100})
    assert load_host_state(str(tmp_path)) == {"epoch": 3, "big": 2 ** 100}
    assert load_host_state(str(tmp_path / "ck")) is None
