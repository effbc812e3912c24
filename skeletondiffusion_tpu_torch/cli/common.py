"""Shared CLI plumbing: the skeleton, the datasets, the AutoEncoder and the
device from a flattened config, the frozen stage-1 AutoEncoder, and the epoch
loop both training CLIs run.

Port of ``skeletondiffusion_tpu/cli/common.py`` (`:19-124`; the reference's
`src/train_utils.py` and `src/inference_utils.py` factories).  In place of
``setup_mesh``, ``setup_device`` picks the one device the run uses.
"""
from __future__ import annotations

import os
from functools import partial
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch
from torch import nn

from ..data import DATASET_CLASSES, DataLoader
from ..data.batch import bounded_batches, cycled_batches, prefetch_iterator, preprocess_batch
from ..device import resolve_device
from ..models import AutoEncoder
from ..skeleton import create_skeleton
from ..train.checkpoint import CheckpointManager, load_host_state, save_host_state
from ..utils.config import save_config, snapshot_code
from ..utils.debug import configure_debug
from ..utils.logging import MetricsLogger
from ..utils.reproducibility import iteration_generator, set_seed

# the stored-config keys create_diffusion consumes — ONE list shared by the
# train and eval CLIs so a new key can't silently reach only one of them
# (a copy of skeletondiffusion_tpu/cli/common.py:116)
DIFFUSION_CFG_KEYS = (
    "diffusion_type", "covariance_matrix_type", "reachability_matrix_degree_factor",
    "reachability_matrix_stop_at", "if_sigma_n_scale", "sigma_n_scale",
    "if_run_as_isotropic", "diffusion_conditioning", "diffusion_timesteps",
    "diffusion_objective", "beta_schedule", "beta_schedule_factor",
    "diffusion_covariance_type", "gamma_scheduler", "loss_reduction_type",
    "diffusion_loss_type", "diffusion_activation", "diffusion_arch",
    "sampling_timesteps", "ddim_sampling_eta", "compute_dtype", "remat_denoiser",
)


def diffusion_kwargs(cfg: Dict[str, Any]) -> Dict[str, Any]:
    """The keys of ``cfg`` that ``create_diffusion`` takes."""
    return {k: v for k, v in cfg.items() if k in DIFFUSION_CFG_KEYS}


def build_skeleton(cfg: Dict[str, Any]):
    return create_skeleton(
        dataset_name=cfg["dataset_name"],
        motion_repr_type=cfg["motion_repr_type"],
        num_joints=cfg["num_joints"],
        pose_box_size=cfg.get("pose_box_size", 1.5),
        obs_length=cfg["obs_length"],
        pred_length=cfg["pred_length"],
        if_consider_hip=cfg["if_consider_hip"],
        seq_centering=cfg.get("seq_centering", 0),
    )


def build_dataset(cfg: Dict[str, Any], skeleton, split: str, loader_key: str, **extra):
    if cfg["dataset_type"] not in DATASET_CLASSES:
        raise NotImplementedError(
            f"{cfg['dataset_type']}: the port reads {sorted(DATASET_CLASSES)}")
    ds_cls = DATASET_CLASSES[cfg["dataset_type"]]
    loader_cfg = dict(cfg[loader_key])
    loader_cfg.pop("shuffle", None)
    loader_cfg.pop("drop_last", None)
    kwargs = dict(
        split=split,
        precomputed_folder=cfg["precomputed_folder"],
        skeleton=skeleton,
        obs_length=cfg["obs_length"],
        pred_length=cfg["pred_length"],
        if_consider_hip=cfg["if_consider_hip"],
        dtype=cfg.get("dtype", "float32"),
        annotations_folder=cfg.get("annotations_folder"),
        silent=cfg.get("silent", False),
        **loader_cfg,
        **extra,
    )
    if cfg["dataset_type"] != "H36MDataset":
        kwargs.pop("subjects", None)
    if cfg["dataset_type"] == "AMASSDataset":
        kwargs.pop("actions", None)
        kwargs.pop("annotations_folder", None)
    # the hmp pipeline assumes raw metric-space coordinates: the on-device
    # augmentations, the noisy observation, the skeleton's input transforms
    # and the mm-GT and CMD statistics are incoherent on standardized data
    # (the reference blocks it with `assert not normalize_data`,
    # `base_dataset.py:56`)
    if kwargs.get("normalize_data") and cfg.get("task_name", "hmp") == "hmp":
        raise ValueError(
            "normalize_data=True is incompatible with the hmp pipeline "
            "(device-side augmentation + skeleton transforms assume raw "
            "metric space); use the dataset-level normalize/denormalize "
            "API directly instead"
        )
    return ds_cls(**kwargs)


def compute_dtype(cfg: Dict[str, Any]) -> Optional[torch.dtype]:
    """The networks' ``compute_dtype`` key as a torch dtype (None: float32)."""
    name = cfg.get("compute_dtype")
    dtypes = {None: None, "float32": None, "bfloat16": torch.bfloat16}
    if name not in dtypes:
        raise ValueError(f"compute_dtype={name!r} (use null, float32 or bfloat16)")
    return dtypes[name]


def build_autoencoder(cfg: Dict[str, Any], skeleton, generator: torch.Generator) -> AutoEncoder:
    """The AutoEncoder of ``cfg`` (``autoenc_arch``: the hidden sizes,
    ``enc_num_layers``, ``recurrent_arch_enc``, ``recurrent_arch_decoder``;
    ``z_activation``), its weights drawn from ``generator``."""
    arch = dict(cfg["autoenc_arch"])
    arch.pop("arch", None)
    return AutoEncoder(
        skeleton.num_nodes,
        generator=generator,
        latent_size=cfg["latent_size"],
        node_types=skeleton.nodes_type_id,
        output_size=cfg.get("output_size", 3),
        z_activation=cfg.get("z_activation", "tanh"),
        loss_pose_type=cfg.get("loss_pose_type", "l1"),
        compute_dtype=compute_dtype(cfg),
        **arch,
    )


def make_train_preprocess(skeleton, loader_cfg: Dict[str, Any]):
    """``(generator, obs, pred) → (x, y, None)``: the training loader's
    on-device preprocess with its augmentations, drawn from ``generator``."""
    return partial(preprocess_batch, skeleton, train=True,
                   da_mirroring=loader_cfg.get("da_mirroring", 0.0),
                   da_rotations=loader_cfg.get("da_rotations", 0.0))


def make_eval_preprocess(skeleton):
    """``(obs, pred) → (x, y, None)``: the validation loaders' preprocess,
    without augmentations (it draws nothing)."""
    return partial(preprocess_batch, skeleton, None, train=False)


def setup_device(cfg: Dict[str, Any]) -> torch.device:
    """The run's device: the override ``device=…`` (default ``cuda``; asking
    for CUDA without a GPU raises).  One device: ``device_mesh.n_devices``
    null or 1."""
    n = (cfg.get("device_mesh") or {}).get("n_devices")
    if n is not None and n > 1:
        raise NotImplementedError(
            f"device_mesh.n_devices={n}: the port runs on one device (ROADMAP Queue A item 6, "
            "torch.distributed)")
    return resolve_device(cfg.get("device", "cuda"))


def load_frozen_autoencoder(cfg: Dict, skeleton, device: torch.device) -> AutoEncoder:
    """The stage-1 AutoEncoder of ``pretrained_autoencoder_path`` (the
    experiment directory, its ``checkpoints`` directory — the best
    checkpoint — or one checkpoint file), on ``device``; reference
    `train_diffusion.py:47-51`, `src/utils/load.py:19-25`.  Only the model is
    read, not the stored optimizer state."""
    path = cfg["pretrained_autoencoder_path"]
    if os.path.isfile(path):
        directory, file = os.path.dirname(path), path
    else:
        directory = os.path.join(path, "checkpoints")
        directory = directory if os.path.isdir(directory) else path
        file = None
    ckpt = CheckpointManager(directory)
    restored = ckpt.restore_partial({"model": None}, file or ckpt.best_path(),
                                    map_location=device)
    model = build_autoencoder(cfg, skeleton, torch.Generator().manual_seed(0))
    model.load_state_dict(restored["model"])
    return model.to(device)


# ---- the training CLIs' run: set-up, epoch loop, validation data, resume ------------


class TrainRun(NamedTuple):
    """What both training CLIs set up before they build their trainer."""
    out_dir: str
    seed: int
    skeleton: Any
    device: torch.device
    dataset: Any
    loader: DataLoader
    iter_per_epoch: int
    check_loss: Callable


def train_loader(cfg: Dict, skeleton, seed: int):
    dataset = build_dataset(cfg, skeleton, "train", "data_loader_train", rng_seed=seed)
    loader = DataLoader(
        dataset, cfg["batch_size"], shuffle=cfg["data_loader_train"].get("shuffle", True),
        drop_last=cfg["data_loader_train"].get("drop_last", True), seed=seed,
    )
    if len(loader) == 0:
        raise ValueError(
            f"train loader yields zero batches: {len(dataset)} segments < batch_size "
            f"{cfg['batch_size']} with drop_last — reduce model.batch_size or enlarge the dataset")
    return dataset, loader


def start_run(cfg: Dict) -> TrainRun:
    """The experiment folder (``config.yaml`` and the code snapshot), the
    debug checks, the seed, the skeleton, the device and the training
    loader."""
    out_dir = cfg["output_log_path"]
    os.makedirs(out_dir, exist_ok=True)
    save_config(cfg, os.path.join(out_dir, "config.yaml"))
    snapshot_code(out_dir)
    check_loss = configure_debug(cfg.get("if_debug_nans", False),
                                 cfg.get("if_enable_checks", False))
    seed = set_seed(cfg["seed"])
    skeleton = build_skeleton(cfg)
    device = setup_device(cfg)
    dataset, loader = train_loader(cfg, skeleton, seed)
    return TrainRun(out_dir, seed, skeleton, device, dataset, loader,
                    cfg.get("num_iter_perepoch") or len(loader), check_loss)


def resume(cfg: Dict, run: TrainRun, ckpt: CheckpointManager, trainer) -> Tuple[int, Optional[int]]:
    """The trainer's state from the checkpoint ``load_path`` (default: the
    latest) and the host state beside it → (first epoch, global step or
    None).  The loader's shuffle and the dataset's jitter RNGs are restored
    too, so a resumed run repeats the uninterrupted one (reference
    `src/utils/reproducibility.py:47-79`)."""
    trainer.load_state_dict(ckpt.restore(cfg.get("load_path") or None, map_location=run.device))
    host = load_host_state(run.out_dir) or {}
    if trainer.lr_scheduler is not None and "lr_scheduler" in host:
        trainer.lr_scheduler.load_state_dict(host["lr_scheduler"])
    if "loader" in host:
        run.loader.load_state_dict(host["loader"])
    if "dataset" in host:
        run.dataset.load_state_dict(host["dataset"])
    # the recomputed (epoch − 1)·iter_per_epoch drifts when an epoch yields
    # fewer batches: trust the checkpointed step counter
    return host.get("epoch", 0) + 1, host.get("global_step")


def host_state(epoch: int, it_global: int, trainer, run: TrainRun) -> Dict:
    host = {"epoch": epoch, "global_step": it_global, "loader": run.loader.state_dict(),
            "dataset": run.dataset.state_dict()}
    if trainer.lr_scheduler is not None:
        host["lr_scheduler"] = trainer.lr_scheduler.state_dict()
    return host


def run_epochs(cfg: Dict, run: TrainRun, trainer, step: Callable, module: nn.Module,
               validate: Callable, *, n_saved: int, save_frequency: Optional[int],
               eval_frequency: int) -> str:
    """The epoch loop of both training CLIs (JAX `cli/train_autoencoder.py`,
    `cli/train_diffusion.py`): ``step((x, y), epoch, it, it_global) → (loss,
    extra records)`` for ``iter_per_epoch`` iterations an epoch, the metrics
    log of ``module``, both validations every ``eval_frequency`` epochs, the
    top-k checkpoints (scored by validation, else every ``save_frequency``
    epochs and the last), the latest checkpoint and the host state every
    epoch.  Returns the experiment's output path."""
    logger = MetricsLogger(run.out_dir)
    preprocess = make_train_preprocess(run.skeleton, cfg["data_loader_train"])
    ckpt = CheckpointManager(os.path.join(run.out_dir, "checkpoints"), n_saved=n_saved)
    start_epoch, resumed_step = 1, None
    if cfg.get("if_resume_training"):
        start_epoch, resumed_step = resume(cfg, run, ckpt, trainer)

    it_global = (resumed_step if resumed_step is not None
                 else (start_epoch - 1) * run.iter_per_epoch)
    eval_datasets = {}  # built once, reused every validation epoch
    for epoch in range(start_epoch, cfg["num_epochs"] + 1):
        trainer.epoch_started(epoch)
        losses = []
        # an epoch is exactly iter_per_epoch iterations (ignite's
        # epoch_length), cycling the loader when a pass is shorter; bounded
        # before the prefetch so that no batch is drawn past the epoch
        batches = prefetch_iterator(cycled_batches(run.loader, run.iter_per_epoch),
                                    device=run.device)
        for it, batch in enumerate(batches):
            # the augmentations draw from stream 0 (the step's own draws
            # from stream 1)
            x, y, _ = preprocess(iteration_generator(run.seed, epoch, it, 0, run.device),
                                 batch["obs"], batch["pred"])
            loss, extra = step((x, y), epoch, it, it_global)
            run.check_loss(loss)
            losses.append(loss)
            # per-iteration loss and lr, parameter and gradient norms
            # (reference `src/utils/tensorboard.py:58-122`)
            if it_global % cfg.get("log_every_iters", 10) == 0:
                logger.log(it_global, {"loss": float(loss), "lr": trainer.current_lr(), **extra,
                                       "epoch": epoch}, prefix="train_iter")
            logger.log_param_norms(it_global, module, grad_norm=trainer.last_grad_norm)
            it_global += 1
        logger.log(epoch, {"loss": float(torch.stack(losses).mean()), "lr": trainer.current_lr(),
                           **extra})
        logger.log_param_histograms(epoch, module)

        # the reference runs both eval engines every eval_frequency epochs:
        # the valid split and a capped pass over the train split
        # (`train_autoencoder.py:108-113`, `train_diffusion.py:113-120`)
        score = None
        if cfg.get("if_run_validation") and epoch % eval_frequency == 0:
            score = -validate(cfg, run.skeleton, trainer, logger, epoch, run.device,
                              dataset_cache=eval_datasets)
            validate(cfg, run.skeleton, trainer, logger, epoch, run.device, split="train",
                     loader_key="data_loader_train_eval",
                     max_batches=cfg.get("num_iteration_eval") or None, prefix="train_eval",
                     dataset_cache=eval_datasets)
        state = trainer.state_dict()
        if (score is not None or epoch == cfg["num_epochs"]
                or (save_frequency and epoch % save_frequency == 0)):
            ckpt.save(state, step=epoch, score=score)
        ckpt.save_latest(state, step=epoch)
        save_host_state(run.out_dir, host_state(epoch, it_global, trainer, run))
    logger.close()
    return run.out_dir


def eval_dataset(cfg: Dict, skeleton, split: str, loader_key: str, dataset_cache):
    """The split's dataset, built once a run (``dataset_cache``)."""
    if loader_key not in cfg:
        loader_key = "data_loader_valid"
    if dataset_cache is not None and (split, loader_key) in dataset_cache:
        return dataset_cache[(split, loader_key)]
    dataset = build_dataset(cfg, skeleton, split, loader_key)
    if dataset_cache is not None:
        dataset_cache[(split, loader_key)] = dataset
    return dataset


def eval_batches(cfg: Dict, skeleton, dataset, device: torch.device, max_batches=None):
    """The split's batches (x, y) in input space on ``device``."""
    loader = DataLoader(dataset, cfg["batch_size_eval"], shuffle=False)
    preprocess = make_eval_preprocess(skeleton)
    for batch in prefetch_iterator(bounded_batches(loader, max_batches), device=device):
        x, y, _ = preprocess(batch["obs"], batch["pred"])
        yield x, y
