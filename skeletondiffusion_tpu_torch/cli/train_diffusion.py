"""Stage-2 CLI: train the latent diffusion (``model=skeleton_diffusion``, the
nonisotropic process, or ``model=isotropic_diffusion``) on a frozen stage-1
AutoEncoder.

    python -m skeletondiffusion_tpu_torch.cli.train_diffusion model.pretrained_autoencoder_path=<ae exp>/checkpoints ...

Port of ``skeletondiffusion_tpu/cli/train_diffusion.py`` (`:45-277`;
reference entry point `train_diffusion.py:26-158`): the epoch loop over
``TrainerDiffusion`` (the frozen-AE embeddings, the k-fold fan-out, the
denoiser, the k-best choice decoded on the rollout kernel, Adam and the EMA),
with the stored AutoEncoder experiment's config inherited.
"""
from __future__ import annotations

import os
import sys
from typing import Dict, List, Optional

import torch

from ..diffusion.manager import create_diffusion
from ..metrics.body_realism import limb_length_variance
from ..metrics.multimodal import ade, apd, mpjpe
from ..train.trainer_diffusion import TrainerDiffusion
from ..utils.config import flatten_config, load_and_merge_autoenc_cfg, load_config
from ..utils.reproducibility import derived_seed, iteration_generator
from .common import (
    TrainRun,
    diffusion_kwargs,
    eval_batches,
    eval_dataset,
    load_frozen_autoencoder,
    run_epochs,
    start_run,
)


def build_trainer(cfg: Dict, run: TrainRun) -> TrainerDiffusion:
    autoencoder = load_frozen_autoencoder(cfg, run.skeleton, run.device)
    diffusion, denoiser = create_diffusion(
        run.skeleton, torch.Generator().manual_seed(derived_seed(run.seed, 1)),
        latent_size=cfg["latent_size"], device=run.device, **diffusion_kwargs(cfg))
    print(f"Denoiser parameters: {sum(p.numel() for p in denoiser.parameters()):,}")
    return TrainerDiffusion(
        diffusion,
        autoencoder,
        lr=cfg["lr"],
        weight_decay=cfg.get("weight_decay", 0.0),
        train_pick_best_sample_among_k=cfg.get("train_pick_best_sample_among_k", 1),
        similarity_space=cfg.get("similarity_space", "latent_space"),
        if_use_ema=cfg.get("if_use_ema", True),
        ema_update_every=cfg.get("ema_update_every", 10),
        ema_decay=cfg.get("ema_decay", 0.995),
        ema_power=cfg.get("ema_power", 2 / 3),
        ema_min_value=cfg.get("ema_min_value", 0.0),
        step_start_ema=cfg.get("step_start_ema", 100),
        use_lr_scheduler=cfg.get("use_lr_scheduler", False),
        lr_scheduler_kwargs=cfg.get("lr_scheduler_kwargs"),
        prediction_horizon_eval=cfg["prediction_horizon_eval"],
        num_prob_samples=cfg.get("num_prob_samples", 50),
        skeleton=run.skeleton,
    )


def train(cfg: Dict) -> str:
    run = start_run(cfg)
    trainer = build_trainer(cfg, run)

    def step(xy, epoch, it, it_global):
        # the step's timesteps and noise draw from stream 1
        return trainer.train_step(xy, iteration_generator(run.seed, epoch, it, 1, run.device)), {}

    return run_epochs(cfg, run, trainer, step, trainer.denoiser, validate, n_saved=10,
                      save_frequency=None, eval_frequency=cfg.get("eval_frequency", 25))


def validate(cfg, skeleton, trainer, logger, epoch, device, split="valid",
             loader_key="data_loader_valid", max_batches=None, prefix="valid",
             dataset_cache=None) -> float:
    """``num_prob_samples`` samples an observation on the EMA weights,
    decoded: APD, ADE, MPJPE and the limb-length variance on a split;
    reference `src/train_utils.py:97-137`.  Returns ADE."""
    dataset = eval_dataset(cfg, skeleton, split, loader_key, dataset_cache)
    vals = {"ADE": [], "APD": [], "MPJPE": [], "LLVar": []}
    for x, y in eval_batches(cfg, skeleton, dataset, device, max_batches):
        generator = torch.Generator(device=device).manual_seed(epoch)
        out, y, _, _ = trainer.validation_step((x, y), generator)
        pred_m = skeleton.transform_to_metric_space(out)
        y_m = skeleton.transform_to_metric_space(y)
        vals["ADE"].append(ade(y_m, pred_m))
        vals["APD"].append(apd(pred_m))
        vals["MPJPE"].append(mpjpe(y_m, pred_m))
        vals["LLVar"].append(torch.atleast_1d(
            limb_length_variance(pred_m, skeleton.get_limbseq(), mode="mean")))
    results = {k: float(torch.cat(v).mean()) for k, v in vals.items()}
    logger.log(epoch, results, prefix=prefix)
    print(f"[epoch {epoch}] {prefix}:", results)
    return results["ADE"]


def main(argv: Optional[List[str]] = None):
    argv = list(sys.argv[1:] if argv is None else argv)
    config_dir = os.environ.get("SKELDIFF_CONFIG_DIR", "configs/config_train_diffusion")
    flat = flatten_config(load_config(config_dir, argv))
    # inherit the AutoEncoder experiment's stored config (reference
    # `train_diffusion.py:134-150`, `src/utils/config.py:14-31`)
    ae_dir = flat["pretrained_autoencoder_path"].rstrip("/")
    ae_cfg_path = os.path.join(os.path.dirname(ae_dir), "config.yaml")
    if not os.path.exists(ae_cfg_path):
        # the path names one checkpoint (<exp>/checkpoints/ckpt_N.pt): the
        # config is two levels up
        ae_cfg_path = os.path.join(os.path.dirname(os.path.dirname(ae_dir)), "config.yaml")
    return train(load_and_merge_autoenc_cfg(flat, os.path.abspath(ae_cfg_path)))


if __name__ == "__main__":
    main()
