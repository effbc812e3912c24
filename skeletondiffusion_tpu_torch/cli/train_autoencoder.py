"""Stage-1 CLI: train the graph-recurrent AutoEncoder.

    python -m skeletondiffusion_tpu_torch.cli.train_autoencoder dataset=amass model.num_epochs=200 ...

Port of ``skeletondiffusion_tpu/cli/train_autoencoder.py`` (`:36-242`;
reference entry point `train_autoencoder.py:26-143`): the epoch loop over
``AutoEncoderTrainer`` with the JSONL metrics log, validation, top-k
checkpoints and a bit-faithful resume.  ``device=cpu`` runs it on the CPU.
"""
from __future__ import annotations

import os
import sys
from typing import Dict, List, Optional

import torch

from ..metrics.multimodal import ade, fde, mpjpe
from ..train.trainer_autoencoder import AutoEncoderTrainer
from ..utils.config import flatten_config, load_config
from ..utils.reproducibility import derived_seed
from .common import build_autoencoder, eval_batches, eval_dataset, run_epochs, start_run


def train(cfg: Dict) -> str:
    """Returns the experiment's output path."""
    run = start_run(cfg)
    model = build_autoencoder(cfg, run.skeleton,
                              torch.Generator().manual_seed(derived_seed(run.seed, 0)))
    trainer = AutoEncoderTrainer(
        model=model.to(run.device),
        lr=cfg["lr"],
        iter_per_epoch=run.iter_per_epoch,
        prediction_horizon_train=cfg["prediction_horizon_train"],
        prediction_horizon_eval=cfg["prediction_horizon_eval"],
        curriculum_it=cfg.get("curriculum_it", 0),
        use_lr_scheduler=cfg.get("use_lr_scheduler", False),
        lr_scheduler_kwargs=cfg.get("lr_scheduler_kwargs"),
        prediction_horizon_train_min=cfg.get("prediction_horizon_train_min", 10),
        prediction_horizon_train_min_from_epoch=cfg.get("prediction_horizon_train_min_from_epoch", 200),
        random_prediction_horizon=cfg.get("random_prediction_horizon", True),
        loss_pose_type=cfg.get("loss_pose_type", "l1"),
        seed=run.seed,
    )
    print(f"AutoEncoder parameters: {sum(p.numel() for p in model.parameters()):,}")

    def step(xy, epoch, it, it_global):
        loss, ph = trainer.train_step(xy, epoch=epoch, iteration=it_global)
        return loss, {"ph": ph}

    save_frequency = cfg.get("save_frequency", 50)
    return run_epochs(cfg, run, trainer, step, trainer.model, validate, n_saved=20,
                      save_frequency=save_frequency,
                      eval_frequency=cfg.get("eval_frequency", save_frequency))


def validate(cfg, skeleton, trainer, logger, epoch, device, split="valid",
             loader_key="data_loader_valid", max_batches=None, prefix="valid",
             dataset_cache=None) -> float:
    """ADE, FDE and MPJPE on a split (metric space, one sample); reference
    `src/train_utils.py:56-96`.  Returns MPJPE."""
    dataset = eval_dataset(cfg, skeleton, split, loader_key, dataset_cache)
    vals = {"ADE": [], "FDE": [], "MPJPE": []}
    for x, y in eval_batches(cfg, skeleton, dataset, device, max_batches):
        pred, y, _, _ = trainer.validation_step((x, y))
        pred_m = skeleton.transform_to_metric_space(pred)[:, None]
        y_m = skeleton.transform_to_metric_space(y)
        vals["ADE"].append(ade(y_m, pred_m))
        vals["FDE"].append(fde(y_m, pred_m))
        vals["MPJPE"].append(mpjpe(y_m, pred_m))
    results = {k: float(torch.cat(v).mean()) for k, v in vals.items()}
    logger.log(epoch, results, prefix=prefix)
    print(f"[epoch {epoch}] {prefix}:", results)
    return results["MPJPE"]


def main(argv: Optional[List[str]] = None):
    argv = list(sys.argv[1:] if argv is None else argv)
    config_dir = os.environ.get("SKELDIFF_CONFIG_DIR", "configs/config_train_autoencoder")
    return train(flatten_config(load_config(config_dir, argv)))


if __name__ == "__main__":
    main()
