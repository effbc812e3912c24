"""Eval CLI: the probabilistic metric suite over a test split.

    python -m skeletondiffusion_tpu_torch.cli.eval dataset=amass checkpoint_path=<exp_dir> stats_mode=probabilistic

Port of ``skeletondiffusion_tpu/cli/eval.py`` (`:32-228`; reference entry
point `eval.py:128-196`), the method selected by name (`eval.py:154-159`):
SkeletonDiffusion (a trained experiment of the port's training CLIs) or the
ZeroVelocity baseline.  ``device=cpu`` runs it on the CPU.
"""
from __future__ import annotations

import os
import sys
from typing import Dict, List, Optional

import torch

from ..diffusion.manager import create_diffusion
from ..eval_pipeline import SkeletonDiffusionPredictor, ZeroVelocityPredictor, compute_metrics
from ..metrics.fid import ClassifierForFID, port_classifier
from ..metrics.suite import draw_table
from ..train.checkpoint import CheckpointManager
from ..utils import yaml_lite
from ..utils.config import flatten_config, load_config
from ..utils.debug import profile_trace
from ..utils.logging import AverageTimer
from ..utils.store import ResultStorer
from .common import (
    build_dataset,
    build_skeleton,
    diffusion_kwargs,
    load_frozen_autoencoder,
    setup_device,
    setup_mesh,
)


def merge_experiment_cfg(cfg: Dict) -> Dict:
    """The stored experiment config under the eval config: the eval keys
    win, the stored training values fill the rest (reference
    `eval.py:161-166`, `src/utils/config.py:23-31`).  Runs before any
    skeleton, dataset or model is built, so that train-owned task keys
    (pose_box_size, seq_centering, the latent size, the architecture) come
    from the checkpoint and not from the eval tree's defaults."""
    exp_dir = cfg.get("checkpoint_path") or ""
    if not (exp_dir and os.path.isdir(exp_dir)):
        raise ValueError(
            "checkpoint_path must point to a trained experiment directory (containing "
            f"config.yaml + checkpoints/); got {exp_dir!r}. Pass it as: python -m "
            "skeletondiffusion_tpu_torch.cli.eval checkpoint_path=<exp_dir> …")
    merged = dict(yaml_lite.read(os.path.join(exp_dir, "config.yaml")))
    merged.update(cfg)
    return merged


def prepare_model(cfg: Dict, skeleton, device: torch.device) -> SkeletonDiffusionPredictor:
    """The predictor of the experiment's best checkpoint (the EMA weights
    when ``if_use_ema``); reference `src/eval_prepare_model.py:54-85`.
    ``cfg`` holds the stored experiment config (``merge_experiment_cfg``):
    every key of ``DIFFUSION_CFG_KEYS`` (the process, the objective, DDIM's
    ``sampling_timesteps``, ``diffusion_conditioning``) passes through, as in
    the JAX CLI (`cli/eval.py:62-88`).  A bf16 ``compute_dtype`` gives the
    fused kernel chain where the denoiser allows it."""
    autoencoder = load_frozen_autoencoder(cfg, skeleton, device)
    diffusion, denoiser = create_diffusion(skeleton, torch.Generator().manual_seed(0),
                                           latent_size=cfg["latent_size"], device=device,
                                           **diffusion_kwargs(cfg))
    exp_dir = cfg["checkpoint_path"]
    ckpt_dir = os.path.join(exp_dir, "checkpoints_diffusion")
    if not os.path.isdir(ckpt_dir):
        ckpt_dir = os.path.join(exp_dir, "checkpoints")
    ckpt = CheckpointManager(ckpt_dir)
    # sample with the EMA weights (the reference does, `src/core/trainer.py:304-307`)
    if cfg.get("if_use_ema", True):
        weights = ckpt.restore_partial({"ema": {"module": None}}, ckpt.best_path(),
                                       map_location=device)["ema"]["module"]
    else:
        weights = ckpt.restore_partial({"denoiser": None}, ckpt.best_path(),
                                       map_location=device)["denoiser"]
    denoiser.load_state_dict(weights)
    return SkeletonDiffusionPredictor(
        skeleton, autoencoder, diffusion, num_samples=cfg.get("num_samples", 50),
        pred_length=cfg["pred_length"], device=device)


def fid_classifier(cfg: Dict, split: str) -> Optional[ClassifierForFID]:
    """The pretrained H36M classifier when ``if_compute_fid`` asks for FID
    (the H36M test split only; reference `config_metrics.py:59,83-87`)."""
    if not (cfg.get("if_compute_fid") and cfg.get("dataset_name") == "h36m" and split == "test"):
        return None
    path = os.path.join(cfg["precomputed_folder"], "h36m_classifier.pth")
    if not os.path.exists(path):
        print(f"if_compute_fid set but classifier missing at {path}; skipping FID")
        return None
    state = torch.load(path, map_location="cpu")["model"]
    clf = ClassifierForFID()
    clf.load_state_dict(port_classifier({k: v.numpy() for k, v in state.items()}))
    return clf


def device_label(device: torch.device) -> str:
    """``<platform>-<kind>`` of the results folder, as the JAX CLI names it
    from its device (`cli/eval.py:203-205`)."""
    if device.type == "cuda":
        return f"gpu-{torch.cuda.get_device_name(device)}".replace(" ", "_")
    return "cpu-cpu"


def main(argv: Optional[List[str]] = None) -> Dict[str, float]:
    argv = list(sys.argv[1:] if argv is None else argv)
    config_dir = os.environ.get("SKELDIFF_CONFIG_DIR", "configs/config_eval")
    cfg = flatten_config(load_config(config_dir, argv))

    method = cfg.get("method_name", "SkeletonDiffusion")
    if method == "SkeletonDiffusion":
        cfg = merge_experiment_cfg(cfg)
        if cfg.get("compute_dtype") not in (None, "float32"):
            print(
                f"note: network compute_dtype={cfg['compute_dtype']} "
                "(measured metric deltas vs fp32: docs/bf16_eval_quality.json); "
                "for strict fp32 parity pass compute_dtype=null"
            )

    skeleton = build_skeleton(cfg)
    mesh = setup_mesh(cfg)
    device = setup_device(cfg, mesh)
    split = cfg.get("dataset_split", "test")
    loader_key = f"data_loader_{split}"
    if loader_key not in cfg:
        loader_key = "data_loader_test"
    # CMD needs the test split's mean motions and class labels (the
    # reference gates it the same way, `config_metrics.py:86`)
    if_compute_cmd = bool(cfg.get("if_compute_cmd", False)) and split == "test"
    dataset = build_dataset(
        cfg, skeleton, split, loader_key,
        if_long_term_test=cfg.get("if_long_term_test", False),
        long_term_factor=cfg.get("long_term_factor", 2.5),
        if_compute_cmd=if_compute_cmd,
        if_noisy_obs=cfg.get("if_noisy_obs", False),
        noise_level=cfg.get("noise_level", 0.25),
        noise_std=cfg.get("noise_std", 0.02),
    )

    if method == "SkeletonDiffusion":
        predictor = prepare_model(cfg, skeleton, device)
    elif method == "ZeroVelocity":
        predictor = ZeroVelocityPredictor(skeleton, num_samples=cfg.get("num_samples", 50),
                                          pred_length=cfg["pred_length"], device=device)
    else:
        raise NotImplementedError(method)

    timer = AverageTimer() if cfg.get("if_measure_time") else None
    prof_dir = (os.path.join(cfg.get("checkpoint_path") or ".", "profile")
                if cfg.get("if_profile") else None)
    store = (ResultStorer(cfg["store_output_path"], store_gt=cfg.get("if_store_gt", False))
             if cfg.get("if_store_output") else None)
    with profile_trace(prof_dir):
        results = compute_metrics(
            predictor, dataset, skeleton,
            batch_size=cfg["batch_size"],
            num_samples=cfg.get("num_samples", 50),
            stats_mode=cfg.get("stats_mode", "deterministic"),
            seed=cfg.get("seed", 0),
            if_compute_cmd=if_compute_cmd,
            if_compute_apde=cfg.get("if_compute_apde", False),
            mmapd_gt_path=os.path.join(cfg["annotations_folder"], "mmapd_GT.csv")
            if cfg.get("if_compute_apde") else None,
            if_long_term_test=cfg.get("if_long_term_test", False),
            long_term_factor=cfg.get("long_term_factor", 2.5),
            long_term_strategy=cfg.get("long_term_strategy", "best_every50"),
            long_term_refeed_space=cfg.get("long_term_refeed_space", "input"),
            pred_length=cfg.get("pred_length"),
            if_noisy_obs=cfg.get("if_noisy_obs", False),
            noise_level=cfg.get("noise_level", 0.25),
            noise_std=cfg.get("noise_std", 0.02),
            store=store,
            timer=timer,
            ndebug=bool(int(os.environ.get("NDEBUG", "0"))),
            fid_classifier=fid_classifier(cfg, split),
            mesh=mesh,
        )
    if mesh is not None and not mesh.first:
        return results  # every rank holds the table; rank 0 prints and writes it
    if prof_dir is not None:
        print("profiler trace written to", prof_dir)
    print(draw_table(results))
    if timer is not None:
        print("timing:", timer.summary())
    if cfg.get("results_path"):
        out_path = cfg["results_path"]
    else:
        # the reference's eval folder naming (device, seed, long-term and
        # noise labels; `src/eval_prepare_model.py:18-24`)
        lt = f"_longterm{cfg.get('long_term_factor')}" if cfg.get("if_long_term_test") else ""
        nz = (f"_noisyobs{cfg.get('noise_level')}-{cfg.get('noise_std')}"
              if cfg.get("if_noisy_obs") else "")
        out_dir = os.path.join(
            cfg.get("checkpoint_path") or ".",
            f"eval_{cfg['dataset_name']}_{cfg['batch_size']}{lt}{nz}",
            split, f"{device_label(device)}_seed{cfg.get('seed', 0)}",
        )
        os.makedirs(out_dir, exist_ok=True)
        out_path = os.path.join(out_dir, f"results_{cfg.get('stats_mode')}.yaml")
    try:
        yaml_lite.write({k: float(v) for k, v in results.items()}, out_path)
    except OSError as e:
        # the metrics are printed already: losing the YAML must not fail the
        # run, but say so
        print(f"warning: could not write results yaml to {out_path}: {e}")
    return results


if __name__ == "__main__":
    main()
