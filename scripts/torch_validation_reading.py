#!/usr/bin/env python3
"""Where a trained stage-2 model's validation ADE comes from.

Reads the experiment's best checkpoint (the one the eval CLI reads) and
takes the min-of-``num_prob_samples`` ADE of its EMA weights on the
validation split (``data_loader_valid`` of the stored config: the clips of
its datasets cut at its stride) through each path that can give it:

- ``validate``: the training CLI's own validation
  (``cli/train_diffusion.validate``; the bf16 kernel chain on the EMA
  weights), with the generator of the checkpoint's epoch, so that it repeats
  the ADE the run logged for that epoch (``logged``);
- ``plain_bf16``: the same with every kernel swapped for its plain version
  (``chip_smoke.plain_kernels``);
- ``fp32``: the same weights in an fp32 denoiser;
- ``live``: the live (non-EMA) weights of the checkpoint, on the kernel chain;
- ``eval_cli``: ``cli.eval`` with ``dataset_split=valid`` (its
  ``prepare_model`` and ``compute_metrics``, deterministic stats);

and, to tell the model from the split, the same ADE of the ZeroVelocity
baseline and of the frozen AutoEncoder's own reconstruction (the best the
decoder can do) on the validation split and on the test split (the eval
CLI's ``segments_test.csv`` over ``--test-datasets``), with the eval CLI's
and ``validate``'s readings of the test split beside them; and the share of
the EMA weights that comes from the run's last quarter of steps
(``ema_share``: how far the EMA lags the live weights).

    python3 scripts/torch_validation_reading.py --experiment <stage-2 dir> \\
        [--out reading.json] [--device cuda]

``--device cpu`` runs it on the CPU (small models; the kernels' plain
versions run there, so ``validate`` and ``plain_bf16`` coincide).  Prints a
line a reading, the card's name and power limit, then one JSON line.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import pathlib
import subprocess
import sys
import time

import torch

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))


def ema_share(steps: int, last: int, schedule: dict) -> float:
    """The share of the EMA's weights, after ``steps`` update calls with the
    trainer's ``schedule`` (``ema_kwargs``), that comes from the live
    weights of the last ``last`` calls: each update mixes in (1 − d) of the
    live weights and keeps d of what it had."""
    from skeletondiffusion_tpu_torch.train.ema import ema_decay

    share = 0.0  # of the last `last` calls' live weights in the EMA
    for step in range(steps):
        decay = ema_decay(step, **schedule)
        share = decay * share + (1.0 - decay) * (step >= steps - last)
    return share


def card_line(device: torch.device) -> str:
    if device.type != "cuda":
        return "cpu"
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0].strip()


def trainer_of(cfg: dict, device: torch.device, compute_dtype):
    """The stage-2 trainer the training CLI builds from ``cfg``, its denoiser
    in ``compute_dtype``."""
    from skeletondiffusion_tpu_torch.cli.common import TrainRun, build_skeleton
    from skeletondiffusion_tpu_torch.cli.train_diffusion import build_trainer

    cfg = dict(cfg, compute_dtype=compute_dtype)
    skeleton = build_skeleton(cfg)
    run = TrainRun(out_dir="", seed=cfg["seed"], skeleton=skeleton, device=device, dataset=None,
                   loader=None, iter_per_epoch=1, check_loss=None)
    return build_trainer(cfg, run), skeleton


def ae_ade(cfg, skeleton, autoencoder, dataset, device) -> float:
    """The AutoEncoder's reconstruction ADE (encode the future, decode it
    from the observation), metric space, one sample."""
    from skeletondiffusion_tpu_torch.cli.common import eval_batches
    from skeletondiffusion_tpu_torch.metrics.multimodal import ade

    vals = []
    with torch.no_grad():
        for x, y in eval_batches(cfg, skeleton, dataset, device):
            pred, _, _ = autoencoder.autoencode(y, x, ph=cfg["prediction_horizon_eval"])
            vals.append(ade(skeleton.transform_to_metric_space(y),
                            skeleton.transform_to_metric_space(pred)[:, None]))
    return float(torch.cat(vals).mean())


def eval_cli(experiment: str, stored: dict, device: torch.device, extra: list) -> dict:
    from skeletondiffusion_tpu_torch.cli import eval as eval_mod

    argv = ["dataset=amass", f"checkpoint_path={experiment}", f"device={device.type}",
            f"dataset_main_path={stored['dataset_main_path']}", "device_mesh.n_devices=1",
            f"task.history_sec={stored['obs_length'] / stored['fps']}",
            f"task.prediction_horizon_sec={stored['pred_length'] / stored['fps']}",
            f"num_samples={stored['num_prob_samples']}", f"batch_size={stored['batch_size_eval']}",
            "results_path=" + os.path.join(experiment, "validation_reading_eval.yaml")]
    cwd = os.getcwd()
    os.chdir(REPO)  # the configs/ tree
    try:
        return eval_mod.main(argv + extra)
    finally:
        os.chdir(cwd)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--experiment", required=True, help="a stage-2 experiment directory")
    ap.add_argument("--out", default=None, help="write the JSON here too")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--test-datasets", default="DFaust,GRAB")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("torch_validation_reading: no CUDA device (--device cpu runs on "
                           "the CPU)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    import chip_smoke
    from skeletondiffusion_tpu_torch.cli.common import NullLogger, eval_dataset
    from skeletondiffusion_tpu_torch.cli.train_diffusion import validate
    from skeletondiffusion_tpu_torch.eval_pipeline import ZeroVelocityPredictor, compute_metrics
    from skeletondiffusion_tpu_torch.train.checkpoint import CheckpointManager
    from skeletondiffusion_tpu_torch.utils import yaml_lite

    t0 = time.time()
    experiment = os.path.abspath(args.experiment)
    stored = yaml_lite.read(os.path.join(experiment, "config.yaml"))
    stored["device"] = device.type
    ckpt = CheckpointManager(os.path.join(experiment, "checkpoints"))
    best = ckpt.best_path()
    epoch = int(os.path.basename(best).split("_")[-1].split(".")[0])
    state = ckpt.restore(best, map_location=device)
    logged = {}
    with open(os.path.join(experiment, "metrics.jsonl")) as f:
        for line in f:
            row = json.loads(line)
            if row["prefix"] == "valid" and "ADE" in row:
                logged[row["step"]] = row["ADE"]

    trainer, skeleton = trainer_of(stored, device, stored.get("compute_dtype"))
    trainer.load_state_dict(state)
    trainer32, _ = trainer_of(stored, device, None)
    trainer32.load_state_dict(state)
    cache: dict = {}
    test_datasets = args.test_datasets.split(",")
    # the test split as the eval CLI cuts it: its segment CSV
    test_cfg = dict(stored, data_loader_test=dict(
        stored["data_loader_valid"], datasets=test_datasets,
        segments_path=os.path.join(stored["annotations_folder"], "segments_test.csv")))

    def read(name, fn):
        t = time.time()
        value = fn()
        print(f"{name}: ADE {value:.6f} ({time.time() - t:.1f} s)", flush=True)
        return value

    def val(tr, split="valid", cfg=stored, loader_key="data_loader_valid"):
        return validate(cfg, skeleton, tr, NullLogger(), epoch, device, split=split,
                        loader_key=loader_key, dataset_cache=cache)

    valid = {"logged": logged.get(epoch)}
    valid["validate"] = read("valid, validate (kernel chain, EMA)", lambda: val(trainer))
    with chip_smoke.plain_kernels():
        valid["plain_bf16"] = read("valid, plain bf16 (EMA)", lambda: val(trainer))
    valid["fp32"] = read("valid, fp32 (EMA)", lambda: val(trainer32))

    def live():
        ema, trainer.ema = trainer.ema, None
        try:
            return val(trainer)
        finally:
            trainer.ema = ema

    valid["live"] = read("valid, live weights (kernel chain)", live)
    valid_extra = ["dataset_split=valid", "stats_mode=deterministic",
                   "dataset.data_loader_valid.datasets=[" + ", ".join(
                       stored["data_loader_valid"]["datasets"]) + "]"]
    valid["eval_cli"] = read("valid, eval CLI (EMA)", lambda: eval_cli(
        experiment, stored, device, valid_extra)["ADE"])

    valid_ds = eval_dataset(stored, skeleton, "valid", "data_loader_valid", cache)
    test_ds = eval_dataset(test_cfg, skeleton, "test", "data_loader_test", cache)

    def zero_velocity(dataset):
        zv = ZeroVelocityPredictor(skeleton, num_samples=2, pred_length=stored["pred_length"],
                                   device=device)
        return compute_metrics(zv, dataset, skeleton, batch_size=stored["batch_size_eval"],
                               num_samples=2, stats_mode="deterministic", silent=True)["ADE"]

    valid["zero_velocity"] = read("valid, ZeroVelocity", lambda: zero_velocity(valid_ds))
    valid["autoencoder"] = read("valid, AutoEncoder reconstruction", lambda: ae_ade(
        stored, skeleton, trainer.autoencoder, valid_ds, device))
    test = {}
    test["validate"] = read("test, validate (kernel chain, EMA)", lambda: val(
        trainer, "test", test_cfg, "data_loader_test"))
    test_extra = ["stats_mode=deterministic", "dataset.data_loader_test.datasets=["
                  + ", ".join(test_datasets) + "]"]
    test["eval_cli"] = read("test, eval CLI (EMA)", lambda: eval_cli(
        experiment, stored, device, test_extra)["ADE"])
    test["zero_velocity"] = read("test, ZeroVelocity", lambda: zero_velocity(test_ds))
    test["autoencoder"] = read("test, AutoEncoder reconstruction", lambda: ae_ade(
        stored, skeleton, trainer.autoencoder, test_ds, device))

    ema_steps = trainer.ema.step
    report = {
        "experiment": experiment, "checkpoint": os.path.basename(best), "epoch": epoch,
        "ema_step": ema_steps,
        # how far the EMA lags the live weights: its share from the run's last quarter
        "ema_share_last_quarter": ema_share(ema_steps, ema_steps // 4, trainer.ema_kwargs),
        "segments": {"valid": len(valid_ds), "test": len(test_ds)},
        "valid_datasets": stored["data_loader_valid"]["datasets"],
        "test_datasets": test_datasets,
        "ade": {"valid": valid, "test": test},
        "ratios": {
            "valid_over_test_validate": valid["validate"] / test["validate"],
            "valid_over_test_eval_cli": valid["eval_cli"] / test["eval_cli"],
            "valid_over_test_zero_velocity": valid["zero_velocity"] / test["zero_velocity"],
            "valid_over_test_autoencoder": valid["autoencoder"] / test["autoencoder"],
            "model_over_zero_velocity_valid": valid["validate"] / valid["zero_velocity"],
            "model_over_zero_velocity_test": test["eval_cli"] / test["zero_velocity"],
        },
        "card": card_line(device),
        "seconds": round(time.time() - t0, 1),
    }
    print(report["card"])
    line = json.dumps(report)
    print(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    with contextlib.suppress(BrokenPipeError):
        sys.exit(main())
