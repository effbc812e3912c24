#!/usr/bin/env python3
"""bf16-vs-fp32 metric deltas of the PyTorch port on a converged model.

A twin of ``scripts/bf16_converged_quality.py`` on the port's trained
flagship (``scripts/torch_convergence_capstone.py``;
docs/torch_convergence.json), through the port's CLIs:

1. **Eval dtype** — the capstone's (bf16-trained, flagship) k50_motion
   checkpoint evaluated with ``compute_dtype=null`` and with ``bfloat16``:
   the full probabilistic table's deltas.
2. **Train dtype** — stage 2 retrained (same frozen AE, same seed, same
   schedule) with ``compute_dtype=null``, BOTH checkpoints evaluated in
   fp32, the tables' deltas.

Writes the ``converged`` section of ``docs/torch_bf16_eval_quality.json``
(``--out``), with the card's name and power limit.  Needs a completed
capstone run under ``--root``.

    python3 scripts/torch_convergence_capstone.py …   # first
    python3 scripts/torch_bf16_converged_quality.py [--eval-only]
    python3 scripts/torch_bf16_converged_quality.py --smoke --root …   # CPU, the smoke run's root
"""
from __future__ import annotations

import argparse
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

POSITION_METRICS = ("ADE", "FDE", "MMADE", "MMFDE")  # metres


def delta_table(a, b):
    keys = sorted(set(a) & set(b))
    return {
        k: {
            "abs_delta": round(float(b[k]) - float(a[k]), 8),
            "rel_delta": round((float(b[k]) - float(a[k])) / max(abs(float(a[k])), 1e-12), 6),
        }
        for k in keys
    }


def shapes(smoke: bool) -> dict:
    """The capstone's task lengths, samples, k and device (its ``--smoke``
    ones or the full ones)."""
    if smoke:
        return dict(task=["task.history_sec=0.1", "task.prediction_horizon_sec=0.25"],
                    num_samples=4, k=4, device="cpu")
    return dict(task=["task.history_sec=0.5", "task.prediction_horizon_sec=2.0"],
                num_samples=50, k=50, device="cuda")


def run_eval(root, diff_dir, compute_dtype, tag, run):
    from skeletondiffusion_tpu_torch.cli.eval import main as eval_main
    from skeletondiffusion_tpu_torch.utils import yaml_lite

    res_path = os.path.join(root, "evals", f"results_bf16study_{tag}.yaml")
    if not os.path.exists(res_path):
        eval_main([
            "dataset=amass",
            f"dataset_main_path={root}/datasets",
            "dataset.data_loader_test.datasets=[DFaust, GRAB]",
            "device_mesh.n_devices=1",
            f"device={run['device']}",
            *run["task"],
            f"checkpoint_path={diff_dir}",
            f"compute_dtype={compute_dtype}",
            "stats_mode=probabilistic", "batch_size=256", f"num_samples={run['num_samples']}",
            "seed=0", "if_compute_cmd=True", "if_compute_apde=True",
            f"results_path={res_path}",
        ])
    return yaml_lite.read(res_path)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.join(REPO, "output", "torch_capstone"))
    ap.add_argument("--out", default=os.path.join(REPO, "docs", "torch_bf16_eval_quality.json"))
    ap.add_argument("--eval-only", action="store_true",
                    help="measure only the eval-dtype sensitivity on the capstone "
                         "checkpoint; skip the fp32-trained twin")
    ap.add_argument("--smoke", action="store_true",
                    help="the capstone's --smoke shapes on the CPU")
    args = ap.parse_args(argv)
    import torch

    from scripts.torch_convergence_capstone import card_line

    if not args.smoke and not torch.cuda.is_available():
        raise RuntimeError("torch_bf16_converged_quality: needs a CUDA device (--smoke runs "
                           "on the CPU)")
    run = shapes(args.smoke)
    root = args.root
    os.chdir(REPO)

    bf16_dir = os.path.join(root, "out_diff_k50_motion")
    ae_dir = os.path.join(root, "out_ae")
    assert os.path.exists(os.path.join(bf16_dir, "CAPSTONE_DONE")), (
        "run scripts/torch_convergence_capstone.py to completion first"
    )

    # fp32-trained twin of the flagship stage-2 run (same AE, seed, schedule)
    fp32_dir = os.path.join(root, "out_diff_k50_motion_fp32")
    if not args.eval_only and not os.path.exists(os.path.join(fp32_dir, "DONE")):
        from skeletondiffusion_tpu_torch.cli.train_diffusion import main as diff_main
        from skeletondiffusion_tpu_torch.utils import yaml_lite

        bf16_cfg = yaml_lite.read(os.path.join(bf16_dir, "config.yaml"))
        # the flagship's exact schedule (epochs, per-epoch iteration cap, LR
        # warm-up and decay), so that the ONLY difference is the dtype
        diff_epochs = bf16_cfg["num_epochs"]
        sched = bf16_cfg["lr_scheduler_kwargs"]
        iters = bf16_cfg.get("num_iter_perepoch")
        arch = bf16_cfg["diffusion_arch"]
        print(f"== training fp32 twin ({diff_epochs} epochs) ==", flush=True)
        ckpts = os.path.join(fp32_dir, "checkpoints")
        resume = (["model.if_resume_training=True"]
                  if os.path.isdir(ckpts)
                  and any(d.startswith("latest_") for d in os.listdir(ckpts)) else [])
        diff_main(resume + [
            f"dataset_main_path={root}/datasets",
            "device_mesh.n_devices=1",
            f"device={run['device']}",
            *run["task"],
            f"output_log_path={fp32_dir}",
            f"model.pretrained_autoencoder_path={ae_dir}/checkpoints",
            "model.compute_dtype=null",
            f"model.num_epochs={diff_epochs}",
            f"model.num_iter_perepoch={iters if iters else 'null'}",
            "model.batch_size=64",
            f"model.train_pick_best_sample_among_k={run['k']}",
            "model.similarity_space=input_space",
            "model.if_run_validation=True",
            f"model.eval_frequency={bf16_cfg['eval_frequency']}",
            f"model.lr_scheduler_kwargs.warmup_duration={sched['warmup_duration']}",
            f"model.lr_scheduler_kwargs.update_every={sched['update_every']}",
            f"model.lr_scheduler_kwargs.gamma_decay={sched['gamma_decay']}",
            # the flagship's denoiser (the smoke run's is cut to size)
            f"model.diffusion_arch.depth={arch['depth']}",
            f"model.diffusion_arch.attn_heads={arch['attn_heads']}",
            f"model.diffusion_arch.attn_dim_head={arch['attn_dim_head']}",
            f"model.diffusion_timesteps={bf16_cfg['diffusion_timesteps']}",
        ])
        with open(os.path.join(fp32_dir, "DONE"), "w") as f:
            f.write("ok")

    print("== eval: bf16-trained ckpt, fp32 compute ==", flush=True)
    e_ckptbf16_fp32 = run_eval(root, bf16_dir, "null", "ckptbf16_evalfp32", run)
    print("== eval: bf16-trained ckpt, bf16 compute ==", flush=True)
    e_ckptbf16_bf16 = run_eval(root, bf16_dir, "bfloat16", "ckptbf16_evalbf16", run)
    if args.eval_only:
        e_ckptfp32_fp32, train_deltas = None, None
    else:
        print("== eval: fp32-trained ckpt, fp32 compute ==", flush=True)
        e_ckptfp32_fp32 = run_eval(root, fp32_dir, "null", "ckptfp32_evalfp32", run)
        train_deltas = delta_table(e_ckptfp32_fp32, e_ckptbf16_fp32)

    eval_deltas = delta_table(e_ckptbf16_fp32, e_ckptbf16_bf16)
    converged = {
        "setup": {
            "model": "the PyTorch port's convergence-capstone flagship k50_motion "
                     "(docs/torch_convergence.json)",
            "eval_dtype": "SAME bf16-trained checkpoint eval'd fp32 vs bf16 compute",
            "train_dtype": "fp32- vs bf16-trained stage-2 twins (same frozen AE, "
                           "seed, schedule), both eval'd fp32",
            "smoke": args.smoke,
        },
        "card": card_line(args.smoke),
        "metrics_ckptbf16_evalfp32": {k: float(v) for k, v in sorted(e_ckptbf16_fp32.items())},
        "metrics_ckptbf16_evalbf16": {k: float(v) for k, v in sorted(e_ckptbf16_bf16.items())},
        "eval_dtype_sensitivity": eval_deltas,
        "eval_dtype_max_abs_delta_position_m": max(
            abs(eval_deltas[k]["abs_delta"]) for k in POSITION_METRICS if k in eval_deltas),
    }
    if not args.eval_only:
        converged["metrics_ckptfp32_evalfp32"] = {
            k: float(v) for k, v in sorted(e_ckptfp32_fp32.items())}
        converged["train_dtype_sensitivity"] = train_deltas
        converged["train_dtype_max_abs_delta_position_m"] = max(
            abs(train_deltas[k]["abs_delta"]) for k in POSITION_METRICS if k in train_deltas)
    report = {}
    if os.path.exists(args.out):
        with open(args.out) as f:
            report = json.load(f)
    # --eval-only must not clobber an earlier full run's train-dtype section
    prior = report.get("converged", {})
    if args.eval_only and "train_dtype_sensitivity" in prior:
        for k in ("metrics_ckptfp32_evalfp32", "train_dtype_sensitivity",
                  "train_dtype_max_abs_delta_position_m"):
            converged[k] = prior[k]
    report["converged"] = converged
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=2)
    print(json.dumps(converged["eval_dtype_sensitivity"], indent=2))
    if "train_dtype_sensitivity" in converged:
        print(json.dumps(converged["train_dtype_sensitivity"], indent=2))
    print("position-metric max |delta| (m): eval-dtype",
          converged["eval_dtype_max_abs_delta_position_m"],
          "train-dtype",
          converged.get("train_dtype_max_abs_delta_position_m", "SKIPPED (--eval-only)"))
    print("wrote", args.out)
    return converged


if __name__ == "__main__":
    main()
