#!/usr/bin/env python
"""Quickstart of the PyTorch port: the WHOLE pipeline end-to-end on
synthetic data, no AMASS download.  The twin of
``examples/quickstart_synthetic.py``: the same steps, arguments, widths
and schedule, on the port's CLIs.

    python examples/torch_quickstart_synthetic.py --out /tmp/skeldiff_quickstart_torch
    python examples/torch_quickstart_synthetic.py --device cpu   # no GPU

Generates a tiny AMASS-format dataset, trains stage 1 (autoencoder, hidden
and latent 16) and stage 2 (latent diffusion, 2 heads × 4), evaluates the
probabilistic metric suite, and exports a serving artifact, then serves
from it: the same flow as the real recipes in README.md, at smoke scale
(0.1 s history / 0.25 s horizon).  On a GPU (the default device; asking for
CUDA without one raises) the decoder's rollout runs its kernel at hidden
16, and the denoiser the kernel chain at its padded widths (F 32 → 64,
heads of 4 → 16; ``SkeletonDiffusionPredictor.use_fused_denoiser``).
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--out", default="/tmp/skeldiff_quickstart_torch")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)

    import numpy as np
    import torch

    from skeletondiffusion_tpu_torch.cli.eval import main as eval_main
    from skeletondiffusion_tpu_torch.cli.train_autoencoder import main as train_ae_main
    from skeletondiffusion_tpu_torch.cli.train_diffusion import main as train_diff_main
    from skeletondiffusion_tpu_torch.data.synthetic import make_synthetic_amass
    from skeletondiffusion_tpu_torch.device import resolve_device

    device = resolve_device(args.device)  # raises for CUDA without a GPU
    ds_root = make_synthetic_amass(args.out)
    print(f"[1/5] synthetic dataset at {ds_root}")

    task = ["task.history_sec=0.1", "task.prediction_horizon_sec=0.25"]
    data = [f"dataset_main_path={ds_root}", f"device={device.type}",
            "dataset.data_loader_train.datasets=[ACCAD, CMU]",
            "dataset.data_loader_train.stride=4"]
    ae_dir = train_ae_main(data + task + [
        f"output_log_path={args.out}/ae",
        "model.num_epochs=2", "model.batch_size=8", "model.num_iter_perepoch=3",
        "model.latent_size=16", "model.autoenc_arch.encoder_hidden_size=16",
        "model.autoenc_arch.decoder_hidden_size=16", "model.save_frequency=2",
    ])
    print(f"[2/5] autoencoder trained -> {ae_dir}")

    diff_dir = train_diff_main(data + [
        f"output_log_path={args.out}/diff",
        f"model.pretrained_autoencoder_path={ae_dir}/checkpoints",
        "model.num_epochs=1", "model.batch_size=8", "model.num_iter_perepoch=3",
        "model.train_pick_best_sample_among_k=3", "model.diffusion_timesteps=4",
        "model.diffusion_arch.depth=1", "model.diffusion_arch.attn_heads=2",
        "model.diffusion_arch.attn_dim_head=4",
    ])
    print(f"[3/5] diffusion trained -> {diff_dir}")

    results = eval_main([
        f"dataset_main_path={ds_root}", "dataset=amass", f"device={device.type}",
        f"checkpoint_path={diff_dir}", "stats_mode=probabilistic",
        "batch_size=56", "num_samples=4", *task,
        f"results_path={args.out}/results.yaml",
    ])
    print(f"[4/5] eval done: ADE={results['ADE']:.4f} APD={results['APD']:.4f}")

    from skeletondiffusion_tpu_torch.inference import InferenceSession
    from skeletondiffusion_tpu_torch.serving import ServingModel, export_predictor

    session = InferenceSession(diff_dir, "amass", num_samples=4, overrides=task,
                               device=device.type)
    predictor = session.predictor
    print(f"      denoiser on the kernel chain: {predictor.use_fused_denoiser} "
          f"({predictor.fused_denoiser_refusal or 'every kernel plans its widths'})")
    artifact = os.path.join(args.out, "artifact")
    export_predictor(predictor, artifact, batch_size=2)
    model = ServingModel(artifact, device=device.type)
    obs = np.random.default_rng(0).standard_normal(
        (2, session.skeleton.obs_length, session.skeleton.num_nodes, 3)
    ).astype(np.float32) * 0.2
    pred = model(torch.Generator(device=device).manual_seed(0), obs)
    print(f"[5/5] serving artifact at {artifact}; served {tuple(pred.shape)}")
    return {"dataset": ds_root, "autoencoder": ae_dir, "diffusion": diff_dir, "results": results,
            "artifact": artifact, "served": pred, "predictor": predictor}


if __name__ == "__main__":
    main()
