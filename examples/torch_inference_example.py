#!/usr/bin/env python
"""Inference example of the PyTorch port (script form of the reference's
`Inference Example.ipynb`; the twin of ``examples/inference_example.py``):
load a trained experiment, predict 50 futures for a raw pose observation,
rank them by closeness/diversity, and render an animation.

    python examples/torch_inference_example.py --checkpoint <exp_dir> --dataset amass
    python examples/torch_inference_example.py --checkpoint <exp_dir> --device cpu

``--device`` defaults to cuda; asking for CUDA without a GPU raises.
"""
import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--checkpoint", required=True, help="experiment dir (config.yaml + checkpoints)")
    p.add_argument("--dataset", default="amass")
    p.add_argument("--num-samples", type=int, default=50)
    p.add_argument("--out", default=None, help="optional .gif output for the animation")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)

    import torch

    from skeletondiffusion_tpu_torch.device import resolve_device

    device = resolve_device(args.device).type  # raises for CUDA without a GPU

    from skeletondiffusion_tpu_torch.inference import InferenceSession

    session = InferenceSession(args.checkpoint, args.dataset, num_samples=args.num_samples,
                               device=device)
    sk = session.skeleton

    # shipped real observation (same demo inputs as the reference notebooks,
    # datasets/examples/README.md); falls back to a toy sequence for configs
    # with no packaged example
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    example_path = os.path.join(
        here, "datasets", "examples", f"example_obs_{args.dataset}.npy"
    )
    if os.path.exists(example_path) and sk.obs_length <= 30:
        # arrays store the full 52-joint SMPL-H set; the body model uses the
        # first `num_joints` (hands are appended after the body joints)
        obs = np.load(example_path)[0, -sk.obs_length:, : sk.num_joints]
        obs = obs.astype(np.float32)
        print(f"using shipped example observation {example_path}")
    else:
        obs = np.random.default_rng(0).standard_normal(
            (sk.obs_length, sk.num_joints, 3)
        ).astype(np.float32) * 0.2

    generator = torch.Generator(device=session.device).manual_seed(0)
    pred = session.predict(obs, generator)  # [S, T, N, 3] metric space
    print("predictions:", pred.shape)

    # closest-to-GT + most diverse samples (here: GT := zero-velocity future)
    fake_future = np.repeat(obs[-1:], sk.pred_length, axis=0)
    closest, diverse, idx = session.rank(pred, fake_future, n_diverse=5)
    print("diverse sample indices:", idx)

    if args.out:
        from skeletondiffusion_tpu_torch.utils.plot import animate_motion

        animate_motion([closest, diverse[0]], sk, titles=["closest", "diverse"],
                       out_path=args.out)
        print("saved", args.out)
    return pred, idx


if __name__ == "__main__":
    main()
