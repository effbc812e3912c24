#!/usr/bin/env python
"""Dataset visualization example of the PyTorch port (script form of the
reference's `Visualize Predictions for Dataset Examples AMASS-MANO.ipynb`;
the twin of ``examples/visualize_example.py``): pull a test segment from a
processed dataset, predict S futures, rank them by closeness/diversity
against the ground truth, and render the grid animation (observation plays
first, then GT+closest overlay plus the diverse samples).

    python examples/torch_visualize_example.py --checkpoint <exp_dir> \
        --dataset_main_path <...>/datasets --dataset amass --index 0 \
        --out grid.gif [--device cpu]

``--device`` defaults to cuda; asking for CUDA without a GPU raises.
Rendering needs matplotlib.
"""
import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--dataset_main_path", required=True)
    p.add_argument("--dataset", default="amass")
    p.add_argument("--index", type=int, default=0, help="test segment index")
    p.add_argument("--num-samples", type=int, default=50)
    p.add_argument("--n-diverse", type=int, default=5)
    p.add_argument("--out", default="prediction_grid.gif")
    p.add_argument("--override", action="append", default=[],
                   help="extra config overrides, e.g. task.history_sec=0.1")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)

    import torch

    from skeletondiffusion_tpu_torch.device import resolve_device

    device = resolve_device(args.device).type  # raises for CUDA without a GPU

    from skeletondiffusion_tpu_torch.cli.common import build_dataset
    from skeletondiffusion_tpu_torch.inference import InferenceSession
    from skeletondiffusion_tpu_torch.metrics.ranking import get_closest_and_nfurthest_maxapd
    from skeletondiffusion_tpu_torch.utils.plot import animate_prediction_grid

    session = InferenceSession(
        args.checkpoint, args.dataset, num_samples=args.num_samples,
        overrides=[f"dataset_main_path={args.dataset_main_path}", *args.override],
        device=device,
    )
    sk = session.skeleton
    cfg = session.cfg

    # same per-dataset construction as the eval CLI: folders come resolved
    # from the config tree (h36m lives under Human36M/), and the per-dataset
    # kwargs (H36M subjects, FreeMan annotation files, 3DPW zero-shot) are
    # handled exactly as the eval CLI handles them
    dataset = build_dataset(cfg, sk, "test", "data_loader_test")

    obs_raw, target_raw, extra = dataset[args.index]
    print("segment:", dataset.unique_sample_string(extra))

    generator = torch.Generator(device=session.device).manual_seed(0)
    pred = session.predict(np.asarray(obs_raw), generator)  # [S,T,N,3]
    target = sk.tranform_to_input_space(torch.as_tensor(np.asarray(target_raw)[None]))
    target_m = sk.transform_to_metric_space(target).numpy()[0]
    closest, diverse, idx = get_closest_and_nfurthest_maxapd(
        pred, target_m, args.n_diverse)
    print("closest+diverse sample indices:", idx)

    out = animate_prediction_grid(
        np.asarray(obs_raw), target_m, [np.asarray(closest)] + [np.asarray(d) for d in diverse],
        sk, titles=["closest vs GT"] + [f"diverse {i}" for i in range(len(diverse))],
        out_path=args.out,
    )
    print("saved", out)
    return out


if __name__ == "__main__":
    main()
