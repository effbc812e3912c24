#!/usr/bin/env python
"""Serving example of the PyTorch port (the twin of
``examples/serving_example.py``): export a trained experiment to a
self-contained artifact (``torch.export`` programs with the weights baked
in, every kernel a ``skd::`` op), then serve predictions from the artifact
alone — no model-construction code on the serving host.

    # offline, once (on the device that will serve):
    python examples/torch_serving_example.py export --checkpoint <exp_dir> \
        --artifact artifact/ --batch-size 256
    # on the server:
    python examples/torch_serving_example.py serve --artifact artifact/

``--device`` defaults to cuda (asking for CUDA without a GPU raises); an
artifact serves on the device it was exported on.
"""
import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("mode", choices=("export", "serve"))
    p.add_argument("--artifact", required=True)
    p.add_argument("--checkpoint", help="experiment dir (export mode)")
    p.add_argument("--dataset", default="amass")
    p.add_argument("--batch-size", type=int, default=256)
    p.add_argument("--num-samples", type=int, default=50)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)

    import torch

    from skeletondiffusion_tpu_torch.device import resolve_device

    device = resolve_device(args.device).type  # raises for CUDA without a GPU

    if args.mode == "export":
        from skeletondiffusion_tpu_torch.inference import InferenceSession
        from skeletondiffusion_tpu_torch.serving import export_predictor

        session = InferenceSession(args.checkpoint, args.dataset,
                                   num_samples=args.num_samples, device=device)
        export_predictor(session.predictor, args.artifact,
                         batch_size=args.batch_size)
        print(f"exported {args.artifact} (batch {args.batch_size}, "
              f"{args.num_samples} samples)")
        return None

    from skeletondiffusion_tpu_torch.serving import ServingModel

    model = ServingModel(args.artifact, device=device)
    B, (T, J, _) = model.batch_size, model.manifest["obs_tail_shape"]
    # toy input-space observation: in practice transform raw poses with the
    # skeleton's transform (see examples/torch_inference_example.py)
    obs = np.random.default_rng(0).standard_normal((B, T, J, 3)).astype(np.float32) * 0.2
    pred = model(torch.Generator(device=model.device).manual_seed(0), obs)
    print(f"served predictions: {tuple(pred.shape)} "
          f"({model.num_samples} futures per observation)")
    return pred


if __name__ == "__main__":
    main()
