#!/usr/bin/env python3
"""Decode-rollout bf16 (merged-gate) check of the PyTorch port: the
metric-space deviation (mm) and the speed of
``decode_rollout(compute_dtype=torch.bfloat16)`` (the merged-gate rollout
kernel, ``csrc/gru_rollout_merged.cu``) against the fp32 decode (the fp32
rollout kernel, ``csrc/gru_rollout.cu``), the twin of
``scripts/decode_bf16_check.py``: the same model (AMASS-22, 21 nodes,
encoder and decoder hidden 96, latent 96, weights from a seed by the port's
own init), the same inputs (last two poses 0.2·N(0,1), latents N(0,1)), the
same shapes (12 800 rows, 120 steps) and the same JSON keys, plus the device.

    python3 scripts/torch_decode_bf16_check.py                  # on the GPU
    python3 scripts/torch_decode_bf16_check.py --device cpu --batch 16 --ph 5

Each decode is timed as the JAX script times it: 4 calls with the latents
varied each call, the minimum kept; on the GPU each call is bracketed by CUDA
events and synchronised.  On the CPU both decodes run the plain PyTorch
versions of the kernels, and the times are the CPU's.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

import torch

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from skeletondiffusion_tpu_torch.device import resolve_device  # noqa: E402
from skeletondiffusion_tpu_torch.models import AutoEncoder  # noqa: E402
from skeletondiffusion_tpu_torch.ops.kernels.gru_rollout import decode_rollout  # noqa: E402
from skeletondiffusion_tpu_torch.skeleton import create_skeleton  # noqa: E402

OBS, PH, LAT, HIDDEN, B = 30, 120, 96, 96, 12800
TIMED_CALLS = 4
WEIGHT_SEED, INPUT_SEED = 0, 1


def build(device: torch.device):
    """(skeleton, AutoEncoder) of the decode check, weights from ``WEIGHT_SEED``."""
    skeleton = create_skeleton(
        dataset_name="amass", motion_repr_type="SkeletonRescalePose", num_joints=22,
        pose_box_size=1.5, obs_length=OBS, pred_length=PH, if_consider_hip=False,
    )
    ae = AutoEncoder(skeleton.num_nodes, HIDDEN, HIDDEN, LAT,
                     torch.Generator().manual_seed(WEIGHT_SEED), node_types=skeleton.nodes_type_id)
    return skeleton, ae.to(device)


def inputs(n: int, batch: int, device: torch.device):
    """(x_last2 [B, 2, N, 3], z [B, N, L]) from ``INPUT_SEED``: a plausible
    pose scale and unit-normal latents."""
    gen = torch.Generator(device=device).manual_seed(INPUT_SEED)
    x_last2 = 0.2 * torch.randn((batch, 2, n, 3), generator=gen, device=device)
    z = torch.randn((batch, n, LAT), generator=gen, device=device)
    return x_last2, z


def decode(decoder, x_last2, z, ph: int, compute_dtype=None) -> torch.Tensor:
    with torch.no_grad():
        return decode_rollout(decoder, x_last2, z, ph, compute_dtype=compute_dtype)


def deviation_mm(skeleton, fp32: torch.Tensor, bf16: torch.Tensor) -> torch.Tensor:
    """Per-joint metric-space distance in mm, [B, ph, N]."""
    m32 = skeleton.transform_to_metric_space(fp32)
    m16 = skeleton.transform_to_metric_space(bf16)
    return torch.linalg.vector_norm(m32 - m16, dim=-1) * 1000.0


def min_seconds(fn, z: torch.Tensor) -> float:
    """The fastest of ``TIMED_CALLS`` calls of ``fn(z_i)``, z varied each call."""
    per = []
    for i in range(TIMED_CALLS):
        zi = z + (i + 1) * 1e-6
        if z.is_cuda:
            torch.cuda.synchronize()
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            fn(zi)
            end.record()
            torch.cuda.synchronize()
            per.append(start.elapsed_time(end) / 1e3)
        else:
            t0 = time.perf_counter()
            fn(zi)
            per.append(time.perf_counter() - t0)
    return min(per)


def setup(batch: int = B, device="cuda"):
    """(skeleton, decoder, x_last2, z) of the check."""
    device = resolve_device(device)
    skeleton, ae = build(device)
    return (skeleton, ae.decoder, *inputs(skeleton.num_nodes, batch, device))


def decode_deviation(skeleton, decoder, x_last2, z, ph: int) -> torch.Tensor:
    """One fp32 and one bf16 decode; their metric-space distance [B, ph, N] in mm."""
    return deviation_mm(skeleton, decode(decoder, x_last2, z, ph),
                        decode(decoder, x_last2, z, ph, torch.bfloat16))


def run(batch: int = B, ph: int = PH, device="cuda") -> dict:
    """The check's JSON: deviation of one decode each, then ``TIMED_CALLS``
    timed calls of each."""
    skeleton, dec, x_last2, z = setup(batch, device)
    d = decode_deviation(skeleton, dec, x_last2, z, ph)
    per_step = d.mean(dim=(0, 2))
    times = {dt: min_seconds(lambda zi, dt=dt: decode(dec, x_last2, zi, ph, dt), z)
             for dt in (None, torch.bfloat16)}
    return {
        "batch": batch, "ph": ph,
        "mm_mean": d.mean().item(),
        "mm_max": d.max().item(),
        "mm_mean_step0": per_step[0].item(),
        f"mm_mean_step{ph - 1}": per_step[-1].item(),
        "fp32_s": times[None],
        "bf16_s": times[torch.bfloat16],
        "speedup": times[None] / times[torch.bfloat16],
        "device": torch.cuda.get_device_name(z.device) if z.is_cuda else "cpu",
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--batch", type=int, default=B)
    ap.add_argument("--ph", type=int, default=PH)
    args = ap.parse_args(argv)
    if args.device == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    print(json.dumps(run(args.batch, args.ph, args.device), indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
