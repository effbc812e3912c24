#!/usr/bin/env python3
"""Where the time of one fp32 prediction of the PyTorch port goes on the GPU,
at the configuration of ``chip_smoke.py`` (AMASS flagship at full width,
batch 256 × 50 samples, seeded random weights).

    python3 scripts/torch_predict_breakdown.py

Prints the card's name and power limit, CUDA-event times of each layer of
the prediction (past embedding, conditioning product, one denoiser forward,
one posterior step, the whole sampler, the decode, the whole prediction),
the device's busy share over one prediction from ``torch.profiler`` and its
top device kernels, and the rollout kernel's time per block and step at
66, 132 and 1600 blocks.
"""
from __future__ import annotations

import json
import pathlib
import sys

import torch

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke as cs  # noqa: E402
from skeletondiffusion_tpu_torch.ops.kernels import build  # noqa: E402
from skeletondiffusion_tpu_torch.ops.kernels import gru_rollout as rollout_mod  # noqa: E402
from skeletondiffusion_tpu_torch.ops.kernels import posterior_step as posterior_mod  # noqa: E402


def layer_times(predictor, obs: torch.Tensor, gen: torch.Generator) -> dict:
    ae, diff = predictor.autoencoder, predictor.diffusion
    den, S = diff.denoiser, cs.SAMPLES
    rows, t_mid = obs.shape[0] * S, cs.TIMESTEPS // 2
    with torch.no_grad():
        z_past = ae.get_past_embedding(obs)
        x_cond = z_past.repeat_interleave(S, dim=0)
        u = den.cond_embedding(x_cond)
        img = torch.randn((obs.shape[2], rows, cs.LATENT), generator=gen, device="cuda")
        x0 = den(img, t_mid, u)
        latents, _ = diff.sample(x_cond, gen)
        last2 = obs[:, -2:].repeat_interleave(S, dim=0)
        return {
            "past_embedding_ms": cs.cuda_ms(lambda: ae.get_past_embedding(obs), reps=5),
            "cond_embedding_ms": cs.cuda_ms(lambda: den.cond_embedding(x_cond), reps=5),
            "denoiser_forward_ms": cs.cuda_ms(lambda: den(img, t_mid, u), reps=3),
            "posterior_step_ms": cs.cuda_ms(
                lambda: posterior_mod.posterior_step(x0, img, img, diff.step_tables[t_mid]), reps=10),
            "sampler_ms": cs.cuda_ms(
                lambda: diff.sample(x_cond, gen), reps=2),
            "decode_ms": cs.cuda_ms(lambda: ae.decode(last2, latents, cs.PRED_LEN), reps=2),
            "prediction_ms": cs.cuda_ms(lambda: predictor(gen, obs), reps=2),
        }


def profile_prediction(predictor, obs: torch.Tensor, gen: torch.Generator) -> None:
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        predictor(gen, obs)
        end.record()
        torch.cuda.synchronize()
    wall_ms = start.elapsed_time(end)
    events = prof.key_averages()
    # device-side rows only: the operator rows repeat their kernels' time
    busy_ms = sum(e.self_device_time_total for e in events
                  if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
    print(f"profiler: device kernel time {busy_ms:.3f} ms of {wall_ms:.3f} ms between the "
          f"prediction's first and last event (busy share {busy_ms / wall_ms:.4f})")
    print(events.table(sort_by="self_device_time_total", row_limit=15, max_name_column_width=70))


def rollout_scaling(predictor, gen: torch.Generator) -> dict:
    """The rollout kernel's time per step and block at 66 blocks (half the
    132 SMs), 132 blocks (one block on every SM) and the bench batch: if the
    per-block step time grows with the number of busy SMs, a shared
    resource (L2, HBM) limits it; if it stays, each SM's own issue and
    latency do."""
    inp = cs.rollout_inputs(predictor, gen)
    rows_per_block = 8
    out = {}
    with torch.no_grad():
        for blocks in (66, 132, inp["h0"].shape[1] // rows_per_block):
            rows = blocks * rows_per_block
            sub = {k: (v[:, :rows].contiguous() if k in ("cx", "h0") else v)
                   for k, v in inp.items()}
            ms = cs.cuda_ms(lambda: rollout_mod.gru_rollout(**sub, ph=cs.PRED_LEN), reps=3)
            waves = -(-blocks // 132)
            out[blocks] = {"ms": ms, "us_per_block_step": 1e3 * ms / (waves * cs.PRED_LEN)}
            print(f"rollout scaling: {blocks} blocks ({rows} rows): {ms:.3f} ms, "
                  f"{out[blocks]['us_per_block_step']:.2f} µs per block and step")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = cs.card()
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    build.build_all()
    skeleton, predictor = cs.build_model(torch.device("cuda"))
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    obs = 0.3 * torch.randn((cs.BATCH, cs.OBS_LEN, skeleton.num_nodes, 3), generator=gen,
                            device="cuda")
    predictor(gen, obs)  # warm-up
    result = {"card": card, "layers": layer_times(predictor, obs, gen)}
    for key, value in result["layers"].items():
        print(f"{key}: {value:.3f}")
    result["rollout_scaling"] = rollout_scaling(predictor, gen)
    profile_prediction(predictor, obs, gen)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
