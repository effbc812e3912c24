#!/usr/bin/env python3
"""Drive the PyTorch port's fp32 prediction path on one NVIDIA GPU and hold
its hand-written CUDA kernels against their plain PyTorch versions.

    python3 chip_smoke.py        # from the repository root, one CUDA device

Phases, each printed with its elapsed seconds:

1. device  — the card's name and power limit (nvidia-smi);
2. build   — nvcc builds skeletondiffusion_tpu_torch/csrc/*.cu (ptxas report);
3. kernels — the AMASS flagship model at full width (21 nodes, latent and
             hidden 96, denoiser depth 4 × 8 heads × 32, 10 diffusion steps,
             observe 30, predict 120) is built from a seed; each kernel runs on
             inputs of the main path's shapes (batch 256 × 50 samples = 12 800
             rows) and is compared with its plain version and timed;
4. main    — batch 256 × 50 samples through the predictor and the metric-space
             transform: predictions/s, launch counts per prediction, and the
             same prediction with injected noise against the predictor with
             both kernels replaced by their plain versions.

The fp32 path runs with TF32 off for matmuls and cuDNN.  Any failure exits
non-zero; so does a machine without a CUDA device.  The last line of standard
output is ``{"ok": true, "device": {...}}``; the line before it is the card's
name and power limit, and before that one JSON line lists every kernel.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from unittest import mock

import torch

from skeletondiffusion_tpu_torch.diffusion.manager import create_diffusion
from skeletondiffusion_tpu_torch.eval_pipeline import SkeletonDiffusionPredictor
from skeletondiffusion_tpu_torch.models import AutoEncoder
from skeletondiffusion_tpu_torch.ops.graph_linear import l1_normalize_rows
from skeletondiffusion_tpu_torch.ops.kernels import build
from skeletondiffusion_tpu_torch.ops.kernels import gru_rollout as rollout_mod
from skeletondiffusion_tpu_torch.ops.kernels import posterior_step as posterior_mod
from skeletondiffusion_tpu_torch.skeleton import create_skeleton

BATCH, SAMPLES, OBS_LEN, PRED_LEN = 256, 50, 30, 120
LATENT, HIDDEN, TIMESTEPS = 96, 96, 10
ARCH = {"depth": 4, "attn_heads": 8, "attn_dim_head": 32, "learn_influence": True}
SEED = 0
TIMED_CALLS = 3

# Tolerances, max |kernel − plain| on the same inputs.  Both sides are fp32 and
# differ only in the order of their sums: K2 sums 63 products of O(1) terms per
# output (~63·2^-24·|terms| ≲ 1e-5), K1 sums 96- and 21-term dots per step and
# squashes every step through σ/tanh, which keeps the 120-step error at the
# per-step level; the end-to-end comparison adds the denoiser's amplification
# of the K2 differences over 10 steps, then the decode.
K2_TOL = 1e-4
K1_TOL = 1e-4
E2E_TOL = 1e-4

# H100 SXM published peaks (NVIDIA data sheet, at 700 W): fp32 outside the
# tensor cores and HBM3 bandwidth.
PEAK_FP32_FLOP_S = 67e12
PEAK_BYTES_S = 3.35e12


def log(msg: str) -> None:
    print(msg, flush=True)


def phase(name: str, start: float) -> None:
    log(f"[phase] {name}: {time.perf_counter() - start:.3f} s")


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    return out[0].strip()


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean ms per call over ``reps`` back-to-back calls, CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(bytes_moved: float, flops: float):
    t_bytes, t_ops = bytes_moved / PEAK_BYTES_S, flops / PEAK_FP32_FLOP_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def perturb_influence(module: torch.nn.Module, gen: torch.Generator) -> None:
    """A fresh model has G = I and ΔG = 0, which would leave every node mix
    trivial; move them off the identity as training does."""
    with torch.no_grad():
        for name, p in module.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            noise = torch.rand(p.shape, generator=gen, device=gen.device).to(p.device)
            if leaf in ("G", "G0"):
                p.add_(0.2 * noise)
            elif leaf == "G_add":
                p.copy_(0.05 * (noise - 0.5))


def build_model(device: torch.device):
    skeleton = create_skeleton(
        dataset_name="amass", motion_repr_type="SkeletonRescalePose", num_joints=22,
        pose_box_size=1.5, obs_length=OBS_LEN, pred_length=PRED_LEN, if_consider_hip=False,
    )
    gen = torch.Generator().manual_seed(SEED)
    ae = AutoEncoder(skeleton.num_nodes, HIDDEN, HIDDEN, LATENT, gen,
                     node_types=skeleton.nodes_type_id)
    diffusion, denoiser = create_diffusion(
        skeleton, gen, latent_size=LATENT, diffusion_conditioning=True,
        diffusion_timesteps=TIMESTEPS, diffusion_arch=ARCH, device=device,
    )
    perturb_influence(ae, gen)
    perturb_influence(denoiser, gen)
    predictor = SkeletonDiffusionPredictor(
        skeleton, ae, diffusion, num_samples=SAMPLES, pred_length=PRED_LEN, device=device,
    )
    return skeleton, predictor


def check_posterior_step(predictor, gen: torch.Generator) -> dict:
    """K2 at the sampler's shapes [21, 12800, 96], every t of the table."""
    n, rows = predictor.skeleton.num_nodes, BATCH * SAMPLES
    shape = (n, rows, LATENT)
    x0 = 1.5 * torch.randn(shape, generator=gen, device="cuda")  # some |x̂₀| > 1: clip matters
    xt = torch.randn(shape, generator=gen, device="cuda")
    eps = torch.randn(shape, generator=gen, device="cuda")
    tables = predictor.diffusion.step_tables
    err = 0.0
    for t in range(tables.shape[0]):
        got = posterior_mod.posterior_step(x0, xt, eps, tables[t])
        want = posterior_mod.posterior_step_plain(x0, xt, eps, tables[t])
        torch.cuda.synchronize()
        err = max(err, (got - want).abs().max().item())
    m_t = tables[TIMESTEPS // 2]
    ms = cuda_ms(lambda: posterior_mod.posterior_step(x0, xt, eps, m_t), reps=20)
    plain_ms = cuda_ms(lambda: posterior_mod.posterior_step_plain(x0, xt, eps, m_t), reps=20)
    stacked = torch.cat([x0.clamp(-1, 1), xt, eps]).reshape(3 * n, -1)
    library_ms = cuda_ms(lambda: torch.matmul(m_t, stacked), reps=20)
    elems = x0.numel()
    bnd, by = bound_ms(4.0 * (4 * elems + m_t.numel()), 2.0 * n * 3 * n * rows * LATENT)
    log(f"posterior_step: max_abs_err {err:.3e} (tol {K2_TOL:.0e}), {ms:.4f} ms/step, "
        f"plain {plain_ms:.4f} ms, library matmul {library_ms:.4f} ms, "
        f"bound {bnd:.4f} ms ({by})")
    if not err <= K2_TOL:
        raise AssertionError(f"posterior_step kernel disagrees with its plain version: {err}")
    return {"name": "posterior_step", "route": "cuda",
            "source": "skeletondiffusion_tpu_torch/csrc/posterior_step.cu",
            "replaces": "skeletondiffusion_tpu/ops/pallas/posterior_step.py:93",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bnd,
            "bound_by": by, "library_ms": library_ms}


def rollout_inputs(predictor, gen: torch.Generator) -> dict:
    """The decoder's own rollout inputs for 12 800 rows (its hoisted cx, h0,
    gathered banks and normalized influences)."""
    dec = predictor.autoencoder.decoder
    n, rows = predictor.skeleton.num_nodes, BATCH * SAMPLES
    x = 0.3 * torch.randn((rows, 2, n, 3), generator=gen, device="cuda")
    z = torch.tanh(torch.randn((rows, n, LATENT), generator=gen, device="cuda"))
    x_t, x_t_1, z_nm = x[:, -1].transpose(0, 1), x[:, -2].transpose(0, 1), z.transpose(0, 1)
    cell, fc = dec.rollout.cell, dec.rollout.fc
    with torch.no_grad():
        w_hh, b_hh = cell.hidden_banks()
        return dict(
            cx=cell.input_gates(torch.cat([x_t, z_nm], dim=-1)).contiguous(),
            h0=dec.initial_hidden_h(torch.cat([x_t_1, z_nm], dim=-1)).contiguous(),
            w_hh=w_hh, b_hh=b_hh, g0=l1_normalize_rows(dec.G0), g_add=cell.G_add.detach(),
            w_fc=fc.weight[fc.type_index].detach(), b_fc=fc.bias[fc.type_index].detach(),
            g_fc=fc.influence().detach(),
        )


def check_gru_rollout(predictor, gen: torch.Generator) -> dict:
    """K1 at the decode's shapes: cx [21, 12800, 288], 120 steps."""
    inp = rollout_inputs(predictor, gen)
    with torch.no_grad():
        got = rollout_mod.gru_rollout(**inp, ph=PRED_LEN)
        want = rollout_mod.gru_rollout_plain(**inp, ph=PRED_LEN)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        per_step = (got - want).abs().amax(dim=(1, 2, 3))
        ms = cuda_ms(lambda: rollout_mod.gru_rollout(**inp, ph=PRED_LEN), reps=3)
        plain_ms = cuda_ms(lambda: rollout_mod.gru_rollout_plain(**inp, ph=PRED_LEN), reps=2)
    n, rows, h3 = inp["cx"].shape
    h, f = h3 // 3, inp["w_fc"].shape[-1]
    # multiply-adds of the kernel's algorithm per row and step: the per-node
    # h·W_hh, one node mix for each of r and z, two for n, the head and its mix
    flops_row_step = 2 * n * h * 3 * h + 2 * n * n * h * 4 + 2 * n * h * f + 2 * n * n * f
    compulsory = sum(t.numel() for t in inp.values()) + got.numel()
    bnd, by = bound_ms(4.0 * compulsory, float(flops_row_step) * rows * PRED_LEN)
    steps = sorted({0, PRED_LEN // 4, PRED_LEN // 2, PRED_LEN - 1})
    log(f"gru_rollout: max_abs_err {err:.3e} (tol {K1_TOL:.0e}); error at steps "
        f"{[s + 1 for s in steps]}: {[f'{per_step[s].item():.2e}' for s in steps]}; "
        f"{ms:.3f} ms, plain {plain_ms:.3f} ms, bound {bnd:.3f} ms ({by})")
    if not err <= K1_TOL:
        raise AssertionError(f"gru_rollout kernel disagrees with its plain version: {err}")
    return {"name": "gru_rollout", "route": "cuda",
            "source": "skeletondiffusion_tpu_torch/csrc/gru_rollout.cu",
            "replaces": "skeletondiffusion_tpu/ops/pallas/gru_rollout.py:377",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bnd,
            "bound_by": by, "library_ms": None}


def run_main_path(skeleton, predictor, obs: torch.Tensor, card_name: str) -> dict:
    """Timed predictions with launch counts; returns the launches of one call."""
    def predict(seed: int) -> torch.Tensor:
        gen = torch.Generator(device="cuda").manual_seed(seed)
        pred, _ = predictor(gen, obs)
        return skeleton.transform_to_metric_space(pred)

    out = predict(SEED)  # warm-up
    torch.cuda.synchronize()
    times, counts = [], []
    for i in range(TIMED_CALLS):
        rollout_mod.launches = 0
        posterior_mod.launches = 0
        t0 = time.perf_counter()
        out = predict(SEED + 1 + i)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        counts.append({"gru_rollout": rollout_mod.launches,
                       "posterior_step": posterior_mod.launches})
    expected = {"gru_rollout": 1, "posterior_step": TIMESTEPS}
    if any(c != expected for c in counts):
        raise AssertionError(f"launch counts per prediction {counts}, expected {expected}")
    want_shape = (BATCH, SAMPLES, PRED_LEN, skeleton.num_nodes, 3)
    if tuple(out.shape) != want_shape or not bool(torch.isfinite(out).all()):
        raise AssertionError(f"prediction of shape {tuple(out.shape)} (want {want_shape}) "
                             f"or not finite")
    p50 = statistics.median(times)
    log(f"main path: {BATCH / p50:.2f} preds/s (batch {BATCH} × {SAMPLES} samples, median of "
        f"{TIMED_CALLS} calls {[round(t, 4) for t in times]} s) on {card_name}; "
        f"launches per prediction {counts[-1]}")
    return counts[-1]


def compare_with_plain(skeleton, predictor, obs: torch.Tensor, gen: torch.Generator) -> None:
    rows, n = BATCH * SAMPLES, skeleton.num_nodes
    start = torch.randn((rows, n, LATENT), generator=gen, device="cuda")
    steps = torch.randn((rows, TIMESTEPS - 1, n, LATENT), generator=gen, device="cuda")

    def predict(step):
        """Metric-space prediction, and the sampler's state after each step."""
        states = []

        def recording(*args):
            states.append(step(*args))
            return states[-1]

        with mock.patch.object(posterior_mod, "posterior_step", recording):
            pred, _ = predictor(None, obs, start_noise=start, step_noise=steps)
        return skeleton.transform_to_metric_space(pred), torch.stack(states)

    fast, fast_states = predict(posterior_mod.posterior_step)
    with mock.patch.object(rollout_mod, "gru_rollout", rollout_mod.gru_rollout_plain):
        plain, plain_states = predict(posterior_mod.posterior_step_plain)
    torch.cuda.synchronize()
    # The sampler's states carry the O(1) injected noise, and of the two
    # kernels only K2 acts on them; the small random-init predictions depend
    # only weakly on that noise.
    for what, got, want in (("sampler states after each step", fast_states, plain_states),
                            ("prediction, metric space", fast, plain)):
        err = (got - want).abs().max().item()
        log(f"main path with injected noise vs plain kernels: {what}: max_abs_err {err:.3e} "
            f"(tol {E2E_TOL:.0e}, |plain| ≤ {want.abs().max().item():.3f})")
        if not err <= E2E_TOL:
            raise AssertionError(f"end-to-end kernel path disagrees with the plain path in "
                                 f"the {what}: {err}")


def main() -> int:
    t_all = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs a CUDA GPU",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t = time.perf_counter()
    card_name = card()
    device = torch.device("cuda")
    log(f"card: {card_name}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} × {torch.cuda.device_count()}")
    phase("device", t)

    t = time.perf_counter()
    seconds = build.build_all()
    for src in build.sources():
        build.library(src.stem)
        for line in build.ptxas_report(src.stem).splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                log(f"  {src.stem}: {line.strip()}")
    log(f"build: nvcc {seconds:.2f} s into {build.build_dir()}")
    phase("build", t)

    t = time.perf_counter()
    skeleton, predictor = build_model(device)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    kernels = [check_gru_rollout(predictor, gen), check_posterior_step(predictor, gen)]
    phase("kernels", t)

    t = time.perf_counter()
    obs = 0.3 * torch.randn((BATCH, OBS_LEN, skeleton.num_nodes, 3), generator=gen,
                            device="cuda")
    launches = run_main_path(skeleton, predictor, obs, card_name)
    compare_with_plain(skeleton, predictor, obs, gen)
    for k in kernels:
        k["launches"] = launches[k["name"]]
    phase("main", t)

    log(json.dumps({"kernels": kernels}))
    log(f"total: {time.perf_counter() - t_all:.1f} s")
    log(card())
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
