#!/usr/bin/env python3
"""Where the bf16 kernel chain's deviation from its plain chain comes from.

The flagship model at full width on each skeleton named (chip_smoke's
``build_model``: latent and hidden 96, depth 4 × 8 heads × 32, 10 steps,
batch 256 × 50 samples, weights from seed 0) predicts with injected noise:

- with every kernel (``kernels``), every plain version (``plain``) and on
  the fp32 path (``fp32``);
- with each kernel of the single-stage bf16 chain in turn swapped for its
  plain version, the others kept (``kernels − <name>``);
- with each kernel kept alone, the others swapped (``plain + <name>``).

For each run: the mean and max |Δ| of the final sampler state and of the
metric-space predictions against the plain chain and against the fp32 path,
and the ratio that chip_smoke's ``hold_bf16`` bounds (mean |run − plain| over
mean |plain − fp32|, which it holds below 1).  The run of the kernels chain
also gives the ratio at each sampler step and the share of the last step's
x̂₀ elements in which it differs from the plain chain, beside the share in
which the plain chain differs from the fp32 path.  Then the plain chain and the
fp32 path started at every step from the kernel chain's state before it
(single-stage and layer-fused): the same readings a step at a time.

    python3 scripts/torch_bf16_chain_split.py [--datasets h36m freeman amass]

Needs one CUDA device.  Prints a line a run, the card's name and power
limit, then one JSON line.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import pathlib
import sys
from unittest import mock

import torch

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke as smoke  # noqa: E402

# the kernels of the single-stage bf16 chain → the patch that swaps each
# for its plain version
SWAPS = {
    "graph_linear_fused": lambda: mock.patch.object(
        smoke.stem_mod, "graph_linear_fused", smoke.stem_mod.graph_linear_fused_plain),
    "resnet_block": lambda: mock.patch.object(
        smoke.block_mod, "resnet_block", smoke.block_mod.resnet_block_plain),
    "rms_qkv": lambda: mock.patch.object(
        smoke.proj_mod, "rms_qkv", smoke.proj_mod.rms_qkv_plain),
    "attention_core": lambda: mock.patch.object(
        smoke.attn_mod, "attention_core", smoke.attn_mod.attention_core_plain),
    "outproj_res": lambda: mock.patch.object(
        smoke.proj_mod, "outproj_res", smoke.proj_mod.outproj_res_plain),
    "final_block_in": lambda: mock.patch.object(
        smoke.block_mod, "final_block_in", smoke.block_mod.final_block_in_plain),
    "final_block_out": lambda: mock.patch.object(
        smoke.block_mod, "final_block_out", smoke.block_mod.final_block_out_plain),
    "posterior_step": lambda: mock.patch.object(
        smoke.posterior_mod, "posterior_step", smoke.posterior_mod.posterior_step_plain),
    "gru_rollout": smoke.plain_rollouts,
}


def run(skeleton, predictor, obs, start, steps, swapped, x0s: list | None = None) -> tuple:
    """(metric-space predictions, sampler states) with the kernels in
    ``swapped`` replaced by their plain versions; each step's x̂₀ is
    appended to ``x0s`` where given."""
    with contextlib.ExitStack() as stack:
        for name in swapped:
            stack.enter_context(SWAPS[name]())
        if x0s is not None:
            step = smoke.posterior_mod.posterior_step

            def keeping(x0, *args):
                x0s.append(x0.float())
                return step(x0, *args)

            stack.enter_context(mock.patch.object(smoke.posterior_mod, "posterior_step", keeping))
        return smoke.injected_run(skeleton, predictor, obs, start, steps, plain=False)


def run_along(skeleton, predictor, obs, start, steps, plain: bool, along: torch.Tensor):
    """``chip_smoke.injected_run`` with each sampler step started from the
    state of ``along`` (another run's states) before it: the states are this
    run's steps from there, and the prediction decodes this run's last step."""
    states = []
    with smoke.plain_kernels() if plain else contextlib.nullcontext():
        step = smoke.posterior_mod.posterior_step

        def forced(*args):
            states.append(step(*args))
            i = len(states) - 1
            return states[i] if i == len(along) - 1 else along[i]

        with mock.patch.object(smoke.posterior_mod, "posterior_step", forced):
            pred, _ = predictor(None, obs, start_noise=start, step_noise=steps)
    return skeleton.transform_to_metric_space(pred), torch.stack(states)


def deviation(a: torch.Tensor, b: torch.Tensor, scale: float = 1.0) -> tuple:
    d = (a.float() - b.float()).abs() * scale
    return d.mean().item(), d.max().item()


def share_differing(a: torch.Tensor, b: torch.Tensor) -> float:
    return (a != b).float().mean().item()


def split(dataset: str, device: torch.device) -> dict:
    skeleton, p32 = smoke.build_model(device, dataset=dataset)
    _, p16 = smoke.build_model(device, torch.bfloat16, dataset=dataset)
    gen = torch.Generator(device="cuda").manual_seed(smoke.SEED)
    n, obs_len = skeleton.num_nodes, smoke.SKELETONS[dataset][1]
    obs = 0.3 * torch.randn((smoke.BATCH, obs_len, n, 3), generator=gen, device="cuda")
    start, steps = smoke.injected_noise(skeleton, gen)
    every = set(SWAPS)
    x0 = {"fp32": [], "plain": [], "kernels": []}
    runs = {"fp32": run(skeleton, p32, obs, start, steps, (), x0["fp32"]),
            "plain": run(skeleton, p16, obs, start, steps, every, x0["plain"]),
            "kernels": run(skeleton, p16, obs, start, steps, (), x0["kernels"])}
    for name in SWAPS:  # the final state only, to keep memory in bounds
        for label, swapped in ((f"kernels − {name}", {name}),
                               (f"plain + {name}", every - {name})):
            pred, states = run(skeleton, p16, obs, start, steps, swapped)
            runs[label] = (pred, states[-1:].clone())
    torch.cuda.synchronize()
    plain, fp32 = runs["plain"], runs["fp32"]
    base = {"state": deviation(plain[1][-1], fp32[1][-1]),
            "prediction_mm": deviation(plain[0], fp32[0], 1e3)}
    print(f"{dataset} ({n} nodes): plain vs fp32: final state mean {base['state'][0]:.4e} max "
          f"{base['state'][1]:.4e}; prediction mean {base['prediction_mm'][0]:.4e} mm max "
          f"{base['prediction_mm'][1]:.4e} mm", flush=True)
    out = {"nodes": n, "plain_vs_fp32": base, "runs": {}}
    for label, (pred, states) in runs.items():
        if label in ("plain", "fp32"):
            continue
        row = {"state_vs_plain": deviation(states[-1], plain[1][-1]),
               "state_vs_fp32": deviation(states[-1], fp32[1][-1]),
               "prediction_vs_plain_mm": deviation(pred, plain[0], 1e3),
               "prediction_vs_fp32_mm": deviation(pred, fp32[0], 1e3)}
        row["state_ratio"] = row["state_vs_plain"][0] / base["state"][0]
        row["prediction_ratio"] = row["prediction_vs_plain_mm"][0] / base["prediction_mm"][0]
        if label == "kernels":
            row["last_x0_share_differing"] = {
                "kernels_vs_plain": share_differing(x0["kernels"][-1], x0["plain"][-1]),
                "plain_vs_fp32": share_differing(x0["plain"][-1], x0["fp32"][-1])}
            row["state_ratio_by_step"] = [
                deviation(states[i], plain[1][i])[0] / deviation(plain[1][i], fp32[1][i])[0]
                for i in range(states.shape[0])]
        out["runs"][label] = row
        print(f"{dataset} {label:>26}: final state vs plain mean {row['state_vs_plain'][0]:.4e} "
              f"(ratio {row['state_ratio']:.3f}), vs fp32 {row['state_vs_fp32'][0]:.4e}; "
              f"prediction vs plain mean {row['prediction_vs_plain_mm'][0]:.4e} mm (ratio "
              f"{row['prediction_ratio']:.3f}), vs fp32 {row['prediction_vs_fp32_mm'][0]:.4e} mm"
              + (f"; ratio by step {[round(r, 3) for r in row['state_ratio_by_step']]}; "
                 f"share of the last step's x̂₀ elements that differ: kernels vs plain "
                 f"{row['last_x0_share_differing']['kernels_vs_plain']:.4f}, plain vs "
                 f"fp32 {row['last_x0_share_differing']['plain_vs_fp32']:.4f}"
                 if label == "kernels" else ""), flush=True)
    out["step_by_step"] = step_by_step(dataset, skeleton, p16, p32, obs, start, steps)
    return out


def step_by_step(dataset, skeleton, p16, p32, obs, start, steps) -> dict:
    """The plain chain and the fp32 path each started at every step from the
    kernel chain's state before it (``run_along``), single-stage
    and layer-fused: each step's deviation without the earlier steps' carried
    along, as hold_bf16 reads it (all steps' states, the predictions)."""
    out = {}
    for path in ("single-stage", "layer-fused"):
        with smoke.layer_fused_path() if path == "layer-fused" else contextlib.nullcontext():
            k = smoke.injected_run(skeleton, p16, obs, start, steps, plain=False)
            p = run_along(skeleton, p16, obs, start, steps, True, k[1])
        f = run_along(skeleton, p32, obs, start, steps, False, k[1])
        torch.cuda.synchronize()
        row = {}
        for what, i, scale in (("states", 1, 1.0), ("prediction_mm", 0, 1e3)):
            kp, pf = deviation(k[i], p[i], scale), deviation(p[i], f[i], scale)
            row[what] = {"kernels_vs_plain": kp, "plain_vs_fp32": pf,
                         "mean_ratio": kp[0] / pf[0], "max_ratio": kp[1] / pf[1]}
        row["state_ratio_by_step"] = [deviation(k[1][j], p[1][j])[0] /
                                      deviation(p[1][j], f[1][j])[0]
                                      for j in range(k[1].shape[0])]
        out[path] = row
        print(f"{dataset} {path} step by step: states mean ratio "
              f"{row['states']['mean_ratio']:.3f} max ratio {row['states']['max_ratio']:.3f}; "
              f"predictions mean ratio {row['prediction_mm']['mean_ratio']:.3f} max ratio "
              f"{row['prediction_mm']['max_ratio']:.3f} (kernels vs plain mean "
              f"{row['prediction_mm']['kernels_vs_plain'][0]:.4e} mm, plain vs fp32 "
              f"{row['prediction_mm']['plain_vs_fp32'][0]:.4e} mm); state ratio by step "
              f"{[round(r, 3) for r in row['state_ratio_by_step']]}", flush=True)
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--datasets", nargs="+", default=["h36m", "freeman", "amass"],
                        choices=sorted(smoke.SKELETONS))
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("torch_bf16_chain_split: needs a CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    counts = sorted({smoke.SKELETONS[d][0] - 1 for d in args.datasets})
    smoke.build.build_all(counts)
    device = torch.device("cuda")
    result = {d: split(d, device) for d in args.datasets}
    print(smoke.card())
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
