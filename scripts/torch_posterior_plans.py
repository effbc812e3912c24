#!/usr/bin/env python3
"""K2, the posterior step, at each node count on one card: the tensor-core
kernel at its plan and at every other plan that fits (warps a block, ring
stages a warp), the CUDA-core design of the same source and
``torch.matmul`` on the stacked inputs, each held against the plain
version (the parent's kernel: ``scripts/torch_kernel_ab.py``).

    python3 scripts/torch_posterior_plans.py [--nodes 21 51]

The libraries are built at every count at once (none that exists already,
as after ``chip_smoke.py`` in the same call).  Inputs:
x̂₀ 1.5·N(0, 1) (fp32 and bf16), x_t and ε N(0, 1), M 0.3·N(0, 1),
[N, rows, 96].  Times are CUDA events over ``--reps`` calls after a
warm-up, in rounds that run the variants forwards and backwards in turn;
each variant's best round is reported.  Prints the card's name and power
limit, then one JSON line; needs one CUDA device.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys

import torch

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from skeletondiffusion_tpu_torch.ops.kernels import build  # noqa: E402
from skeletondiffusion_tpu_torch.ops.kernels import posterior_step as k2  # noqa: E402

D = 96


def cuda_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def plans(n: int, dtype: torch.dtype) -> list:
    """(warps, stages, smem) of every plan that fits, the shipped one first."""
    ship = k2.posterior_plan(n, dtype)
    out = [(ship.warps, ship.stages, ship.smem)]
    for warps in (2, 3, 4, 6, 7, 8):
        for stages in range(1, k2.MAX_STAGES + 1):
            smem = k2.plan_smem(n, dtype, warps, stages)
            if smem <= k2.MAX_SMEM and (warps, stages) != (ship.warps, ship.stages):
                out.append((warps, stages, smem))
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--nodes", type=int, nargs="+", default=[21, 16, 17, 51])
    parser.add_argument("--rows", type=int, default=12_800)
    parser.add_argument("--reps", type=int, default=20)
    parser.add_argument("--rounds", type=int, default=4)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    seconds = build.build_all(args.nodes)
    report = {n: [ln.strip() for ln in build.ptxas_report("posterior_step", n).splitlines()
                  if "registers" in ln or "spill" in ln] for n in args.nodes}
    gen = torch.Generator(device="cuda").manual_seed(0)
    result = {"build_s": seconds, "rows": args.rows, "ptxas": report, "nodes": {}}
    for n in args.nodes:
        shape = (n, args.rows, D)
        x0 = 1.5 * torch.randn(shape, generator=gen, device="cuda")
        xt = torch.randn(shape, generator=gen, device="cuda")
        eps = torch.randn(shape, generator=gen, device="cuda")
        m = 0.3 * torch.randn((n, 3 * n), generator=gen, device="cuda")
        cols = args.rows * D
        per_n = {}
        for label, x in (("fp32", x0), ("bf16", x0.to(torch.bfloat16))):
            want = k2.posterior_step_plain(x, xt, eps, m)
            sym = "posterior_step_x0_bf16" if label == "bf16" else "posterior_step_f32"
            entry = build.c_entry("posterior_step", sym, 5, 5, n)
            variants = {}
            for warps, stages, smem in plans(n, x.dtype):
                def call(w=warps, s=stages, b=smem):
                    out = torch.empty_like(xt)
                    status = entry(x.data_ptr(), xt.data_ptr(), eps.data_ptr(), m.data_ptr(),
                                   out.data_ptr(), n, cols, w, s, b, build.stream_of(xt))
                    build.check_status(f"{sym} {w}×{s}", status)
                    return out
                variants[f"tc_{warps}x{stages}"] = call
            variants["cuda_core"] = lambda x=x: k2.posterior_step_cuda_core(x, xt, eps, m)
            stacked = torch.cat([x.float().clamp(-1, 1), xt, eps]).reshape(3 * n, -1)
            variants["matmul"] = lambda: torch.matmul(m, stacked)
            errs = {}
            for name, fn in variants.items():
                got = fn()
                torch.cuda.synchronize()
                errs[name] = (got.reshape(want.shape) - want).abs().max().item()
            times = {name: [] for name in variants}
            for rnd in range(args.rounds):
                for name in list(variants)[::1 if rnd % 2 else -1]:
                    times[name].append(cuda_ms(variants[name], args.reps))
            per_n[label] = {"max_abs_err": errs, "best_ms": {k: min(v) for k, v in times.items()},
                            "ms": times}
        result["nodes"][n] = per_n
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    print(card)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
