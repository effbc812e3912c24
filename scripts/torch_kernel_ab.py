#!/usr/bin/env python3
"""A/B of every kernel of the port built from this tree's sources against the
same kernels built from another checkout's (the parent commit's), at the
bench shapes, in one process on one card.

    git archive <parent> | tar -x -C output/parent      # a directory git ignores
    python3 scripts/torch_kernel_ab.py --parent output/parent

Both trees' ``skeletondiffusion_tpu_torch/csrc/*.cu`` are built with the
port's nvcc flags (this tree's into the usual build directory, the other's
into ``build/kernel_ab/parent/``, at once).  Each kernel is called through
this tree's wrappers with one tree's libraries, then the other's, on random
inputs from a seed (21 nodes, 12 800 rows, D 96, F 192, 8 heads × 32; the
rollouts 120 steps), both trees' libraries built at 21 nodes.  A kernel
whose C entry changed between the trees needs a call through the other
tree's own C signature here.  Times are CUDA events over
``reps`` calls after a warm-up, in rounds ordered parent, new, new, parent,
…; the card's name and power limit, then one JSON line: ms per kernel, side
and round, the best of each side, and new / parent of the best.  Needs one
CUDA device.
"""
from __future__ import annotations

import argparse
import ctypes
import functools
import json
import pathlib
import subprocess
import sys

import torch

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from skeletondiffusion_tpu_torch.ops.kernels import (  # noqa: E402
    attention_core_fm, attention_proj, build, graph_linear_fused, gru_rollout, joint_attention,
    layer_fused, posterior_step, resnet_block)

N, H, DH, B, D, F, PH = 21, 8, 32, 12800, 96, 192, 120
HD = H * DH
OUT = REPO / "build" / "kernel_ab"


def build_parent(parent: pathlib.Path) -> dict:
    """{library: CDLL} of the other tree, built beside this tree's."""
    csrc = parent / "skeletondiffusion_tpu_torch" / "csrc"
    srcs = sorted(csrc.glob("*.cu"))
    if not srcs:
        raise SystemExit(f"no kernel sources under {csrc}")
    build.compile_sources(srcs, OUT / "parent")
    return {s.stem: ctypes.CDLL(str(OUT / "parent" / f"lib{s.stem}.so")) for s in srcs}


def use(libraries: dict) -> None:
    build._libraries.clear()
    build._libraries.update({(name, build.DEFAULT_NODES): lib for name, lib in libraries.items()})
    build.c_entry.cache_clear()


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


def kernels() -> dict:
    """name → (reps, the wrapper's call, made with whichever tree's
    libraries are in use)."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    bf = torch.bfloat16

    def rnd(*shape, scale=1.0, dtype=bf):
        return (scale * torch.randn(shape, generator=gen, device="cuda")).to(dtype)

    def infl(dtype=bf):
        g = torch.eye(N, device="cuda") + 0.2 * torch.rand((N, N), generator=gen, device="cuda")
        return (g / g.sum(dim=1, keepdim=True)).to(dtype)

    bank = lambda k, o: rnd(N, k, o, scale=k ** -0.5)  # noqa: E731
    bias = lambda o: rnd(N, o, scale=0.1)  # noqa: E731
    x_lat, u = rnd(N, B, D), rnd(N, B, F, scale=0.5)
    x, r, a = rnd(N, B, F, scale=0.5), rnd(N, B, F, scale=0.5), rnd(N, B, HD, scale=0.5)
    film = rnd(2 * F, scale=0.3)
    ws, bs, gs = bank(D, F), bias(F), infl()
    blk = (bank(F, F), bias(F), infl(), bank(F, F), bias(F), infl())
    g_rms = ((1 + 0.1 * torch.randn(F, generator=gen, device="cuda")) * F ** 0.5).to(bf)
    w_qkv, g_qkv, w_out, g_out = bank(F, 3 * HD), infl(), bank(HD, F), infl()
    qkv = rnd(N, B, 3 * HD)
    w1f, b1f, g1f, wr, gr = bank(2 * F, F), bias(F), infl(), bank(2 * F, F), infl()
    wh, bh, gh = bank(F, D), bias(D), infl()
    x0, xt, eps = rnd(N, B, D), rnd(N, B, D, dtype=torch.float32), rnd(N, B, D, dtype=torch.float32)
    m = 0.3 * torch.randn((N, 3 * N), generator=gen, device="cuda")
    qkv_fm = qkv.permute(0, 2, 1).contiguous()
    roll = dict(h0=rnd(N, B, D, scale=0.5, dtype=torch.float32), b_hh=bias(3 * D).float(),
                g0=infl(torch.float32), g_add=0.01 * infl(torch.float32), b_fc=bias(3).float(),
                g_fc=infl(torch.float32))
    cx, w_hh, w_fc = rnd(N, B, 3 * D, scale=0.5), bank(D, 3 * D), bank(D, 3)
    return {
        "graph_linear_fused": (20, lambda: graph_linear_fused.graph_linear_fused(
            x_lat, ws, bs, gs, u)),
        "resnet_block": (20, lambda: resnet_block.resnet_block(x, film, *blk)),
        "rms_qkv": (20, lambda: attention_proj.rms_qkv(x, g_rms, w_qkv, g_qkv)),
        "attention_core": (20, lambda: joint_attention.attention_core(qkv, heads=H, dim_head=DH)),
        "outproj_res": (20, lambda: attention_proj.outproj_res(a, x, w_out, g_out)),
        "final_block_in": (20, lambda: resnet_block.final_block_in(x, r, film, w1f, b1f, g1f,
                                                                   wr, gr)),
        "final_block_out": (20, lambda: resnet_block.final_block_out(x, r, *blk[3:], wh, bh, gh)),
        "posterior_step_x0_bf16": (20, lambda: posterior_step.posterior_step(x0, xt, eps, m)),
        "stem_block": (20, lambda: layer_fused.stem_block(x_lat, u, film, ws, bs, gs, *blk)),
        "rms_qkv_core": (20, lambda: layer_fused.rms_qkv_core(x, g_rms, w_qkv, g_qkv, heads=H,
                                                              dim_head=DH)),
        "outproj_block": (20, lambda: layer_fused.outproj_block(a, x, film, w_out, g_out, *blk)),
        "attention_core_fm": (20, lambda: attention_core_fm.attention_core_fm(
            qkv_fm, heads=H, dim_head=DH)),
        "gru_rollout": (2, functools.partial(gru_rollout.gru_rollout, cx.float(), w_hh=w_hh.float(),
                                             w_fc=w_fc.float(), ph=PH, **roll)),
        "gru_rollout_bf16": (2, functools.partial(gru_rollout.gru_rollout, cx, w_hh=w_hh,
                                                  w_fc=w_fc, ph=PH, compute_dtype=bf, **roll)),
    }


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--parent", type=pathlib.Path, required=True,
                        help="root of the other checkout (its skeletondiffusion_tpu_torch/csrc)")
    parser.add_argument("--rounds", type=int, default=4)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    build.build_all()
    new = {s.stem: build.library(s.stem) for s in build.sources()}
    parent = build_parent(args.parent.resolve())
    calls = kernels()
    times = {k: {"parent": [], "new": []} for k in calls}
    order = ["parent", "new", "new", "parent"]
    with torch.no_grad():
        for rnd_ in range(args.rounds):
            side = order[rnd_ % 4]
            use(new if side == "new" else parent)
            for name, (reps, fn) in calls.items():
                times[name][side].append(cuda_ms(fn, reps))
    best = {k: {s: min(v) for s, v in t.items() if v} for k, t in times.items()}
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    print(card)
    print(json.dumps({"ms": times, "best_ms": best,
                      "new_over_parent": {k: b["new"] / b["parent"] for k, b in best.items()
                                          if "new" in b and "parent" in b}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
