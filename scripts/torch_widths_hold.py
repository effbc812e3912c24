#!/usr/bin/env python3
"""The end-to-end bf16 hold of chip_smoke's ``widths`` phase, split: for
each width of ``chip_smoke.WIDTH_GRID`` named, the bf16 predictor with
injected noise on the kernel chain, on the plain versions, with B2 alone
on its plain version, with B2 alone on its kernel (every other kernel
plain), and the fp32 predictor, on ``--seeds`` noise draws; for each pair
the sampler states' and the metric-space predictions' max and mean
deviation against the plain path's from fp32 (``hold_bf16``'s ratios),
and the held path's own deviation from fp32.  With ``--plant``, on the
first draw, the kernel chain with a planted fault (``FAULTS``) held by
chip_smoke's widths-phase hold (``hold_bf16``, HOLD_WIDTHS): a control of
what that hold catches.

    python3 scripts/torch_widths_hold.py [G5 G6 …] [--seeds 3] [--plant]

One CUDA device (the kernels build at 21 nodes on first use); prints the
card's name and power limit, then a line a width, draw and pair.
"""
from __future__ import annotations

import argparse
import pathlib
import sys
from unittest import mock

import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402


def ratios(runs: dict, held: str, against: str) -> str:
    out = []
    for i, what, scale in ((1, "states", 1.0), (0, "preds", 1e3)):
        a, b, c = runs[held][i], runs[against][i], runs["fp32"][i]
        kp, bf, kf = (a - b).abs() * scale, (b - c).abs() * scale, (a - c).abs() * scale
        out.append(f"{what}: max {kp.max().item():.4e} / {bf.max().item():.4e} = "
                   f"{kp.max().item() / bf.max().item():.3f}, mean ratio "
                   f"{kp.mean().item() / bf.mean().item():.3f}, {held} vs fp32 max "
                   f"{kf.max().item():.4e} mean {kf.mean().item():.4e}, {against} vs fp32 mean "
                   f"{bf.mean().item():.4e}")
    return "; ".join(out)


def scaled(fn, factor: float):
    """``fn`` with its bf16 output multiplied by ``factor``."""
    def wrapped(*args, **kwargs):
        out = fn(*args, **kwargs)
        return (out.float() * factor).to(out.dtype)
    return wrapped


def b2_padded_scale(fn):
    """B2 with the scale of the padded head width (the true dh's is right)."""
    def wrapped(qkv, heads, dim_head):
        return fn(qkv, heads=heads, dim_head=cs.attn_mod.head_width(dim_head))
    return wrapped


def b2_short_k(fn):
    """B2 whose q·k leaves out each head's last 16 columns (one k-step of
    the tensor-core body missed)."""
    def wrapped(qkv, heads, dim_head):
        n, rows, cols = qkv.shape
        q = qkv.clone().reshape(n, rows, 3, heads, -1)
        q[:, :, 0, :, -16:] = 0
        return fn(q.reshape(n, rows, cols), heads=heads, dim_head=dim_head)
    return wrapped


# name → (module, wrapper's name, fault); the padded scale only where the
# chain pads the heads (dh < 16)
FAULTS = {
    "B2 × (1 + 2^-7)": (cs.attn_mod, "attention_core", lambda fn: scaled(fn, 1 + 2 ** -7)),
    "B2 × (1 + 2^-5)": (cs.attn_mod, "attention_core", lambda fn: scaled(fn, 1 + 2 ** -5)),
    "B1 × (1 + 2^-7)": (cs.block_mod, "resnet_block", lambda fn: scaled(fn, 1 + 2 ** -7)),
    "B2 short of its last k-step": (cs.attn_mod, "attention_core", b2_short_k),
    "B2 at the padded width's scale": (cs.attn_mod, "attention_core", b2_padded_scale),
}


def hold_planted(name: str, runs: dict, run, p16) -> None:
    """Each of FAULTS on the kernel chain, held against ``runs``' plain and
    fp32 runs as the widths phase holds the kernel chain."""
    dh = p16.diffusion.denoiser.attn_dim_head
    for fault, (module, attr, plant) in FAULTS.items():
        if fault.endswith("padded width's scale") and cs.attn_mod.head_width(dh) == dh:
            continue
        with mock.patch.object(module, attr, plant(getattr(module, attr))):
            planted = {**runs, "planted": run(p16, False)}
        torch.cuda.synchronize()
        print(f"{name} planted {fault}: {ratios(planted, 'planted', 'plain')}", flush=True)
        try:
            cs.hold_bf16(f"{name} planted {fault}: bf16 path", planted, [("planted", "plain")],
                         hold=cs.HOLD_WIDTHS)
            verdict = "passes (the hold does not see it)"
        except AssertionError:
            verdict = "fails (caught)"
        print(f"{name} planted {fault}: the widths hold {verdict}", flush=True)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("widths", nargs="*", default=["G5", "G6"], choices=list(cs.WIDTH_GRID))
    parser.add_argument("--seeds", type=int, default=3)
    parser.add_argument("--plant", action="store_true",
                        help="on the first draw, also hold the chain with each planted fault")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    print(cs.card(), flush=True)
    device = torch.device("cuda")
    for name in args.widths:
        latent, heads, dh = cs.WIDTH_GRID[name]
        arch = {**cs.ARCH, "attn_heads": heads, "attn_dim_head": dh}
        skeleton, p16 = cs.build_model(device, torch.bfloat16, latent=latent, diffusion_arch=arch)
        _, p32 = cs.build_model(device, latent=latent, diffusion_arch=arch)
        for seed in range(args.seeds):
            gen = torch.Generator(device="cuda").manual_seed(cs.SEED + 27 + seed)
            obs = 0.3 * torch.randn((cs.BATCH, cs.OBS_LEN, skeleton.num_nodes, 3), generator=gen,
                                    device="cuda")
            start, steps = cs.injected_noise(skeleton, gen, latent)
            run = lambda predictor, plain: cs.injected_run(  # noqa: E731
                skeleton, predictor, obs, start, steps, plain=plain)
            runs = {"kernels": run(p16, False), "plain": run(p16, True), "fp32": run(p32, False)}
            b2 = cs.attn_mod.attention_core
            with cs.plain_kernels(), mock.patch.object(cs.attn_mod, "attention_core", b2):
                runs["plain, B2 kernel"] = run(p16, False)
            with mock.patch.object(cs.attn_mod, "attention_core", cs.attn_mod.attention_core_plain):
                runs["kernels, B2 plain"] = run(p16, False)
            torch.cuda.synchronize()
            for held in ("kernels", "plain, B2 kernel", "kernels, B2 plain"):
                print(f"{name} seed {seed}: {held} vs plain {ratios(runs, held, 'plain')}",
                      flush=True)
            if args.plant and seed == 0:
                hold_planted(name, runs, run, p16)
    return 0


if __name__ == "__main__":
    sys.exit(main())
