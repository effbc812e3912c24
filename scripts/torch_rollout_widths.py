#!/usr/bin/env python3
"""K1, the fp32 decode rollout (``csrc/gru_rollout.cu``), at every hidden
width it is built for, on one card:

1. each (nodes, hidden) pair of ``PAIRS`` built with ``-DSKD_HIDDEN`` and
   held against its plain version at 12 800, 12 795 and an odd-tile row
   count, 120 steps (``chip_smoke.check_rollout_width``: ms, plain ms,
   bound);
2. with ``--parent DIR`` (a checkout's root, e.g. ``git archive <parent> |
   tar -x -C DIR``), hidden 96 at 21 nodes timed against the parent's build
   of the source in turns, outputs compared bit for bit;
3. ``--reps`` launches of each pair against the plain version, counting the
   launches that disagree and where the first one goes wrong (step, node,
   rows): a race shows here as a few rows of one block off from one step.

    python3 scripts/torch_rollout_widths.py [--parent DIR] [--reps 12]

Prints the card's name and power limit and one JSON line of the sweep.
Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import sys

import torch

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke as cs  # noqa: E402
from skeletondiffusion_tpu_torch.ops.kernels import build  # noqa: E402
from skeletondiffusion_tpu_torch.ops.kernels import gru_rollout as rollout  # noqa: E402

PAIRS = [(21, h) for h in range(16, 129, 16)] + [(16, 48), (17, 80), (17, 128), (51, 16),
                                                 (51, 112), (51, 128)]
ROWS, PH = 12_800, 120


def against_parent(parent: pathlib.Path, gen: torch.Generator) -> dict:
    """ms a call of this tree's and the parent's hidden-96 build at 21
    nodes, in turns (parent, new, new, parent, …), and their max |Δ|."""
    src = parent / "skeletondiffusion_tpu_torch" / "csrc" / "gru_rollout.cu"
    out = REPO / "build" / "rollout_widths_parent"
    build.compile_jobs([(src, out, 21)])
    libs = {"new": build.library("gru_rollout", 21),
            "parent": ctypes.CDLL(str(out / "libgru_rollout.so"))}
    inp = cs.rollout_width_inputs(21, 96, ROWS, gen)
    times, outs = {"new": [], "parent": []}, {}
    with torch.no_grad():
        for side in ("parent", "new", "new", "parent", "parent", "new"):
            build._libraries[("gru_rollout", 21, build.DEFAULT_HIDDEN)] = libs[side]
            build.c_entry.cache_clear()
            times[side].append(cs.cuda_ms(lambda: rollout.gru_rollout(**inp, ph=PH), reps=3))
            outs[side] = rollout.gru_rollout(**inp, ph=PH)
    build._libraries[("gru_rollout", 21, build.DEFAULT_HIDDEN)] = libs["new"]
    build.c_entry.cache_clear()
    return {"ms": times, "max_abs_diff": (outs["new"] - outs["parent"]).abs().max().item()}


def repeated(n: int, h: int, reps: int) -> dict:
    """``reps`` launches at n nodes and hidden h against the plain version."""
    gen = torch.Generator(device="cuda").manual_seed(7 + h)
    inp = cs.rollout_width_inputs(n, h, ROWS, gen)
    bad = []
    with torch.no_grad():
        want = rollout.gru_rollout_plain(**inp, ph=PH)
        for i in range(reps):
            d = (rollout.gru_rollout(**inp, ph=PH) - want).abs()
            if d.max().item() > cs.K1_TOL:
                t, node, row, _ = (int(x) for x in torch.unravel_index(d.argmax(), d.shape))
                rows = (d.amax(dim=(0, 1, 3)) > 1e-5).nonzero().flatten()
                first = int((d[:, :, row].amax(dim=(1, 2)) > 1e-5).nonzero()[0])
                bad.append({"launch": i, "max": d.max().item(), "step": t, "node": node,
                            "first_step": first, "rows": rows[:12].tolist()})
    return {"nodes": n, "hidden": h, "launches": reps, "off": bad}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=pathlib.Path, default=None)
    ap.add_argument("--reps", type=int, default=12)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    build.build_all((21,), [p for p in PAIRS if p[1] != build.DEFAULT_HIDDEN])
    gen = torch.Generator(device="cuda").manual_seed(0)
    widths = [cs.check_rollout_width(h, gen, n) for n, h in PAIRS]
    parent = against_parent(args.parent.resolve(), gen) if args.parent else None
    if parent:
        print(f"hidden 96 new vs parent ms {parent}", flush=True)
    runs = [repeated(n, h, args.reps) for n, h in PAIRS] if args.reps else []
    for r in runs:
        print(f"({r['nodes']}, {r['hidden']}): {len(r['off'])} of {r['launches']} launches off "
              f"{r['off'][:2]}", flush=True)
    print(cs.card())
    print(json.dumps({"widths": widths, "parent": parent, "repeated": runs}))
    return 1 if any(r["off"] for r in runs) else 0


if __name__ == "__main__":
    sys.exit(main())
