#!/usr/bin/env python3
"""A/B of the attention body the port's B2 (``csrc/joint_attention.cu``) and
B9b (``csrc/layer_fused.cu``) share, ``csrc/joint_attention.cuh``'s
``head_attention``, in bf16: its bf16x2 products (as built) against the
scalar body (each product an fp32 multiply rounded to bf16), at the bench
shapes: 21 joints, 8 heads × 32, 12 800 rows, F = 192.

    python3 scripts/torch_head_attention_ab.py

The scalar variant is the same sources with the bf16 branch of
``head_attention`` switched off; both variants of ``joint_attention.cu`` and
``layer_fused.cu`` are built with the port's nvcc flags into
``build/head_attention_ab/``.  On random inputs from a seed it checks that
both variants give the same bits, times each kernel in each variant (CUDA
events, 20 calls a reading, 4 rounds in alternating order) and prints the
card's name and power limit, then one JSON line.  Needs one CUDA device.
"""
from __future__ import annotations

import ctypes
import json
import pathlib
import shutil
import subprocess
import sys
import threading

import torch

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from skeletondiffusion_tpu_torch.ops.kernels import build, joint_attention, layer_fused  # noqa: E402

N, H, DH, B, F = 21, 8, 32, 12800, 192
LIBRARIES = ("joint_attention", "layer_fused")
BF16_BRANCH = "if constexpr (std::is_same_v<T, bf16>)"
OUT = REPO / "build" / "head_attention_ab"
ROUNDS, REPS = 4, 20


def scalar_sources(dst: pathlib.Path) -> pathlib.Path:
    """A copy of ``csrc/`` with head_attention's bf16 branch switched off."""
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(build.CSRC_DIR, dst)
    header = dst / "joint_attention.cuh"
    text = header.read_text()
    if text.count(BF16_BRANCH) != 1:
        raise RuntimeError(f"head_attention's bf16 branch ({BF16_BRANCH}) not found once")
    header.write_text(text.replace(BF16_BRANCH, "if constexpr (false)"))
    return dst


def build_variants() -> dict:
    """{variant: {library: CDLL}}, the two variants built at once."""
    dirs = {"bf16x2": build.CSRC_DIR, "scalar": scalar_sources(OUT / "scalar_src")}
    errors = []

    def compile_one(variant, src):
        try:
            build.compile_sources([src / f"{n}.cu" for n in LIBRARIES], OUT / variant)
        except RuntimeError as e:
            errors.append(f"{variant}: {e}")

    threads = [threading.Thread(target=compile_one, args=item) for item in dirs.items()]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise RuntimeError("\n".join(errors))
    return {v: {n: ctypes.CDLL(str(OUT / v / f"lib{n}.so")) for n in LIBRARIES} for v in dirs}


def use(libraries: dict) -> None:
    """Point the wrappers at one variant's libraries."""
    build._libraries.clear()
    build._libraries.update(libraries)
    build.c_entry.cache_clear()


def cuda_ms(fn) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(REPS):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / REPS


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    variants = build_variants()
    gen = torch.Generator(device="cuda").manual_seed(0)
    rnd = lambda *s: torch.randn(s, generator=gen, device="cuda")  # noqa: E731
    bf16 = torch.bfloat16
    x = rnd(N, B, F).to(bf16)
    g_rms = ((1 + 0.1 * rnd(F)) * F ** 0.5).to(bf16)
    w_qkv = (rnd(N, F, 3 * H * DH) / F ** 0.5).to(bf16)
    g_qkv = (2 * torch.rand((N, N), generator=gen, device="cuda") / N).to(bf16)
    qkv = rnd(N, B, 3 * H * DH).to(bf16)
    kernels = {
        "rms_qkv_core": lambda: layer_fused.rms_qkv_core(x, g_rms, w_qkv, g_qkv, heads=H,
                                                         dim_head=DH),
        "attention_core": lambda: joint_attention.attention_core(qkv, heads=H, dim_head=DH),
    }
    outs, times = {}, {v: {k: [] for k in kernels} for v in variants}
    for v, libs in variants.items():
        use(libs)
        outs[v] = {k: fn().clone() for k, fn in kernels.items()}
    for r in range(ROUNDS):
        for v in (list(variants) if r % 2 == 0 else list(variants)[::-1]):
            use(variants[v])
            for k, fn in kernels.items():
                times[v][k].append(cuda_ms(fn))
    same = {k: torch.equal(outs["bf16x2"][k], outs["scalar"][k]) for k in kernels}
    finite = all(torch.isfinite(t).all().item() for o in outs.values() for t in o.values())
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    print(card)
    print(json.dumps({"ms": times, "best_ms": {v: {k: min(t) for k, t in kt.items()}
                                               for v, kt in times.items()},
                      "same_bits": same, "finite": finite}))
    return 0 if all(same.values()) and finite else 1


if __name__ == "__main__":
    sys.exit(main())
