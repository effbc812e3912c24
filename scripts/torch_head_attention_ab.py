#!/usr/bin/env python3
"""A/B of the attention bodies the port's B2 (``csrc/joint_attention.cu``)
and B9b (``csrc/layer_fused.cu``) share in bf16 (``csrc/joint_attention.cuh``):
``head_attention_mma``, both products on the tensor cores (as built), against
``head_attention``, a lane per query joint on the CUDA cores with each q·k
product rounded to bf16 as the Pallas kernel rounds it, at the bench shapes:
21 joints, 8 heads × 32, 12 800 rows, F = 192.

    python3 scripts/torch_head_attention_ab.py

The CUDA-core variant is the same sources with ``kTensorCoreBody`` switched
off; both variants of ``joint_attention.cu`` and ``layer_fused.cu`` are built
with the port's nvcc flags into ``build/head_attention_ab/``.  On random
inputs from a seed it holds each variant's output against the kernels' plain
versions at the bf16 bounds (max |Δ| ≤ 3e-2·max|ref|, mean ≤ 2e-3·max|ref|;
the two bodies differ in where q·k is rounded), times each kernel in each
variant (CUDA events, 20 calls a reading, 4 rounds in alternating order) and
prints the card's name and power limit, then one JSON line; exit 1 if a
variant breaks the bounds.  Needs one CUDA device.
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
TC_SWITCH = "constexpr bool kTensorCoreBody = std::is_same_v<T, bf16>;"
OUT = REPO / "build" / "head_attention_ab"
ROUNDS, REPS = 4, 20
BF16_MAX, BF16_MEAN = 3e-2, 2e-3


def cuda_core_sources(dst: pathlib.Path) -> pathlib.Path:
    """A copy of ``csrc/`` with the tensor-core body switched off."""
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(build.CSRC_DIR, dst)
    header = dst / "joint_attention.cuh"
    text = header.read_text()
    if text.count(TC_SWITCH) != 1:
        raise RuntimeError(f"the body's switch ({TC_SWITCH}) not found once")
    header.write_text(text.replace(TC_SWITCH, "constexpr bool kTensorCoreBody = false;"))
    return dst


def build_variants() -> dict:
    """{variant: {library: CDLL}}, the two variants built at once."""
    dirs = {"mma": build.CSRC_DIR, "cuda_core": cuda_core_sources(OUT / "cuda_core_src")}
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
    build._libraries.update({(name, build.DEFAULT_NODES, build.DEFAULT_HIDDEN): lib
                             for name, lib in libraries.items()})
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
    plain = {"rms_qkv_core": layer_fused.rms_qkv_core_plain(x, g_rms, w_qkv, g_qkv, H, DH),
             "attention_core": joint_attention.attention_core_plain(qkv, H, DH)}
    errors, times = {}, {v: {k: [] for k in kernels} for v in variants}
    for v, libs in variants.items():
        use(libs)
        for k, fn in kernels.items():
            d = (fn().float() - plain[k].float()).abs()
            ref = plain[k].float().abs().max().item()
            errors.setdefault(v, {})[k] = {"max": d.max().item(), "mean": d.mean().item(),
                                           "ref": ref}
    for r in range(ROUNDS):
        for v in (list(variants) if r % 2 == 0 else list(variants)[::-1]):
            use(variants[v])
            for k, fn in kernels.items():
                times[v][k].append(cuda_ms(fn))
    ok = all(e["max"] <= BF16_MAX * e["ref"] and e["mean"] <= BF16_MEAN * e["ref"]
             for ve in errors.values() for e in ve.values())
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    print(card)
    print(json.dumps({"ms": times, "best_ms": {v: {k: min(t) for k, t in kt.items()}
                                               for v, kt in times.items()},
                      "vs_plain": errors, "within_bounds": ok}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
