#!/usr/bin/env python3
"""Attention-core lab of the PyTorch port, the twin of
``scripts/attn_core_lab.py``: the batch-major attention core (B2,
``ops/kernels/joint_attention.py``, ``csrc/joint_attention.cu``) against the
feature-major core (L1, ``ops/kernels/attention_core_fm.py``,
``csrc/attention_core_fm.cu``) at the bench shapes: 21 joints, 8 heads × 32,
12 800 rows.

    python3 scripts/torch_attn_core_lab.py                  # timing on the GPU
    python3 scripts/torch_attn_core_lab.py --check          # parity on the GPU
    python3 scripts/torch_attn_core_lab.py --check --device cpu

``--check`` holds the feature-major core (the kernel on the GPU, its plain
version on the CPU) against an fp32 einsum/softmax reference on 128 columns:
fp32 max error < 2e-5, and prints the bf16 core's error.  The default run
times, as the JAX script does, a chain of DEPTH = 8 calls of each core in
bf16, each call's output tripled into the next call's q‖k‖v: 4 timed chains
with the input varied each time, CUDA events, the fastest kept; it prints ms a
call for each core (the concatenation included, the same for both).
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
from skeletondiffusion_tpu_torch.ops.kernels.attention_core_fm import (  # noqa: E402
    attention_core_fm,
)
from skeletondiffusion_tpu_torch.ops.kernels.joint_attention import attention_core  # noqa: E402

N, H, DH, B = 21, 8, 32, 12800
HD = H * DH
DEPTH = 8
TIMED_CHAINS = 4


def ref_core_fm(qkv: torch.Tensor) -> torch.Tensor:
    """fp32 reference for the feature-major layout, [N, 3·HD, B] → [N, HD, B]."""
    q, k, v = qkv.float().split(HD, dim=1)
    n = qkv.shape[0]
    qh = q.reshape(n, H, DH, -1) * DH ** -0.5
    kh, vh = k.reshape(n, H, DH, -1), v.reshape(n, H, DH, -1)
    sim = torch.einsum("nhcb,mhcb->bhnm", qh, kh)
    a = torch.softmax(sim, dim=-1)
    return torch.einsum("bhnm,mhcb->nhcb", a, vh).reshape(n, HD, -1)


def check(device) -> dict:
    """The fm core against ``ref_core_fm`` on 128 columns, fp32 and bf16."""
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(0)
    qkv = 0.5 * torch.randn((N, 3 * HD, 128), generator=gen, device=device)
    want = ref_core_fm(qkv)
    with torch.no_grad():
        err = (attention_core_fm(qkv, heads=H, dim_head=DH) - want).abs().max().item()
        got16 = attention_core_fm(qkv.to(torch.bfloat16), heads=H, dim_head=DH)
    err16 = (got16.float() - want).abs().max().item()
    print(f"core_fm max err: {err}", flush=True)
    if not err < 2e-5:
        raise AssertionError(f"the fp32 feature-major core is off by {err}")
    print(f"core_fm bf16 max err: {err16}", flush=True)
    return {"f32_max_err": err, "bf16_max_err": err16}


def chain_bm(x: torch.Tensor) -> torch.Tensor:
    for _ in range(DEPTH):
        o = attention_core(x, heads=H, dim_head=DH)
        x = torch.cat([o, o, o], dim=-1)
    return x


def chain_fm(x: torch.Tensor) -> torch.Tensor:
    for _ in range(DEPTH):
        o = attention_core_fm(x, heads=H, dim_head=DH)
        x = torch.cat([o, o, o], dim=1)
    return x


def chain_inputs(batch: int, device) -> tuple:
    """(qkv batch-major [N, B, 3·HD], the same feature-major [N, 3·HD, B]) in bf16."""
    gen = torch.Generator(device=device).manual_seed(0)
    qkv_bm = (0.5 * torch.randn((N, batch, 3 * HD), generator=gen, device=device)
              ).to(torch.bfloat16)
    return qkv_bm, qkv_bm.transpose(1, 2).contiguous()


def ms_per_call(chain, x: torch.Tensor) -> float:
    """The fastest of ``TIMED_CHAINS`` chains, in ms a call of the core."""
    xs = [x + i * 1e-6 for i in range(TIMED_CHAINS + 1)]
    with torch.no_grad():
        chain(xs[-1])
        per = []
        for xi in xs[:TIMED_CHAINS]:
            if x.is_cuda:
                torch.cuda.synchronize()
                start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                start.record()
                chain(xi)
                end.record()
                torch.cuda.synchronize()
                per.append(start.elapsed_time(end) / DEPTH)
            else:
                t0 = time.perf_counter()
                chain(xi)
                per.append((time.perf_counter() - t0) * 1e3 / DEPTH)
    return min(per)


def timing(batch: int = B, device="cuda") -> dict:
    device = resolve_device(device)
    qkv_bm, qkv_fm = chain_inputs(batch, device)
    out = {"batch": batch, "depth": DEPTH,
           "bm_ms_per_call": ms_per_call(chain_bm, qkv_bm),
           "fm_ms_per_call": ms_per_call(chain_fm, qkv_fm),
           "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"}
    print(f"v1 (B2, batch-major): {out['bm_ms_per_call']:.4f} ms/call (incl. the concat feed)",
          flush=True)
    print(f"v5 (L1, feature-major): {out['fm_ms_per_call']:.4f} ms/call (incl. the concat feed)",
          flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--batch", type=int, default=B)
    args = ap.parse_args(argv)
    if args.device == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    result = check(args.device) if args.check else timing(args.batch, args.device)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
