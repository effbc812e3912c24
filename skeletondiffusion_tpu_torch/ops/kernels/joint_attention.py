"""Softmax attention over the skeleton's joints as one CUDA kernel.

For every row b and head h of packed node-major q‖k‖v [N, B, 3·H·dh]:

    qs      = round(q · round(dh^-1/2))
    p[n, m] = round(softmax_m(Σ_c round(qs[n, c]·k[m, c])))
    out[n]  = round(Σ_m p[n, m]·v[m])                      → [N, B, H·dh]

in the input's element type (bf16 on the prediction path; fp32 is
instantiated too, where every round() is exact), sums in fp32.  Port of
``skeletondiffusion_tpu/ops/pallas/joint_attention.py::attention_core_pallas``:
the Pallas kernel sums the rounded products over dh through a
block-indicator matmul (a workaround for the TPU's matrix unit); this kernel
is a direct small-N attention that rounds where the Pallas kernel rounds,
``csrc/joint_attention.cu``.
"""
from __future__ import annotations

import torch

from . import build

launches = 0


def attention_core_plain(qkv: torch.Tensor, heads: int, dim_head: int) -> torch.Tensor:
    n, b, _ = qkv.shape
    dt, hd = qkv.dtype, heads * dim_head
    q, k, v = (t.reshape(n, b, heads, dim_head) for t in qkv.float().split(hd, dim=-1))
    scale = torch.tensor(dim_head ** -0.5).to(dt).float()
    qs = (q * scale).to(dt).float()
    # per query joint: the q·k products rounded to dt, summed in fp32 → [b, h, m]
    sim = torch.stack([(qs[i] * k).to(dt).float().sum(dim=-1).permute(1, 2, 0)
                       for i in range(n)], dim=2)  # [b, h, n, m]
    attn = torch.softmax(sim, dim=-1).to(dt).float()
    return torch.einsum("bhnm,mbhc->nbhc", attn, v).reshape(n, b, hd).to(dt)


def attention_core(qkv: torch.Tensor, *, heads: int, dim_head: int) -> torch.Tensor:
    """qkv [N,B,3·H·dh] → [N,B,H·dh].  CPU tensors run
    ``attention_core_plain``; CUDA tensors launch the kernel or raise."""
    global launches
    if build.kernel_device(qkv=qkv) == "cpu":
        return attention_core_plain(qkv, heads, dim_head)
    n, rows, width = qkv.shape
    hd = heads * dim_head
    suffix = build.element_suffix("attention_core", qkv.dtype)
    build.check_kernel_inputs("attention_core", {"qkv": (n, rows, 3 * hd)}, qkv.dtype, qkv=qkv)
    build.check_aligned("attention_core", 16, qkv=qkv)
    out = torch.empty((n, rows, hd), dtype=qkv.dtype, device=qkv.device)
    status = build.c_entry("joint_attention", f"attention_core_{suffix}", 2, 4)(
        qkv.data_ptr(), out.data_ptr(), n, rows, heads, dim_head, build.stream_of(qkv))
    build.check_status(f"attention_core at (nodes, heads, dim_head)={(n, heads, dim_head)}",
                       status)
    launches += 1
    return out
