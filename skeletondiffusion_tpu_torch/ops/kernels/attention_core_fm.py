"""Softmax attention over the skeleton's joints, feature-major, as one CUDA
kernel: a lab kernel, on no predictor path.

For every column b and head h of packed feature-major q‖k‖v [N, 3·H·dh, B]
(the batch contiguous):

    qn[n]   = round(q[n] · round(dh^-1/2))
    s[n, m] = Σ_c round(k[m, c]·qn[n, c])                  fp32 sums
    a[n, m] = round(softmax_m(s[n, ·]))
    out[n]  = round(Σ_m v[m]·a[n, m])                      → [N, H·dh, B]

in the input's element type (bf16 or fp32, where every round() is exact).
Port of ``scripts/attn_core_lab.py::core_fm`` (body ``_core_fm_kernel``),
the feature-major prototype of the batch-major attention core
(``joint_attention.py``, B2).  The rounding points are those of the Pallas
kernel run in interpret mode on the CPU: q·scale and each k·q product are
rounded (they are stored in the input dtype), the products v·a are not, and
the node sum is taken in fp32 and rounded once.  The kernel is
``csrc/attention_core_fm.cu``.
"""
from __future__ import annotations

import torch

from . import build

launches = 0


def attention_core_fm_plain(qkv: torch.Tensor, heads: int, dim_head: int) -> torch.Tensor:
    """The kernel's function in plain PyTorch, qkv [N, 3·H·dh, B] →
    [N, H·dh, B] in qkv's dtype."""
    n, _, b = qkv.shape
    dt, hd = qkv.dtype, heads * dim_head
    rnd = lambda t: t.to(dt).float()  # noqa: E731
    q, k, v = (t.reshape(n, heads, dim_head, b) for t in qkv.float().split(hd, dim=1))
    scale = rnd(torch.tensor(dim_head ** -0.5))
    qn = rnd(q * scale)
    # per query joint n: the k·q products rounded, summed over c → [n, m, h, b]
    s = torch.stack([rnd(k * qn[i]).sum(dim=2) for i in range(n)])
    a = rnd(torch.softmax(s, dim=1))
    return torch.einsum("nmhb,mhcb->nhcb", a, v).reshape(n, hd, b).to(dt)


def attention_core_fm(qkv: torch.Tensor, *, heads: int, dim_head: int) -> torch.Tensor:
    """qkv [N, 3·H·dh, B] → [N, H·dh, B].  CPU tensors run
    ``attention_core_fm_plain``; CUDA tensors launch the kernel or raise."""
    global launches
    if build.kernel_device(qkv=qkv) == "cpu":
        return attention_core_fm_plain(qkv, heads, dim_head)
    n, width, rows = qkv.shape
    hd = heads * dim_head
    suffix = build.element_suffix("attention_core_fm", qkv.dtype)
    build.check_kernel_inputs("attention_core_fm", {"qkv": (n, 3 * hd, rows)}, qkv.dtype,
                              qkv=qkv)
    out = torch.empty((n, hd, rows), dtype=qkv.dtype, device=qkv.device)
    status = build.c_entry("attention_core_fm", f"attention_core_fm_{suffix}", 2, 4)(
        qkv.data_ptr(), out.data_ptr(), n, rows, heads, dim_head, build.stream_of(qkv))
    build.check_status(f"attention_core_fm at (nodes, heads, dim_head)={(n, heads, dim_head)}",
                       status)
    launches += 1
    return out
