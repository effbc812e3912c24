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
the node sum is taken in fp32 and rounded once; ``attention_core_fm_plain``
rounds there.  The kernel, ``csrc/attention_core_fm.cu``, stages items of
``FmPlan.cols`` batch columns × one head through a ring of shared-memory
stages (TMA copies), transposes each into B2's per-row layout, runs B2's
bodies and stores O back with one TMA copy an item: in bf16 both products
on the tensor cores, which sum the products qn·k unrounded, the one
rounding point where it differs from the plain version (it is held to it at
the bf16 bounds, as B2 is).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import build
from .node_mix_sm90 import MAX_SMEM, MAX_STAGES

launches = 0

DIM_HEAD = 32       # the head width the kernel is built for
MAX_HEADS = 32
# batch columns an item: 32 bytes of a (joint, feature) row in either type,
# 16 past build.NARROW_NODES (``cols``)
COLS = {torch.bfloat16: 16, torch.float32: 8}
PAD = 16            # bytes after each column's q‖k‖v, and after each joint's columns


class FmPlan(NamedTuple):
    """Batch columns an item, ring stages and dynamic shared-memory bytes of
    one launch."""
    cols: int
    stages: int
    smem_bytes: int


def _up(n: int) -> int:
    return -(-n // 128) * 128


def cols(dtype: torch.dtype, nodes: int) -> int:
    """Batch columns an item (``FmTile::kCols``): COLS up to
    build.NARROW_NODES, half of them past it (a stage's row of 16 bytes, the
    least a TMA box row may have)."""
    return COLS[dtype] // 2 if build.wide(nodes) else COLS[dtype]


def plan_bytes(elem: int, cols: int, dim_head: int, stages: int,
               nodes: int = build.DEFAULT_NODES) -> int:
    """Shared memory of one block (``fm_layout`` in
    ``csrc/attention_core_fm.cu``): barriers and a zero row; ``stages``
    stages of the item's q, k and v of every joint, [3][N][dh][cols]; the
    transposed tile [N][cols][3·dh], each column followed by PAD bytes and
    each joint's columns by PAD more; the item's O, [N][dh][cols]."""
    part = nodes * dim_head * cols * elem
    joint = cols * (3 * dim_head * elem + PAD) + PAD
    return 128 + stages * 3 * part + _up(nodes * joint) + part


def fm_plan(dtype: torch.dtype, heads: int, dim_head: int,
            nodes: int = build.DEFAULT_NODES) -> FmPlan:
    """The plan of the kernel at ``nodes`` joints: the type's columns an
    item (``cols``) with as many ring stages (1 to 4) as fit (2 at 21
    joints, 1 at 51); raises for what the kernel does not take."""
    build.element_suffix("attention_core_fm", dtype)
    build.check_nodes("attention_core_fm", nodes)
    if dim_head != DIM_HEAD or not 0 < heads <= MAX_HEADS:
        raise ValueError(f"attention_core_fm: takes 1 to {MAX_HEADS} heads of {DIM_HEAD}, got "
                         f"{heads} × {dim_head}")
    elem, c = torch.empty((), dtype=dtype).element_size(), cols(dtype, nodes)
    fits = [s for s in range(1, MAX_STAGES + 1)
            if plan_bytes(elem, c, dim_head, s, nodes) <= MAX_SMEM]
    if not fits:
        raise ValueError(f"attention_core_fm: {nodes} joints do not fit {MAX_SMEM} bytes of "
                         "shared memory with one stage")
    return FmPlan(c, fits[-1], plan_bytes(elem, c, dim_head, fits[-1], nodes))


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
    plan = fm_plan(qkv.dtype, heads, dim_head, n)
    build.check_kernel_inputs("attention_core_fm", {"qkv": (n, 3 * hd, rows)}, qkv.dtype,
                              qkv=qkv)
    build.check_aligned("attention_core_fm", 16, qkv=qkv)
    out = torch.empty((n, hd, rows), dtype=qkv.dtype, device=qkv.device)
    status = build.c_entry("attention_core_fm", f"attention_core_fm_{suffix}", 2, 7, n)(
        qkv.data_ptr(), out.data_ptr(), n, rows, heads, dim_head, *plan, build.stream_of(qkv))
    build.check_status(f"attention_core_fm at (nodes, heads, dim_head, plan)="
                       f"{(n, heads, dim_head, *plan)}", status)
    launches += 1
    return out
