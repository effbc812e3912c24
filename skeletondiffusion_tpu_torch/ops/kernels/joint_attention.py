"""Softmax attention over the skeleton's joints as one CUDA kernel.

For every row b and head h of packed node-major q‖k‖v [N, B, 3·H·W]:

    qs      = round(q · round(dh^-1/2))
    p[n, m] = round(softmax_m(Σ_c round(qs[n, c]·k[m, c])))
    out[n]  = round(Σ_m p[n, m]·v[m])                      → [N, B, H·W]

in the input's element type (bf16 on the prediction path; fp32 is
instantiated too, where every round() is exact), sums in fp32.  W, a head's
columns in q‖k‖v, is ``qkv.shape[-1] // (3·H)``: the head width dh itself,
or (``head_width``) dh zero-padded to the kernel's next width, 16, 32, 64 or
128 (the chain's prep pads the qkv bank's columns, ``denoiser_fused``); the
scale is the true dh's and the padded columns stay zero.  Port of
``skeletondiffusion_tpu/ops/pallas/joint_attention.py::attention_core_pallas``:
the Pallas kernel sums the rounded products over dh through a
block-indicator matmul (a workaround for the TPU's matrix unit);
``attention_core_plain`` rounds where it rounds.  The kernel,
``csrc/joint_attention.cu``, runs both products on the tensor cores in
bf16, which sum the products qs·k unrounded: the one rounding point where it
differs from the plain version (it is held to it at the bf16 bounds).  Its
persistent blocks walk items of ``AttentionPlan.rows`` rows × a group of
heads through a ring of shared-memory stages (``attention_plan``).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import build
from .node_mix_sm90 import MAX_SMEM, MAX_STAGES, N_NODES

launches = 0

HEAD_WIDTHS = (16, 32, 64, 128)  # the head widths W the kernels are built for
MAX_HEADS = 32
WIDTHS_ITEM = "ROADMAP.md Queue B item 9"
NODE_PAD = 16       # bytes after each node's rows in a stage


class AttentionPlan(NamedTuple):
    """Rows an item, heads an item, ring stages and dynamic shared-memory
    bytes of one launch."""
    rows: int
    group_heads: int
    stages: int
    smem_bytes: int


def plan_bytes(elem: int, rows: int, group_heads: int, dim_head: int, stages: int,
               nodes: int = N_NODES) -> int:
    """Shared memory of one block (``attention_layout`` in
    ``csrc/joint_attention.cu``): barriers and a zero row, then ``stages``
    stages of every node's ``rows`` rows of the group's q‖k‖v, each node
    followed by NODE_PAD bytes."""
    node = elem * rows * 3 * group_heads * dim_head + NODE_PAD
    stage = -(-nodes * node // 128) * 128
    return 128 + stages * stage


def head_width(dim_head: int) -> int:
    """The kernels' width W of a head of ``dim_head`` columns: the first of
    HEAD_WIDTHS that holds it (narrower heads are zero-padded to it), or
    ``dim_head`` itself past the widest (which the plans refuse)."""
    return next((w for w in HEAD_WIDTHS if dim_head <= w), dim_head)


def check_heads(kernel: str, heads: int, width: int) -> None:
    """Raise ValueError unless ``heads`` heads of ``width`` columns are ones
    the attention kernels are built for."""
    if width not in HEAD_WIDTHS or not 0 < heads <= MAX_HEADS:
        raise ValueError(f"{kernel}: takes 1 to {MAX_HEADS} heads of 16, 32, 64 or 128 columns "
                         f"(narrower heads zero-padded to 16), got {heads} × {width} "
                         f"({WIDTHS_ITEM})")


def attention_plan(dtype: torch.dtype, heads: int, dim_head: int,
                   nodes: int = N_NODES) -> AttentionPlan:
    """The plan of the attention kernel for ``heads`` heads of ``dim_head``
    columns (the head width W, one of HEAD_WIDTHS) at ``nodes`` joints: two
    rows of all heads an item if a ring of two such stages fits, else one
    row of the largest group of heads that does, with as many stages (2 to
    4) as fit; raises for what the kernel does not take."""
    build.element_suffix("attention_core", dtype)
    build.check_nodes("attention_core", nodes)
    check_heads("attention_core", heads, dim_head)
    elem = torch.empty((), dtype=dtype).element_size()
    for rows in (2, 1):
        for group in ([heads] if rows > 1 else
                      [g for g in range(heads, 0, -1) if heads % g == 0]):
            fits = [s for s in range(2, MAX_STAGES + 1)
                    if plan_bytes(elem, rows, group, dim_head, s, nodes) <= MAX_SMEM]
            if fits:
                return AttentionPlan(rows, group, fits[-1],
                                     plan_bytes(elem, rows, group, dim_head, fits[-1], nodes))
    raise AssertionError("one row of one head always fits")


def columns_per_head(qkv: torch.Tensor, heads: int, dim_head: int,
                     kernel: str = "attention_core") -> int:
    """W, a head's columns in q‖k‖v [·, 3·H·W] (activations or a bank): at
    least ``dim_head``."""
    width = qkv.shape[-1] // (3 * heads)
    if qkv.shape[-1] != 3 * heads * width or width < dim_head:
        raise ValueError(f"{kernel}: q‖k‖v of {qkv.shape[-1]} columns is not 3 × {heads} "
                         f"heads of at least {dim_head}")
    return width


def attention_core_plain(qkv: torch.Tensor, heads: int, dim_head: int) -> torch.Tensor:
    n, b, _ = qkv.shape
    width = columns_per_head(qkv, heads, dim_head)
    dt, hd = qkv.dtype, heads * width
    q, k, v = (t.reshape(n, b, heads, width) for t in qkv.float().split(hd, dim=-1))
    scale = torch.tensor(dim_head ** -0.5).to(dt).float()
    qs = (q * scale).to(dt).float()
    # per query joint: the q·k products rounded to dt, summed in fp32 → [b, h, m]
    sim = torch.stack([(qs[i] * k).to(dt).float().sum(dim=-1).permute(1, 2, 0)
                       for i in range(n)], dim=2)  # [b, h, n, m]
    attn = torch.softmax(sim, dim=-1).to(dt).float()
    return torch.einsum("bhnm,mbhc->nbhc", attn, v).reshape(n, b, hd).to(dt)


def _checked(qkv: torch.Tensor, heads: int, dim_head: int) -> AttentionPlan:
    n, rows, _ = qkv.shape
    build.element_suffix("attention_core", qkv.dtype)
    width = max(qkv.shape[-1] // (3 * heads), dim_head) if heads > 0 else dim_head
    plan = attention_plan(qkv.dtype, heads, width, n)
    build.check_kernel_inputs("attention_core", {"qkv": (n, rows, 3 * heads * width)},
                              qkv.dtype, qkv=qkv)
    return plan


def _launch(qkv: torch.Tensor, heads: int, dim_head: int) -> torch.Tensor:
    global launches
    n, rows, _ = qkv.shape
    suffix = build.element_suffix("attention_core", qkv.dtype)
    plan = _checked(qkv, heads, dim_head)
    width = qkv.shape[-1] // (3 * heads)
    build.check_aligned("attention_core", 16, qkv=qkv)
    out = torch.empty((n, rows, heads * width), dtype=qkv.dtype, device=qkv.device)
    status = build.c_entry("joint_attention", f"attention_core_{suffix}", 2, 9, n)(
        qkv.data_ptr(), out.data_ptr(), n, rows, heads, width, dim_head, *plan,
        build.stream_of(qkv))
    build.check_status(f"attention_core at (nodes, heads, width, dim_head, plan)="
                       f"{(n, heads, width, dim_head, *plan)}", status)
    launches += 1
    return out


def _fake(qkv: torch.Tensor, heads: int, dim_head: int) -> torch.Tensor:
    if build.on_cuda(qkv):
        _checked(qkv, heads, dim_head)
    return qkv.new_empty((*qkv.shape[:2], qkv.shape[-1] // 3))


attention_core_op = build.kernel_op(
    "attention_core", "(Tensor qkv, int heads, int dim_head) -> Tensor", attention_core_plain,
    _launch, _fake)


def attention_core(qkv: torch.Tensor, *, heads: int, dim_head: int) -> torch.Tensor:
    """qkv [N,B,3·H·W] → [N,B,H·W] for heads of ``dim_head`` columns (W ≥
    dim_head; columns past dim_head zero), through the op
    ``skd::attention_core``.  CPU tensors run ``attention_core_plain``; CUDA
    tensors launch the kernel or raise."""
    return attention_core_op(qkv, heads, dim_head)
