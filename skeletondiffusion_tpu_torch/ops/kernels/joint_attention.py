"""Softmax attention over the skeleton's joints as one CUDA kernel.

For every row b and head h of packed node-major q‖k‖v [N, B, 3·H·dh]:

    qs      = round(q · round(dh^-1/2))
    p[n, m] = round(softmax_m(Σ_c round(qs[n, c]·k[m, c])))
    out[n]  = round(Σ_m p[n, m]·v[m])                      → [N, B, H·dh]

in the input's element type (bf16 on the prediction path; fp32 is
instantiated too, where every round() is exact), sums in fp32.  Port of
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

DIM_HEAD = 32       # the head width the kernel is built for
MAX_HEADS = 32
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


def attention_plan(dtype: torch.dtype, heads: int, dim_head: int,
                   nodes: int = N_NODES) -> AttentionPlan:
    """The plan of the attention kernel at ``nodes`` joints: two rows of all
    heads an item if a ring of two such stages fits, else one row of the
    largest group of heads that does, with as many stages (2 to 4) as fit;
    raises for what the kernel does not take."""
    build.element_suffix("attention_core", dtype)
    build.check_nodes("attention_core", nodes)
    if dim_head != DIM_HEAD or not 0 < heads <= MAX_HEADS:
        raise ValueError(f"attention_core: takes 1 to {MAX_HEADS} heads of {DIM_HEAD}, got "
                         f"{heads} × {dim_head}")
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


def _checked(qkv: torch.Tensor, heads: int, dim_head: int) -> AttentionPlan:
    n, rows, width = qkv.shape
    build.element_suffix("attention_core", qkv.dtype)
    plan = attention_plan(qkv.dtype, heads, dim_head, n)
    build.check_kernel_inputs("attention_core", {"qkv": (n, rows, 3 * heads * dim_head)},
                              qkv.dtype, qkv=qkv)
    return plan


def _launch(qkv: torch.Tensor, heads: int, dim_head: int) -> torch.Tensor:
    global launches
    n, rows, width = qkv.shape
    hd = heads * dim_head
    suffix = build.element_suffix("attention_core", qkv.dtype)
    plan = _checked(qkv, heads, dim_head)
    build.check_aligned("attention_core", 16, qkv=qkv)
    out = torch.empty((n, rows, hd), dtype=qkv.dtype, device=qkv.device)
    status = build.c_entry("joint_attention", f"attention_core_{suffix}", 2, 8, n)(
        qkv.data_ptr(), out.data_ptr(), n, rows, heads, dim_head, *plan, build.stream_of(qkv))
    build.check_status(f"attention_core at (nodes, heads, dim_head, plan)="
                       f"{(n, heads, dim_head, *plan)}", status)
    launches += 1
    return out


def _fake(qkv: torch.Tensor, heads: int, dim_head: int) -> torch.Tensor:
    if build.on_cuda(qkv):
        _checked(qkv, heads, dim_head)
    return qkv.new_empty((*qkv.shape[:2], heads * dim_head))


attention_core_op = build.kernel_op(
    "attention_core", "(Tensor qkv, int heads, int dim_head) -> Tensor", attention_core_plain,
    _launch, _fake)


def attention_core(qkv: torch.Tensor, *, heads: int, dim_head: int) -> torch.Tensor:
    """qkv [N,B,3·H·dh] → [N,B,H·dh], through the op ``skd::attention_core``.
    CPU tensors run ``attention_core_plain``; CUDA tensors launch the kernel
    or raise."""
    return attention_core_op(qkv, heads, dim_head)
