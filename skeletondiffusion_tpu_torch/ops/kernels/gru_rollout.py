"""The graph-GRU decode rollout, all steps in one CUDA kernel.

The decoder unrolls ``ph`` graph-GRU steps with a constant input whose gates
``cx = [x_{T-1}, z]·W_ih + b_ih`` are hoisted; per step t

    gates_h = G_t·(h·W_hh + b_hh),  gates_x = G_t·cx
    r, z = σ(x + h),  n = tanh(x_n + r·h_n),  h' = n − n·z + z·h
    y_t = tanh(G_fc·(h'·W_fc + b_fc)),  G_{t+1} = l1norm_rows(G_t + G_add)

Port of ``skeletondiffusion_tpu/ops/pallas/gru_rollout.py::gru_rollout_pallas``
without the TPU's 128-lane padding, in its two forms:

* fp32 (``_rollout_kernel``): the kernel is ``csrc/gru_rollout.cu``, which
  streams W_hh through shared memory from a copy packed once per bank
  (``pack_rollout_bank``) and is launched with ``rollout_plan``; the plain
  version is the step loop of ``ops/graph_gru.py``;
* ``compute_dtype=torch.bfloat16`` (``_rollout_kernel_merged``, the
  merged-gate kernel): bf16 operands for every product and mix, fp32 carries
  and sums; the kernel is ``csrc/gru_rollout_merged.cu``, which streams
  W_hh through shared memory from a copy packed once per bank
  (``pack_rollout_bank_bf16``) and is launched with ``rollout_bf16_plan``;
  the plain version is ``gru_rollout_merged_plain``.

``decode_rollout`` is the decoder's whole decode (the counterpart of the JAX
package's ``decode_rollout``): the hoisted input gates and initial hidden
state (``rollout_args``), then one rollout in either dtype.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from ..graph_gru import graph_gru_step
from ..graph_linear import gmix_nm, gmm_nm, l1_normalize_rows
from . import build, node_mix_sm90

launches = 0
launches_bf16 = 0

# The fp32 kernel's tiling (csrc/gru_rollout.cu): rows a block, hidden columns
# a slice, bank rows a ring stage, blocks a cluster (each weight byte read from
# L2 serves 32 rows); past build.NARROW_NODES (AMASS-MANO's 51) its second
# design's 2 rows a block and 2 bank rows a stage (``rollout_tiling``).
ROLLOUT_ROWS = 8
ROLLOUT_SLICE = 32
ROLLOUT_K_ROWS = 4
ROLLOUT_ROWS_WIDE = 2
ROLLOUT_K_ROWS_WIDE = 2
ROLLOUT_CLUSTER = 4
ROLLOUT_MAX_STAGES = 6   # mbarrier pairs the kernel reserves
H_ROW_PAD = 4            # floats after each row of h
H_PLANE_PAD = 4          # floats after each node's plane of h


def g_row(n: int) -> int:
    """The fp32 rollout's influence rows padded to whole float4s (``kGRow``)."""
    return -(-n // 4) * 4


class RolloutPlan(NamedTuple):
    """Rows a block, hidden columns a slice, ring stages, blocks a cluster
    and dynamic shared-memory bytes of one fp32 rollout launch."""
    rows: int
    slice: int
    stages: int
    cluster: int
    smem_bytes: int


def rollout_tiling(n: int):
    """(rows a block, bank rows a ring stage) of the fp32 rollout at n nodes."""
    if build.wide(n):
        return ROLLOUT_ROWS_WIDE, ROLLOUT_K_ROWS_WIDE
    return ROLLOUT_ROWS, ROLLOUT_K_ROWS


def rollout_plan_bytes(n: int, h: int, stages: int) -> int:
    """Shared memory of one block (``layout`` in ``csrc/gru_rollout.cu``):
    barriers, ``stages`` ring stages of k-rows bank rows × n nodes × the
    3·slice gate columns of a slice, h [n][rows·(h + pad) + pad], the
    slice's gate buffer [n][4 areas][rows][slice] and G_t, G_add, G_fc."""
    rows, k_rows = rollout_tiling(n)
    stage = 4 * k_rows * n * 3 * ROLLOUT_SLICE
    h_bytes = 4 * n * (rows * (h + H_ROW_PAD) + H_PLANE_PAD)
    p_bytes = 4 * n * 4 * rows * ROLLOUT_SLICE
    return 128 + stages * stage + h_bytes + p_bytes + 4 * 3 * n * g_row(n)


def rollout_plan(n: int, h: int) -> RolloutPlan:
    """The fp32 rollout's plan at n nodes and hidden width h: as many ring
    stages as fit (at most ROLLOUT_MAX_STAGES); raises ValueError when two do
    not.  The kernel is built for h = 96 and 3 outputs and refuses other
    shapes itself."""
    fits = [s for s in range(2, ROLLOUT_MAX_STAGES + 1)
            if rollout_plan_bytes(n, h, s) <= node_mix_sm90.MAX_SMEM]
    if not fits:
        raise ValueError(f"gru_rollout: {n} nodes at hidden {h} do not fit "
                         f"{node_mix_sm90.MAX_SMEM} bytes of shared memory with two stages "
                         f"({build.MORE_NODES})")
    return RolloutPlan(rollout_tiling(n)[0], ROLLOUT_SLICE, fits[-1], ROLLOUT_CLUSTER,
                       rollout_plan_bytes(n, h, fits[-1]))


def resident_clusters(plan: RolloutPlan, nodes: int = build.DEFAULT_NODES) -> int:
    """How many of the fp32 rollout kernel's clusters, built at ``nodes``
    nodes, fit on the card at once under ``plan`` (the blocks of one round
    are that × ``plan.cluster``); needs a CUDA device."""
    clusters = ctypes.c_int(0)
    status = build.c_entry("gru_rollout", "gru_rollout_f32_clusters", 1, 2, nodes)(
        ctypes.addressof(clusters), plan.stages, plan.smem_bytes, None)
    build.check_status(f"gru_rollout's occupancy query at plan {tuple(plan)}", status)
    return clusters.value


def _pack_rollout(w_hh: torch.Tensor) -> torch.Tensor:
    n, h, h3 = w_hh.shape
    s = ROLLOUT_SLICE
    # [slice J][k][node][gate a][column c] = W_hh[node][k][a·h + J·s + c]
    t = w_hh.reshape(n, h, 3, h // s, s).permute(3, 1, 0, 2, 4).reshape(h // s, h, n, 3 * s // 4, 4)
    # the halves of each odd node's row of 16-byte chunks swapped in groups of 8
    chunk = torch.arange(3 * s // 4)
    swap = torch.stack([chunk, chunk ^ 4]).to(w_hh.device)  # [parity][position] → chunk
    t = torch.stack([t[:, :, m, swap[m % 2]] for m in range(n)], dim=2)
    return t.contiguous().reshape(h // s, h * n * 3 * s)


def pack_rollout_bank(w_hh: torch.Tensor) -> torch.Tensor:
    """W_hh [N, H, 3H] → [H/slice, H·N·3·slice]: for each slice of
    ROLLOUT_SLICE hidden columns, bank rows k in order, each the N nodes' r, z
    and n columns of the slice, so that ROLLOUT_K_ROWS consecutive rows are
    one contiguous ring stage; in node m's row the 16-byte chunk c lies at
    chunk c ^ 4 for odd m (the kernel's loads then hit distinct banks).
    Cached per bank (``node_mix_sm90.cached_pack``)."""
    n, h, h3 = w_hh.shape
    if h % ROLLOUT_SLICE or h3 != 3 * h:
        raise ValueError(f"gru_rollout: W_hh of shape {tuple(w_hh.shape)} is not [N, H, 3H] "
                         f"with H a multiple of {ROLLOUT_SLICE}")
    return node_mix_sm90.cached_pack(w_hh, ("rollout", ROLLOUT_SLICE), _pack_rollout)


# The bf16 kernel's tiling (csrc/gru_rollout_merged.cu) up to
# build.NARROW_NODES: rows a block (the products' n8), hidden columns a slice
# (its r, z and n columns: 48 gate columns), bank rows a ring stage (one mma
# k-step), stages, blocks a cluster (each weight byte read from L2 serves 16
# rows); node tiles of 8 (``bf16_node_tiles``).  Past it (AMASS-MANO's 51)
# its second design: ROLLOUT_BF16_ROWS_WIDE rows a block, no slices and no
# ring (W_hh read as it is), clusters of 2 that share nothing.
ROLLOUT_BF16_ROWS = 8
ROLLOUT_BF16_SLICE = 16
ROLLOUT_BF16_K_ROWS = 16
ROLLOUT_BF16_STAGES = 2
ROLLOUT_BF16_CLUSTER = 2
ROLLOUT_BF16_ROWS_WIDE = 4
GATE_ROW_PAD = 8         # bf16 values after each row of a gate buffer's plane
HB_ROW_PAD = 8           # bf16 values after each row of bf16(h)
PLANE_PAD = 16           # bytes after each node's plane of both


def bf16_node_tiles(n: int) -> int:
    """Tiles of 8 nodes of the bf16 rollout up to build.NARROW_NODES
    (``kNT``): a warp's product nodes, the mixes' output tiles, the r/z
    mix's k16 tiles over 2n; its G rows are padded to 8 of them."""
    return -(-n // 8)


def rollout_bf16_plan_bytes(n: int, h: int, f: int) -> int:
    """Shared memory of one block (``Layout`` in ``csrc/gru_rollout_merged.cu``).
    Up to build.NARROW_NODES: barriers and a zero row, the ring's stages of
    ROLLOUT_BF16_K_ROWS bank rows × n nodes × the 3·slice gate columns of a
    slice, h in fp32 (a float4 per consumer lane, ``bf16_node_tiles`` tiles
    of 8 nodes, per slice and row), bf16(h) [n][rows][h + 8], the slice's hw3
    and cx [n][rows][3·slice + 8], W_fcᵀ's mma fragments (12 lanes × 8 bytes
    per node and k-step), G_t, G_add, G_fc rows padded to 8 node tiles, the
    head's outputs [n][rows][f] in fp32.  Past it: h in fp32 [n][rows][h],
    the step's hw3 [n][rows][3h] in bf16, G_t and bf16(G_t) rows padded to
    whole float4s, the head's outputs."""
    if build.wide(n):
        rows = ROLLOUT_BF16_ROWS_WIDE
        return 4 * n * rows * h + 2 * n * rows * 3 * h + 2 * 4 * n * g_row(n) + 4 * n * rows * f
    rows, s, tiles = ROLLOUT_BF16_ROWS, ROLLOUT_BF16_SLICE, bf16_node_tiles(n)
    ring = ROLLOUT_BF16_STAGES * n * ROLLOUT_BF16_K_ROWS * 3 * s * 2
    h32 = 4 * (h // s) * rows * tiles * 32 * 4
    hb = n * (rows * 2 * (h + HB_ROW_PAD) + PLANE_PAD)
    gates = 2 * n * (rows * 2 * (3 * s + GATE_ROW_PAD) + PLANE_PAD)
    fc = 8 * n * (h // ROLLOUT_BF16_K_ROWS) * 12
    return 128 + ring + h32 + hb + gates + fc + 4 * 3 * n * 8 * tiles + 4 * n * rows * f


def rollout_bf16_plan(n: int, h: int, f: int) -> RolloutPlan:
    """The bf16 rollout's plan at n nodes, hidden width h and f outputs:
    (8 rows, a slice of 16, 2 stages, clusters of 2) up to
    build.NARROW_NODES, (4 rows, no slice, no ring, clusters of 2) past it;
    raises ValueError when it does not fit shared memory.  The kernel is
    built for h = 96 and 3 outputs (232 112 bytes at 21 nodes, 219 504 at
    51) and refuses other shapes itself."""
    build.check_nodes("gru_rollout_bf16", n)
    smem = rollout_bf16_plan_bytes(n, h, f)
    if smem > node_mix_sm90.MAX_SMEM:
        raise ValueError(f"gru_rollout_bf16: {n} nodes at hidden {h} need {smem} bytes of "
                         f"shared memory, over {node_mix_sm90.MAX_SMEM}")
    if build.wide(n):
        return RolloutPlan(ROLLOUT_BF16_ROWS_WIDE, 0, 0, ROLLOUT_BF16_CLUSTER, smem)
    return RolloutPlan(ROLLOUT_BF16_ROWS, ROLLOUT_BF16_SLICE, ROLLOUT_BF16_STAGES,
                       ROLLOUT_BF16_CLUSTER, smem)


def _pack_rollout_bf16(w_hh: torch.Tensor) -> torch.Tensor:
    n, h, h3 = w_hh.shape
    s, kr = ROLLOUT_BF16_SLICE, ROLLOUT_BF16_K_ROWS
    # [slice J][k-step][node][k][gate a][column c] = W_hh[node][16·ks + k][a·h + J·s + c]
    t = w_hh.reshape(n, h // kr, kr, 3, h // s, s).permute(4, 1, 0, 2, 3, 5)
    t = t.reshape(h // s, h // kr, n, kr, 3 * s // 8, 8)
    # in rows k with bit 2 set, the 16-byte chunks swapped in pairs (c ↔ c ^ 1)
    chunk = torch.arange(3 * s // 8)
    swap = torch.stack([chunk, chunk ^ 1]).to(w_hh.device)  # [bit 2 of k][position] → chunk
    t = torch.stack([t[:, :, :, k, swap[(k >> 2) & 1]] for k in range(kr)], dim=3)
    return t.contiguous().reshape(h // s, h * n * 3 * s)


def pack_rollout_bank_bf16(w_hh: torch.Tensor) -> torch.Tensor:
    """W_hh [N, H, 3H] → [H/slice, H·N·3·slice] for the bf16 kernel: for each
    slice of ROLLOUT_BF16_SLICE hidden columns and each k-step of
    ROLLOUT_BF16_K_ROWS bank rows, one contiguous ring stage [node][k][r | z |
    n columns of the slice]; in bank row k the 16-byte chunk c lies at chunk
    c ^ 1 where bit 2 of k is set (an ldmatrix of 8 rows then hits distinct
    banks).  Cached per bank (``node_mix_sm90.cached_pack``)."""
    n, h, h3 = w_hh.shape
    if h % ROLLOUT_BF16_SLICE or h3 != 3 * h:
        raise ValueError(f"gru_rollout_bf16: W_hh of shape {tuple(w_hh.shape)} is not "
                         f"[N, H, 3H] with H a multiple of {ROLLOUT_BF16_SLICE}")
    return node_mix_sm90.cached_pack(w_hh, ("rollout_bf16", ROLLOUT_BF16_SLICE),
                                     _pack_rollout_bf16)


def gru_rollout_plain(cx, h0, w_hh, b_hh, g0, g_add, w_fc, b_fc, g_fc, *, ph: int) -> torch.Tensor:
    """The kernel's function in plain PyTorch → [ph, N, B, F]."""
    h, g = h0, g0
    ys = []
    for _ in range(ph):
        h = graph_gru_step(cx, h, g, w_hh, b_hh)
        ys.append(torch.tanh(gmix_nm(g_fc, gmm_nm(h, w_fc) + b_fc[:, None, :])))
        g = l1_normalize_rows(g + g_add)
    return torch.stack(ys)


def _bf16(t: torch.Tensor) -> torch.Tensor:
    """t rounded to bf16 and widened back to fp32."""
    return t.to(torch.bfloat16).float()


def gru_rollout_merged_plain(cx, h0, w_hh, b_hh, g0, g_add, w_fc, b_fc, g_fc, *,
                             ph: int) -> torch.Tensor:
    """The merged-gate bf16 kernel's function in plain PyTorch → [ph, N, B, F]
    float32, rounding where ``_rollout_kernel_merged`` rounds: cx, W_hh and
    W_fc are bf16 (rounded here if given in fp32); per step, with gc = bf16(G_t)

        hw3 = bf16(bf16(h)·W_hh + b_hh)
        r, z = bf16(σ(gc·cx + gc·hw3))                  (per gate, fp32 sums)
        n = tanh(gc·cx_n + r·(gc·hw3_n)),  h' = n − n·z + z·h      (fp32)
        y = tanh(G_fc·(bf16(h')·W_fc + b_fc))           (G_fc and y fp32)
        G_{t+1} = l1norm_rows(G_t + G_add)              (fp32)
    """
    cx, w_hh, w_fc = _bf16(cx), _bf16(w_hh), _bf16(w_fc)
    hid = h0.shape[-1]
    h, g = h0.float(), g0.float()
    ys = []
    for _ in range(ph):
        gc = _bf16(g)
        hw3 = _bf16(gmm_nm(_bf16(h), w_hh) + b_hh[:, None, :])
        xg, hg = gmix_nm(gc, cx), gmix_nm(gc, hw3)
        rz = _bf16(torch.sigmoid(xg[..., :2 * hid] + hg[..., :2 * hid]))
        r, z = rz[..., :hid], rz[..., hid:]
        n = torch.tanh(xg[..., 2 * hid:] + r * hg[..., 2 * hid:])
        h = n - n * z + z * h
        ys.append(torch.tanh(gmix_nm(g_fc, gmm_nm(_bf16(h), w_fc) + b_fc[:, None, :])))
        g = l1_normalize_rows(g + g_add)
    return torch.stack(ys)


def _checked(tensors: dict, ph: int, merged: bool) -> str:
    """The kernel's name, after the checks of a launch: shapes, dtypes,
    contiguity, no gradient, the batch and step range, the node count."""
    cx, h0, w_fc = tensors["cx"], tensors["h0"], tensors["w_fc"]
    n, b, h = h0.shape
    f = w_fc.shape[-1]
    shapes = dict(cx=(n, b, 3 * h), h0=(n, b, h), w_hh=(n, h, 3 * h), b_hh=(n, 3 * h),
                  g0=(n, n), g_add=(n, n), w_fc=(n, h, f), b_fc=(n, f), g_fc=(n, n))
    kernel = "gru_rollout_bf16" if merged else "gru_rollout"
    dtypes = {k: (torch.bfloat16 if merged and k in ("cx", "w_hh", "w_fc") else torch.float32)
              for k in tensors}
    build.check_kernel_inputs(kernel, shapes, dtypes, **tensors)
    if b == 0 or ph <= 0 or n * b * 3 * h >= 2**31:
        raise ValueError(f"{kernel}: batch {b} and ph {ph} out of the kernel's range")
    build.check_nodes(kernel, n)
    return kernel


def _launch(tensors: dict, ph: int, merged: bool) -> torch.Tensor:
    global launches, launches_bf16
    kernel = _checked(tensors, ph, merged)
    cx, h0, w_hh, w_fc, b_hh = (tensors[k] for k in ("cx", "h0", "w_hh", "w_fc", "b_hh"))
    n, b, h = h0.shape
    f = w_fc.shape[-1]
    out = torch.empty((ph, n, b, f), dtype=torch.float32, device=cx.device)
    if merged:
        entry = build.c_entry("gru_rollout_merged", "gru_rollout_bf16", 10, 10, n)
        plan = rollout_bf16_plan(n, h, f)
        pack = pack_rollout_bank_bf16 if plan.slice else None  # past NARROW_NODES: as it is
        aligned = dict(cx=cx, b_hh=b_hh)
    else:
        entry = build.c_entry("gru_rollout", "gru_rollout_f32", 10, 10, n)
        plan, pack = rollout_plan(n, h), pack_rollout_bank
        aligned = dict(w_fc=w_fc, b_hh=b_hh)
    # the bank packed into ring stages (the kernels take H = 96 only and
    # refuse other widths), the output head's bank as it is
    tensors = dict(tensors)
    if pack is not None and h % plan.slice == 0:
        tensors["w_hh"] = pack(w_hh)
    build.check_aligned(kernel, 16, w_hh=tensors["w_hh"], **aligned)
    ptrs = [t.data_ptr() for t in tensors.values()]
    status = entry(*ptrs, out.data_ptr(), n, b, h, f, ph, *plan, build.stream_of(cx))
    build.check_status(f"{kernel} at (nodes, hidden, outputs)={(n, h, f)}", status)
    if merged:
        launches_bf16 += 1
    else:
        launches += 1
    return out


ROLLOUT_ARGS = ("cx", "h0", "w_hh", "b_hh", "g0", "g_add", "w_fc", "b_fc", "g_fc")


def _fake(*args):
    tensors, ph = dict(zip(ROLLOUT_ARGS, args[:-1])), args[-1]
    if build.on_cuda(*args[:-1]):
        _checked(tensors, ph, merged=False)
        rollout_plan(tensors["h0"].shape[0], tensors["h0"].shape[-1])
    n, b, _ = tensors["h0"].shape
    return args[0].new_empty((ph, n, b, tensors["w_fc"].shape[-1]), dtype=torch.float32)


# the fp32 rollout (K1), the one on the predictor paths, as an op; the bf16
# rollout (B8, the decode check's) is called directly
gru_rollout_op = build.kernel_op(
    "gru_rollout", "(Tensor cx, Tensor h0, Tensor w_hh, Tensor b_hh, Tensor g0, Tensor g_add, "
    "Tensor w_fc, Tensor b_fc, Tensor g_fc, int ph) -> Tensor",
    lambda *args: gru_rollout_plain(*args[:-1], ph=args[-1]),
    lambda *args: _launch(dict(zip(ROLLOUT_ARGS, args[:-1])), args[-1], merged=False), _fake)


def gru_rollout(
    cx: torch.Tensor,     # [N, B, 3H] hoisted input gates (before the G mix)
    h0: torch.Tensor,     # [N, B, H]
    w_hh: torch.Tensor,   # [N, H, 3H] per-node banks
    b_hh: torch.Tensor,   # [N, 3H]
    g0: torch.Tensor,     # [N, N] row-normalized initial influence
    g_add: torch.Tensor,  # [N, N]
    w_fc: torch.Tensor,   # [N, H, F]
    b_fc: torch.Tensor,   # [N, F]
    g_fc: torch.Tensor,   # [N, N] row-normalized output-head influence
    *,
    ph: int,
    compute_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """Full rollout → [ph, N, B, F] float32.  ``compute_dtype=None`` is the
    fp32 rollout (every tensor float32), through the op ``skd::gru_rollout``;
    ``torch.bfloat16`` the merged-gate rollout (cx, w_hh and w_fc bfloat16,
    the rest float32).  CPU tensors run the plain version; CUDA tensors
    launch the kernel or raise.

    The kernels have no backward, so the wrapper refuses to build a graph on
    either device: with gradients enabled and an input that requires them it
    raises.  A decode that trains runs the step loop under autograd
    (``models.autoencoder.Decoder.forward_plain``)."""
    if compute_dtype not in (None, torch.bfloat16):
        raise TypeError(f"gru_rollout: compute_dtype must be None or bfloat16, got {compute_dtype}")
    tensors = dict(cx=cx, h0=h0, w_hh=w_hh, b_hh=b_hh, g0=g0, g_add=g_add, w_fc=w_fc,
                   b_fc=b_fc, g_fc=g_fc)
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors.values()):
        needs = sorted(k for k, t in tensors.items() if t.requires_grad)
        raise RuntimeError(f"gru_rollout has no backward, and {needs} require grad: decode "
                           "under torch.no_grad(), or train through "
                           "Decoder.forward_plain")
    if compute_dtype is None:
        return gru_rollout_op(*tensors.values(), ph)
    if build.kernel_device(**tensors) == "cpu":
        return gru_rollout_merged_plain(**tensors, ph=ph)
    return _launch(tensors, ph, merged=True)


def rollout_args(decoder, x_last2: torch.Tensor, z: torch.Tensor,
                 compute_dtype: Optional[torch.dtype] = None) -> dict:
    """``gru_rollout``'s tensors for the decoder's decode: the initial hidden
    state G·([x_{T-2}, z]·W + b) and the constant input gates [x_{T-1}, z]·W_ih
    + b_ih (fp32, hoisted out of the loop), the gathered banks and the
    normalized influences; cx and the banks rounded to bf16 for the merged
    rollout.  ``decoder`` is the port's ``models.autoencoder.Decoder``;
    x_last2 [B, 2, N, 3] are the last two observed poses, z [B, N, L].  The
    rollouts are graph-GRU rollouts: an LSTM decoder raises."""
    if decoder.is_lstm:
        raise ValueError("the rollout kernels run a graph-GRU decoder; an LSTM decoder "
                         "decodes with its plain step loop (Decoder.forward_plain)")
    x_t = x_last2[:, -1].transpose(0, 1)
    x_t_1 = x_last2[:, -2].transpose(0, 1)
    z_nm = z.transpose(0, 1)
    h0 = decoder.initial_hidden_h(torch.cat([x_t_1, z_nm], dim=-1))
    cell, fc = decoder.rollout.cell, decoder.rollout.fc
    # in float32 whatever the cell's compute dtype: the rollouts take fp32 gates
    cx = (gmm_nm(torch.cat([x_t, z_nm], dim=-1), cell.weight_ih[cell.type_index])
          + cell.bias_ih[cell.type_index][:, None, :])
    w_hh, b_hh = cell.hidden_banks()
    w_fc = fc.weight[fc.type_index]
    if compute_dtype == torch.bfloat16:
        cx, w_hh, w_fc = (t.to(torch.bfloat16) for t in (cx, w_hh, w_fc))
    return dict(cx=cx, h0=h0, w_hh=w_hh, b_hh=b_hh, g0=l1_normalize_rows(decoder.G0),
                g_add=cell.G_add, w_fc=w_fc, b_fc=fc.bias[fc.type_index], g_fc=fc.influence())


def decode_rollout(decoder, x_last2: torch.Tensor, z: torch.Tensor, ph: int, *,
                   compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """The decoder's decode → [B, ph, N, 3]: ``rollout_args``, then
    ``gru_rollout`` in ``compute_dtype``."""
    ys = gru_rollout(**rollout_args(decoder, x_last2, z, compute_dtype), ph=ph,
                     compute_dtype=compute_dtype)  # [ph,N,B,3]
    return ys.permute(2, 0, 1, 3)
