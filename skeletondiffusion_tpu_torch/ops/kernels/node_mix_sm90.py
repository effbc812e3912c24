"""The host side of ``csrc/node_mix_sm90.cuh``, the product-and-mix engine
of B3a (``attention_proj.rms_qkv``), B9b (``layer_fused.rms_qkv_core``), B1
(``resnet_block.resnet_block``), B9c (``layer_fused.outproj_block``), B4
(``graph_linear_fused.graph_linear_fused``), B9a (``layer_fused.stem_block``),
B3b (``attention_proj.outproj_res``), B5a and B5b
(``resnet_block.final_block_in``, ``final_block_out``): the tile plans the
kernels are launched with, and the weight banks packed into the contiguous
tiles that one bulk copy brings into shared memory (``cached_pack`` also
keeps the decode rollouts' packed banks, ``gru_rollout.pack_rollout_bank``
and ``pack_rollout_bank_bf16``).

B3a and B9b take items of a row tile × a column group (``plan``); B1, B9c,
B4, B9a, B3b, B5a and B5b, whose products contract over all input columns of
each node into all F output columns (B5b's head into fewer: its bank and
bias zero-padded to F, ``check_out_width``; the stem of B4 and B9a over
D = 96 rows zero-padded to 128, ``narrow_width``), items of a row tile ×
every column, their banks streamed in k-slices (``block_plan``).

Pure PyTorch; the plan is what the kernels' ``layout`` computes, and a
kernel refuses (``cudaErrorInvalidValue``) a plan it was not built for.  The
plans take the skeleton's node count (``nodes``, 2 to ``build.MAX_NODES``;
21 unless given), the kernels' build parameter: P and the fp32 influences
have a plane or row a node.  Past ``build.NARROW_NODES`` the bf16 tiles
shrink (``block_rows``; B3a's and B9b's in their modules); a plan that does
not fit raises, naming ROADMAP Queue B item 10 (the fp32 tiles at 51
nodes).
"""
from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch

from . import build

MAX_SMEM = 232448     # bytes of dynamic shared memory a block may have (227 KB)
MAX_STAGES = 4        # mbarrier pairs the kernels reserve
N_NODES = build.DEFAULT_NODES
MAX_F = 256           # the widest input row the kernels normalise (in registers)
PLANE_PAD = 16        # bytes after each node's plane of products
CLUSTER = 2           # blocks a cluster: adjacent row tiles that share each weight tile


class TilePlan(NamedTuple):
    """Rows an item, output columns a group, ring stages, blocks a cluster
    and dynamic shared-memory bytes of one launch."""
    rows: int
    cols: int
    stages: int
    cluster: int
    smem_bytes: int


def _up(n: int) -> int:
    return (n + 127) & ~127


def g_stride(nodes: int) -> int:
    """fp32 influence rows padded to whole float4s (``kGStride``)."""
    return -(-nodes // 4) * 4


def plan_bytes(elem: int, rows: int, cols: int, f: int, stages: int,
               nodes: int = N_NODES) -> int:
    """Shared memory of one block (``layout`` in ``node_mix_sm90.cuh``):
    barriers and a zero row, the fp32 influence (fp32 only), ``stages`` ×
    (input rows + weight tile), the products of all nodes."""
    g_mix = _up(4 * nodes * g_stride(nodes)) if elem == 4 else 0
    stage = _up(rows * f * elem) + _up(f * cols * elem)
    plane = rows * cols * elem + PLANE_PAD
    return 128 + g_mix + stages * stage + _up(nodes * plane)


def plan(kernel: str, dtype: torch.dtype, rows: int, cols: int, f: int,
         nodes: int = N_NODES) -> TilePlan:
    """The plan of ``rows`` × ``cols`` tiles at input width ``f`` and
    ``nodes`` nodes: as many ring stages (2 to 4) as fit; raises ValueError
    when two do not, or when f exceeds MAX_F or the node count the kernels'
    range."""
    elem = torch.empty((), dtype=dtype).element_size()
    build.check_nodes(kernel, nodes)
    if f > MAX_F:
        raise ValueError(f"{kernel}: F={f} exceeds {MAX_F}, the widest row the kernels "
                         f"normalise")
    fits = [s for s in range(2, MAX_STAGES + 1)
            if plan_bytes(elem, rows, cols, f, s, nodes) <= MAX_SMEM]
    if not fits:
        raise ValueError(f"{kernel}: a {rows} × {cols} tile at F={f} and {nodes} nodes in "
                         f"{dtype} does not fit {MAX_SMEM} bytes of shared memory with two "
                         f"stages ({NO_FIT})")
    return TilePlan(rows, cols, fits[-1], CLUSTER,
                    plan_bytes(elem, rows, cols, f, fits[-1], nodes))


# rows of a ResnetBlock item up to build.NARROW_NODES and past it, and the
# k-slices of its banks, widest first
BLOCK_ROWS = {torch.bfloat16: 16, torch.float32: 8}
BLOCK_ROWS_WIDE = {torch.bfloat16: 8, torch.float32: 8}
KSLICES = (64, 32)
NO_FIT = "ROADMAP.md Queue B item 10"


def block_rows(dtype: torch.dtype, nodes: int = N_NODES) -> int:
    """Rows of a whole-row item (``BlockRows`` in ``node_mix_sm90.cuh``)."""
    return (BLOCK_ROWS_WIDE if build.wide(nodes) else BLOCK_ROWS)[dtype]


class BlockPlan(NamedTuple):
    """Rows an item, bank rows a ring stage (the k-slice), ring stages,
    blocks a cluster and dynamic shared-memory bytes of one ResnetBlock
    launch."""
    rows: int
    kslice: int
    stages: int
    cluster: int
    smem_bytes: int


def block_plan_bytes(elem: int, rows: int, f: int, kslice: int, stages: int, mixes: int,
                     nodes: int = N_NODES) -> int:
    """Shared memory of one ResnetBlock block (``block_layout`` in
    ``node_mix_sm90.cuh``): barriers and a zero row, the fp32 influences
    (fp32 only), FiLM's fp32 scale + 1 and shift, ``stages`` × (a k-slice of
    the input rows, rows padded by 16 bytes + a k-slice of the bank), the
    products of all nodes (rows padded by 16 bytes, planes by PLANE_PAD)."""
    pad = 16 // elem
    g_mix = _up(4 * nodes * g_stride(nodes) * mixes) if elem == 4 else 0
    stage = _up(rows * (kslice + pad) * elem) + _up(kslice * f * elem)
    plane = rows * (f + pad) * elem + PLANE_PAD
    return 128 + g_mix + _up(8 * f) + stages * stage + _up(nodes * plane)


def block_plan(kernel: str, dtype: torch.dtype, f: int, ks: Tuple[int, ...],
               nodes: int = N_NODES) -> BlockPlan:
    """The plan of a kernel whose passes contract over ``ks`` into ``f``
    columns at ``nodes`` nodes: the widest k-slice that divides every width
    and fits two ring stages beside the products, with as many stages (2 to
    4) as fit; raises ValueError for what the kernel does not take."""
    build.element_suffix(kernel, dtype)
    build.check_nodes(kernel, nodes)
    elem = torch.empty((), dtype=dtype).element_size()
    if f <= 0 or f % 64 or f > MAX_F:
        raise ValueError(f"{kernel}: F={f} must be a positive multiple of 64 up to {MAX_F}")
    if any(k <= 0 or k % KSLICES[-1] for k in ks):
        raise ValueError(f"{kernel}: the contraction widths {ks} must be positive multiples of "
                         f"{KSLICES[-1]}")
    rows = block_rows(dtype, nodes)
    for kslice in KSLICES:
        if any(k % kslice for k in ks):
            continue
        fits = [s for s in range(2, MAX_STAGES + 1)
                if block_plan_bytes(elem, rows, f, kslice, s, len(ks), nodes) <= MAX_SMEM]
        if fits:
            return BlockPlan(rows, kslice, fits[-1], CLUSTER,
                             block_plan_bytes(elem, rows, f, kslice, fits[-1], len(ks), nodes))
    raise ValueError(f"{kernel}: a {rows}-row tile at F={f} and {nodes} nodes in {dtype} does "
                     f"not fit {MAX_SMEM} bytes of shared memory with two stages ({NO_FIT})")


def padded_width(k: int) -> int:
    """A contraction width rounded up to the widest k-slice (the stem of B4
    and B9a: its bank's rows past ``k`` zero, its input's columns zero-filled
    by the kernel), so that a narrow pass keeps its kernel's k-slice."""
    return -(-k // KSLICES[0]) * KSLICES[0]


def narrow_width(kernel: str, k: int) -> int:
    """``padded_width(k)`` of a narrow pass's input width ``k``; raises
    ValueError unless k is a positive multiple of 8 (the kernels' producer
    copies and zero-fills whole 16-byte chunks)."""
    if k <= 0 or k % 8:
        raise ValueError(f"{kernel}: D={k} must be a positive multiple of 8")
    return padded_width(k)


def check_out_width(kernel: str, dtype: torch.dtype, f: int, cols: int) -> None:
    """Raise ValueError unless a pass of ``cols`` output columns at width
    ``f`` (B5b's head) is one the kernels store: up to ``f`` in whole 16-byte
    chunks, as ``out_cols_ok`` in ``node_mix_sm90.cuh`` requires."""
    vec = 16 // torch.empty((), dtype=dtype).element_size()
    if cols <= 0 or cols > f or cols % vec:
        raise ValueError(f"{kernel}: an output width of {cols} must be a positive multiple of "
                         f"{vec} up to F={f}")


def group_columns(out: int, cols: int) -> torch.Tensor:
    """[⌈out/cols⌉, cols]: consecutive groups of ``cols`` columns, the last
    padded with −1 (zero columns)."""
    groups = -(-out // cols)
    idx = torch.arange(groups * cols).reshape(groups, cols)
    return torch.where(idx < out, idx, -1)


def head_columns(heads: int, dim_head: int) -> torch.Tensor:
    """[heads, 3·dim_head]: head h's q, k and v columns of a q‖k‖v bank."""
    hd = heads * dim_head
    one = torch.arange(dim_head)
    return torch.stack([torch.cat([h * dim_head + one, hd + h * dim_head + one,
                                   2 * hd + h * dim_head + one]) for h in range(heads)])


COLUMNS = {"groups": group_columns, "heads": head_columns}

# (id, version, data pointer, shape, dtype, device, spec) → (bank, packed):
# the bank is held so that its id and storage are not reused while cached
_PACKED: Dict[Tuple, Tuple[torch.Tensor, torch.Tensor]] = {}
_PACKED_MAX = 64


def cached_pack(w: torch.Tensor, spec: Tuple, pack: Callable[[torch.Tensor], torch.Tensor]
                ) -> torch.Tensor:
    """``pack(w)``, cached for the bank as it is (its identity and version
    counter) and ``spec``, the packing's name and arguments: a caller that
    keeps its weights packs them once.  Inference tensors, which keep no
    version counter, are packed at every call."""
    try:
        version = w._version
    except RuntimeError:  # inference tensors keep no version counter
        version = None
    key = (id(w), version, w.data_ptr(), tuple(w.shape), w.dtype, w.device, spec)
    if version is not None and key in _PACKED:
        return _PACKED[key][1]
    packed = pack(w)
    if version is not None:
        if len(_PACKED) >= _PACKED_MAX:
            _PACKED.pop(next(iter(_PACKED)))
        _PACKED[key] = (w, packed)
    return packed


def _pack_tiles(w: torch.Tensor, columns: Tuple, k: Optional[int] = None) -> torch.Tensor:
    if k is not None:  # bank rows past the contraction width zero
        w = torch.nn.functional.pad(w, (0, 0, 0, k - w.shape[1]))
    idx = COLUMNS[columns[0]](*columns[1:])
    n, f, out = w.shape
    g, c = idx.shape
    padded = torch.cat([w, w.new_zeros(n, f, 1)], dim=-1)  # column `out` is zero
    idx = torch.where(idx < 0, out, idx).to(w.device)
    t = padded[:, :, idx.reshape(-1)].reshape(n, f, g, c)
    if w.dtype == torch.float32:
        return t.permute(0, 2, 1, 3).contiguous().reshape(n, g, f * c)
    return (t.reshape(n, f // 8, 8, g, c // 8, 8).permute(0, 3, 1, 4, 5, 2)
            .contiguous().reshape(n, g, f * c))


def pack_banks(w: torch.Tensor, columns: Tuple, k: Optional[int] = None) -> torch.Tensor:
    """Per-node banks w [N, F, out] → [N, G, F·C] tiles, one contiguous tile
    per node and group of the columns ``COLUMNS[columns[0]](*columns[1:])``
    [G, C] (−1: a zero column): for bf16 in the tensor cores' canonical
    K-major layout (8 × 8 core matrices, [F/8][C/8][8 columns][8 k]), for
    fp32 row-major [F][C].  With ``k``, the bank's rows are zero-padded to k
    first (F = k in the tiles).  Cached per bank (``cached_pack``)."""
    spec = ("tiles", columns) if k is None else ("tiles", columns, k)
    return cached_pack(w, spec, lambda t: _pack_tiles(t, columns, k))


def pad_columns(b: torch.Tensor, cols: int) -> torch.Tensor:
    """A bias b [N, out] → [N, cols], zeros past ``out`` (the bias of a pass
    whose bank is packed into ``cols`` columns).  Cached per bias
    (``cached_pack``)."""
    return cached_pack(b, ("pad", cols),
                       lambda t: torch.nn.functional.pad(t, (0, cols - t.shape[-1])))


def pack(t: torch.Tensor, spec: Tuple) -> torch.Tensor:
    """``t`` as a kernel reads it: a bias zero-padded to ``spec[1]`` columns
    for ``("pad", cols)``, a bank with its rows zero-padded to ``k`` and
    packed into the tiles of ``columns`` for ``("rows", k, columns)``, else a
    bank packed into the tiles of the columns spec (``pack_banks``)."""
    if spec[0] == "pad":
        return pad_columns(t, spec[1])
    if spec[0] == "rows":
        return pack_banks(t, spec[2], spec[1])
    return pack_banks(t, spec)


def check(kernel: str, tensors: Dict[str, Optional[torch.Tensor]], shapes: Dict,
          dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    """The given tensors (None: an input the kernel goes without), checked
    against ``shapes`` and ``dtype`` (``build.check_kernel_inputs``): what a
    launch and its op's fake implementation both check."""
    given = {k: t for k, t in tensors.items() if t is not None}
    build.check_kernel_inputs(kernel, shapes, dtype, **given)
    return given


def launch(library: str, kernel: str, tensors: Dict[str, Optional[torch.Tensor]], shapes: Dict,
           packs: Dict[str, Tuple], ints: Tuple[int, ...], *outs: torch.Tensor) -> None:
    """Check ``tensors``, pack each one named in ``packs`` by its spec
    (``pack``) and launch ``<kernel>_<bf16|f32>`` of ``csrc/<library>.cu``
    built at ``ints[0]`` nodes on the tensors in their order (None: a null
    pointer, an input the kernel goes without), ``outs`` and ``ints`` (the
    node count and widths, then the tile plan); raises unless the launch
    succeeded."""
    dt = outs[0].dtype
    suffix = build.element_suffix(kernel, dt)
    given = check(kernel, tensors, shapes, dt)
    packed = {k: pack(t, packs[k]) if k in packs else t for k, t in given.items()}
    build.check_aligned(kernel, 32, **packed)
    pointers = [packed[k].data_ptr() if k in packed else None for k in tensors]
    status = build.c_entry(library, f"{kernel}_{suffix}", len(tensors) + len(outs), len(ints),
                           ints[0])(
        *pointers, *(t.data_ptr() for t in outs), *ints, build.stream_of(outs[0]))
    build.check_status(f"{kernel} at (nodes, rows, widths, plan)={ints}", status)
