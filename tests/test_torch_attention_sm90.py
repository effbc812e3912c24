"""The host side of B2 (``joint_attention.attention_core``) on its ring of
shared-memory stages, the tensor-core attention body B2, B9b and L1 share,
B9a's stem pass (``layer_fused.stem_block``) on the whole-row engine of
``csrc/node_mix_sm90.cuh``, and L1 (``attention_core_fm.attention_core_fm``)
on its ring of TMA stages: B2's plan and shared-memory layout, its refusals
before a launch and the ints its wrapper hands the kernel; a PyTorch model of
the tensor-core body's rounding held against the Pallas kernel and the plain
version; B9a's plan, its stem bank zero-padded to 128 rows and the k-slices
the ring reads from x and then zeros; L1's plan and layout, its refusals, and
a PyTorch model of its index maps (the stage as a TMA box or the producer's
own loads fill it, its transpose as the consumer lanes write it, the store)
and of its arithmetic, held against ``scripts/attn_core_lab.py::core_fm`` in
interpret mode.  The kernels run only on the card, where ``chip_smoke.py``
holds B2, B9a and L1 against their plain versions at an even, a ragged and
an odd number of their row (L1: column) tiles.

Widths: the bench's (21 joints, 8 heads × 32, latent D 96, F 192).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skeletondiffusion_tpu.ops.pallas.joint_attention import attention_core_pallas
from skeletondiffusion_tpu_torch.ops.kernels import attention_core_fm as fm
from skeletondiffusion_tpu_torch.ops.kernels import build, joint_attention, layer_fused
from skeletondiffusion_tpu_torch.ops.kernels import node_mix_sm90 as engine

from torch_parity import KernelInputs, assert_bf16_close, load_script

N, H, DH, D, F = 21, 8, 32, 96, 192
HD = H * DH
WHOLE = ("groups", F, F)


# ---- B2: the plan ----------------------------------------------------------

def _layout_bytes(dtype, plan, heads):
    """One block's shared memory, piece by piece as ``attention_layout`` in
    ``csrc/joint_attention.cu`` places it."""
    elem = torch.empty((), dtype=dtype).element_size()
    up = lambda n: -(-n // 128) * 128  # noqa: E731
    off = 128  # 2 × 4 mbarriers, a 16-byte zero row
    row = elem * 3 * plan.group_heads * DH  # a row's q‖k‖v of the group
    node = plan.rows * row + 16  # a node's rows of the item, then 16 bytes
    return off + plan.stages * up(N * node)


def test_attention_plan_is_the_documented_one():
    """Bench: two rows of all 8 heads an item in bf16 (a node's rows are one
    bulk copy of 3 072 bytes), one row in fp32; three stages of 64 896 bytes."""
    assert tuple(joint_attention.attention_plan(torch.bfloat16, H, DH)) == (2, 8, 3, 194816)
    assert tuple(joint_attention.attention_plan(torch.float32, H, DH)) == (1, 8, 3, 194816)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("heads", [1, 2, 7, 8, 12, 16, 32])
def test_attention_plan_fits_and_matches_the_kernels_layout(dtype, heads):
    plan = joint_attention.attention_plan(dtype, heads, DH)
    elem = torch.empty((), dtype=dtype).element_size()
    assert plan.smem_bytes == _layout_bytes(dtype, plan, heads) <= joint_attention.MAX_SMEM
    assert plan.smem_bytes == joint_attention.plan_bytes(elem, plan.rows, plan.group_heads, DH,
                                                         plan.stages)
    # the kernel's conditions: the group divides the heads, two rows only of whole rows
    assert heads % plan.group_heads == 0 and plan.rows in (1, 2)
    assert plan.rows == 1 or plan.group_heads == heads
    # as many stages as fit
    assert 2 <= plan.stages <= joint_attention.MAX_STAGES
    assert plan.stages == joint_attention.MAX_STAGES or joint_attention.plan_bytes(
        elem, plan.rows, plan.group_heads, DH, plan.stages + 1) > joint_attention.MAX_SMEM
    # two rows whenever two stages of them fit; else the largest group that does
    two_rows_fit = joint_attention.plan_bytes(elem, 2, heads, DH, 2) <= joint_attention.MAX_SMEM
    assert (plan.rows == 2) == two_rows_fit
    if plan.rows == 1:
        assert all(joint_attention.plan_bytes(elem, 1, g, DH, 2) > joint_attention.MAX_SMEM
                   for g in range(plan.group_heads + 1, heads + 1) if heads % g == 0)


def test_bench_stage_puts_the_joints_of_an_ldmatrix_in_distinct_banks():
    """A node's rows in a stage are followed by 16 bytes, so joint m + 1's
    row starts 16 bytes mod 128 after joint m's: the eight rows of an
    ldmatrix (eight joints) fall in eight distinct 16-byte bank groups."""
    plan = joint_attention.attention_plan(torch.bfloat16, H, DH)
    node = 2 * plan.rows * 3 * plan.group_heads * DH + 16
    assert node % 16 == 0  # bulk copies and ldmatrix rows stay 16-byte aligned
    assert len({(m * node // 16) % 8 for m in range(8)}) == 8


@pytest.mark.parametrize("call, error, match", [
    # heads of 16 are a width of the kernel now (id kept): 24 is not one
    (lambda: joint_attention.attention_plan(torch.bfloat16, H, 24), ValueError,
     "heads of 16, 32, 64 or 128"),
    (lambda: joint_attention.attention_plan(torch.bfloat16, 0, DH), ValueError, "1 to 32 heads"),
    (lambda: joint_attention.attention_plan(torch.float32, 33, DH), ValueError, "1 to 32 heads"),
    (lambda: joint_attention.attention_plan(torch.float16, H, DH), TypeError, "built for"),
], ids=["dh16", "heads0", "heads33", "fp16"])
def test_attention_plan_refuses_what_the_kernel_does_not_take(call, error, match):
    with pytest.raises(error, match=match):
        call()


def _cuda_request(monkeypatch, entry):
    monkeypatch.setattr(build, "kernel_device", lambda **tensors: "cuda")
    monkeypatch.setattr(build, "c_entry", entry)
    monkeypatch.setattr(build, "stream_of", lambda t: 0)


@pytest.mark.parametrize("shape, heads, dim_head, error, match", [
    ((N, 4, 3 * 33 * DH), 33, DH, ValueError, "1 to 32 heads"),
    ((N, 4, 3 * H * 24), H, 24, ValueError, "heads of 16, 32, 64 or 128"),  # id kept
    # 20 joints are a build of the kernel now; past 51 the ROADMAP item
    ((52, 4, 3 * HD), H, DH, ValueError, "takes 2 to 51 nodes, got 52 .*ROADMAP"),
    ((N, 4, 3 * HD + 8), H, DH, ValueError, "qkv has shape"),
], ids=["heads33", "dh16", "nodes20", "width"])
def test_attention_core_refuses_before_launching(monkeypatch, shape, heads, dim_head, error,
                                                 match):
    """On a CUDA request the wrapper refuses what the kernel does not take
    before it names a C entry, and counts no launch."""
    _cuda_request(monkeypatch, lambda *a: pytest.fail("launched"))
    before = joint_attention.launches
    with pytest.raises(error, match=match):
        joint_attention.attention_core(torch.zeros(shape, dtype=torch.bfloat16), heads=heads,
                                       dim_head=dim_head)
    assert joint_attention.launches == before


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_attention_core_hands_the_kernel_its_plan(monkeypatch, dtype):
    """The C entry gets q‖k‖v, a new output, the widths and the plan."""
    calls = []

    def recording(library, symbol, n_pointers, n_ints, nodes=21):
        def entry(*args):
            calls.append((library, symbol, args[:n_pointers], args[n_pointers:-1]))
            return 0
        return entry

    _cuda_request(monkeypatch, recording)
    rows = 5
    qkv = torch.zeros(N, rows, 3 * HD, dtype=dtype)
    before = joint_attention.launches
    out = joint_attention.attention_core(qkv, heads=H, dim_head=DH)
    assert joint_attention.launches == before + 1
    (library, symbol, pointers, ints), = calls
    suffix = "bf16" if dtype == torch.bfloat16 else "f32"
    assert (library, symbol) == ("joint_attention", f"attention_core_{suffix}")
    assert pointers == (qkv.data_ptr(), out.data_ptr())
    assert ints == (N, rows, H, DH, DH, *joint_attention.attention_plan(dtype, H, DH))
    assert out.shape == (N, rows, HD) and out.dtype == dtype


# ---- the tensor-core body's rounding ---------------------------------------

def tensor_core_attention(qkv: torch.Tensor, heads: int, dim_head: int) -> torch.Tensor:
    """What ``head_attention_mma`` computes, in PyTorch: qs = round(q ·
    round(scale)), the products qs·k unrounded, summed in fp32 (exact products
    of bf16 values, as the tensor cores sum them), p = round(softmax), O = p·v
    in fp32, rounded."""
    n, b, _ = qkv.shape
    dt, hd = qkv.dtype, heads * dim_head
    q, k, v = (t.reshape(n, b, heads, dim_head) for t in qkv.float().split(hd, dim=-1))
    scale = torch.tensor(dim_head ** -0.5).to(dt).float()
    qs = (q * scale).to(dt).float()
    s = torch.einsum("nbhc,mbhc->bhnm", qs.double(), k.double()).float()
    p = torch.softmax(s, dim=-1).to(dt).float()
    return torch.einsum("bhnm,mbhc->nbhc", p, v).reshape(n, b, hd).to(dt)


def test_tensor_core_rounding_holds_to_pallas_and_the_plain_version():
    """The one rounding point the tensor-core body moves (each q·k product
    no longer rounded to bf16) keeps the bf16 criteria against the Pallas
    kernel in interpret mode and against the plain version, on the CPU
    tests' inputs (q‖k‖v at 1.5× the unit scale: softmax rows far from
    uniform)."""
    qkv, jqkv = KernelInputs("bfloat16", 5).act(N, 16, 3 * HD, scale=1.5)
    got = tensor_core_attention(qkv, H, DH)
    want = attention_core_pallas(jqkv, heads=H, dim_head=DH, batch_tile=8, interpret=True)
    assert_bf16_close(got.float().numpy(), np.asarray(want, dtype=np.float32), "vs Pallas")
    plain = joint_attention.attention_core_plain(qkv, H, DH)
    assert_bf16_close(got.float().numpy(), plain.float().numpy(), "vs plain")
    # in fp32 the model is the plain version up to the order of the sums
    q32 = qkv.float()
    torch.testing.assert_close(tensor_core_attention(q32, H, DH),
                               joint_attention.attention_core_plain(q32, H, DH),
                               atol=2e-6, rtol=1e-5)


# ---- B9a: the stem pass on the whole-row engine -----------------------------

@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_stem_block_plan_is_outproj_blocks(dtype):
    """B9a's contraction of 96 runs as the next multiple of 64, 128, so its
    plan is B9c's (three passes at F = 192): the same k-slice and stages."""
    assert engine.padded_width(D) == 128 and engine.padded_width(128) == 128
    assert layer_fused.stem_block_plan(dtype, D, F) == layer_fused.outproj_block_plan(dtype, HD,
                                                                                      F)


@pytest.mark.parametrize("call, error, match", [
    (lambda: layer_fused.stem_block_plan(torch.bfloat16, 100, F), ValueError, "multiple of 8"),
    (lambda: layer_fused.stem_block_plan(torch.bfloat16, 0, F), ValueError, "multiple of 8"),
    (lambda: layer_fused.stem_block_plan(torch.bfloat16, D, 160), ValueError, "multiple of 64"),
    (lambda: layer_fused.stem_block_plan(torch.float16, D, F), TypeError, "built for"),
], ids=["d100", "d0", "f160", "fp16"])
def test_stem_block_plan_refuses_what_the_kernel_does_not_take(call, error, match):
    with pytest.raises(error, match=match):
        call()


def _slice_at(dtype, kslice, cols):
    """Where element (k, c) of a k-slice lies in its packed tile (bf16: the
    tensor cores' core matrix (k/8, c/8), row c%8, column k%8; fp32
    row-major)."""
    kk = torch.arange(kslice)[:, None].expand(kslice, cols)
    col = torch.arange(cols)[None, :].expand(kslice, cols)
    if dtype == torch.bfloat16:
        return ((kk // 8) * (cols // 8) + col // 8) * 64 + (col % 8) * 8 + kk % 8
    return kk * cols + col


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_padded_stem_bank_is_w_s_then_zero_rows_and_cached(dtype):
    """The stem's bank [N, 96, F] reaches the kernel as one tile of 128 × F
    a node: rows 0–95 W_s's, rows 96–127 zero; packed once per bank."""
    rng = np.random.default_rng(6)
    ws = torch.from_numpy(rng.standard_normal((N, D, F), dtype=np.float32)).to(dtype)
    spec = ("rows", 128, WHOLE)
    packed = engine.pack(ws, spec)
    assert packed.shape == (N, 1, 128 * F) and packed.is_contiguous() and packed.dtype == dtype
    ks = layer_fused.stem_block_plan(dtype, D, F).kslice
    at = _slice_at(dtype, ks, F)
    rows = torch.cat([packed[:, 0, j * ks * F:(j + 1) * ks * F][:, at]
                      for j in range(128 // ks)], dim=1)  # [N, 128, F]
    assert torch.equal(rows[:, :D], ws) and not rows[:, D:].any()
    assert engine.pack(ws, spec) is packed
    ws.mul_(2)  # in place: a new version of the bank
    assert engine.pack(ws, spec) is not packed


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_stem_k_slices_read_x_then_zeros(dtype):
    """The ring's stem pass: k-slice j of the padded bank against the
    k-slice of x's rows, each 16-byte chunk at column j·ks + c read from x
    when below D = 96 and zero-filled past it (its source never read).
    Summing the slices' products as the kernel does gives x·W_s."""
    rng = np.random.default_rng(7)
    rows = 5
    x = torch.from_numpy(rng.standard_normal((N, rows, D), dtype=np.float32)).to(dtype)
    ws = torch.from_numpy(rng.standard_normal((N, D, F), dtype=np.float32)).to(dtype)
    plan = layer_fused.stem_block_plan(dtype, D, F)
    ks, kd = plan.kslice, engine.padded_width(D)
    vec = 16 // x.element_size()
    packed = engine.pack(ws, ("rows", kd, WHOLE))
    at = _slice_at(dtype, ks, F)
    acc = torch.zeros(N, rows, F, dtype=torch.float64)
    read = []
    for j in range(kd // ks):
        tile = packed[:, 0, j * ks * F:(j + 1) * ks * F][:, at].double()  # [N, ks, F]
        staged = torch.zeros(N, rows, ks, dtype=torch.float64)
        for c in range(0, ks, vec):  # as the producer's 16-byte chunks
            col = j * ks + c
            if col < D:
                staged[:, :, c:c + vec] = x[:, :, col:col + vec].double()
                read.append(col)
        acc += staged @ tile
    assert read == list(range(0, D, vec))  # every column of x once, nothing past it
    torch.testing.assert_close(acc, x.double() @ ws.double(), rtol=1e-12, atol=1e-9)


# ---- L1: the feature-major core on a ring of TMA stages ----------------------

def _fm_layout_bytes(dtype, plan):
    """One block's shared memory, piece by piece as ``fm_layout`` in
    ``csrc/attention_core_fm.cu`` places it."""
    elem = torch.empty((), dtype=dtype).element_size()
    up = lambda n: -(-n // 128) * 128  # noqa: E731
    box = elem * N * DH * plan.cols  # one TMA box: a joint's 32 features × cols, all joints
    col = elem * 3 * DH + 16  # a column's q‖k‖v in the transposed tile, then 16 bytes
    joint = plan.cols * col + 16
    return 128 + plan.stages * 3 * box + up(N * joint) + box  # and O, one TMA store's box


def test_fm_plan_is_the_documented_one():
    """Bench: 16 columns of one head an item in bf16, 8 in fp32 (a stage's
    (joint, feature) rows are 32 bytes either way); two stages of 64 512
    bytes, the transposed tile (bf16 70 272 bytes) and O's 21 504."""
    assert tuple(fm.fm_plan(torch.bfloat16, H, DH)) == (16, 2, 220928)
    assert tuple(fm.fm_plan(torch.float32, H, DH)) == (8, 2, 218240)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("heads", [1, 7, 8, 32])
def test_fm_plan_fits_and_matches_the_kernels_layout(dtype, heads):
    plan = fm.fm_plan(dtype, heads, DH)
    elem = torch.empty((), dtype=dtype).element_size()
    assert plan.smem_bytes == _fm_layout_bytes(dtype, plan) <= fm.MAX_SMEM
    assert plan.smem_bytes == fm.plan_bytes(elem, plan.cols, DH, plan.stages)
    assert plan.cols == fm.COLS[dtype] and plan.cols * elem == 32  # a box row: whole 16 bytes
    assert elem * N * DH * plan.cols % 128 == 0  # every TMA box lands 128-byte aligned
    assert 2 <= plan.stages <= fm.MAX_STAGES  # as many as fit
    assert plan.stages == fm.MAX_STAGES or fm.plan_bytes(elem, plan.cols, DH,
                                                         plan.stages + 1) > fm.MAX_SMEM


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_fm_transposed_tile_puts_joints_and_columns_in_distinct_banks(dtype):
    """In the transposed tile a joint's columns start 16 bytes mod 128 after
    the joint before (the body's ldmatrix rows, eight joints, fall in eight
    bank groups), and eight adjacent columns' rows fall in eight distinct
    bank groups (a transposing store writes eight columns at once)."""
    plan = fm.fm_plan(dtype, H, DH)
    elem = torch.empty((), dtype=dtype).element_size()
    col = elem * 3 * DH + 16
    joint = plan.cols * col + 16
    assert joint % 128 == 16 and col % 16 == 0
    assert len({(m * joint // 16) % 8 for m in range(8)}) == 8
    if dtype == torch.bfloat16:
        assert len({(c * col // 16) % 8 for c in range(8)}) == 8


@pytest.mark.parametrize("call, error, match", [
    (lambda: fm.fm_plan(torch.bfloat16, H, 16), ValueError, "heads of 32"),
    (lambda: fm.fm_plan(torch.bfloat16, 0, DH), ValueError, "1 to 32 heads"),
    (lambda: fm.fm_plan(torch.float32, 33, DH), ValueError, "1 to 32 heads"),
    (lambda: fm.fm_plan(torch.float16, H, DH), TypeError, "built for"),
], ids=["dh16", "heads0", "heads33", "fp16"])
def test_fm_plan_refuses_what_the_kernel_does_not_take(call, error, match):
    with pytest.raises(error, match=match):
        call()


@pytest.mark.parametrize("shape, heads, dim_head, error, match", [
    ((N, 3 * 33 * DH, 4), 33, DH, ValueError, "1 to 32 heads"),
    ((N, 3 * H * 16, 4), H, 16, ValueError, "heads of 32"),
    ((52, 3 * HD, 4), H, DH, ValueError, "takes 2 to 51 nodes, got 52 .*Queue B item 9"),
    ((N, 3 * HD + 8, 4), H, DH, ValueError, "qkv has shape"),
], ids=["heads33", "dh16", "nodes52", "width"])
def test_attention_core_fm_refuses_before_launching(monkeypatch, shape, heads, dim_head, error,
                                                    match):
    """On a CUDA request L1's wrapper refuses what the kernel does not take
    before it names a C entry, and counts no launch."""
    _cuda_request(monkeypatch, lambda *a: pytest.fail("launched"))
    before = fm.launches
    with pytest.raises(error, match=match):
        fm.attention_core_fm(torch.zeros(shape, dtype=torch.bfloat16), heads=heads,
                             dim_head=dim_head)
    assert fm.launches == before


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_attention_core_fm_hands_the_kernel_its_plan(monkeypatch, dtype):
    """The C entry gets q‖k‖v, a new output, the widths and the plan."""
    calls = []

    def recording(library, symbol, n_pointers, n_ints, nodes=21):
        def entry(*args):
            calls.append((library, symbol, args[:n_pointers], args[n_pointers:-1]))
            return 0
        return entry

    _cuda_request(monkeypatch, recording)
    rows = 5
    qkv = torch.zeros(N, 3 * HD, rows, dtype=dtype)
    before = fm.launches
    out = fm.attention_core_fm(qkv, heads=H, dim_head=DH)
    assert fm.launches == before + 1
    (library, symbol, pointers, ints), = calls
    suffix = "bf16" if dtype == torch.bfloat16 else "f32"
    assert (library, symbol) == ("attention_core_fm", f"attention_core_fm_{suffix}")
    assert pointers == (qkv.data_ptr(), out.data_ptr())
    assert ints == (N, rows, H, DH, *fm.fm_plan(dtype, H, DH))
    assert out.shape == (N, HD, rows) and out.dtype == dtype


def _fm_box(qkv, heads, cols, b0, h):
    """What the three TMA copies of an item bring: [q|k|v][joint][feature]
    [column] of head h, columns b0 …, zeros past the batch."""
    rows, hd = qkv.shape[2], heads * DH
    box = torch.zeros(3, N, DH, cols, dtype=qkv.dtype)
    valid = min(cols, rows - b0)
    for part in range(3):
        c0 = part * hd + h * DH
        box[part, :, :, :valid] = qkv[:, c0:c0 + DH, b0:b0 + valid]
    return box


def _fm_producer_fill(qkv, heads, cols, b0, h):
    """The stage as the producer warp's own loads fill it (``load_stage``):
    element e of the stage from q‖k‖v row (joint·3 + part)·hd + h·32 +
    feature, column b0 + e % cols, zero past the batch."""
    rows, hd = qkv.shape[2], heads * DH
    flat = qkv.reshape(-1)
    e = torch.arange(3 * N * DH * cols)
    col, row = e % cols, e // cols
    f, pj = row % DH, row // DH
    part, j = pj // N, pj % N
    src = (j * 3 * hd + part * hd + h * DH + f) * rows + b0 + col
    inside = b0 + col < rows
    st = torch.zeros(e.numel(), dtype=qkv.dtype)
    st[inside] = flat[src[inside]]
    return st.reshape(3, N, DH, cols)


def _fm_transpose(stage, cols):
    """The transposed tile [joint][column][q‖k‖v] as ``transpose_stage``'s
    lanes write it.  bf16: a warp's unit u (part·N + joint, feature half u%2)
    loads four 8 × 8 matrices with ldmatrix.x4.trans (matrix m's row i from
    lane 8m + i: feature 16·half + 8·(m >> 1) + i, columns 8·(m & 1) …);
    lane t then holds matrix m's rows 2·(t%4), + 1 at column t/4 and writes
    them as one 4-byte pair.  fp32: lane = feature, a float4 of four
    columns."""
    tt = torch.zeros(N, cols, 3 * DH, dtype=stage.dtype)
    flat = stage.reshape(3 * N, DH, cols)
    lanes = torch.arange(32)
    if stage.dtype == torch.bfloat16:
        for u in range(3 * N * 2):
            half, pj = u & 1, u >> 1
            part, j = pj // N, pj % N
            for m in range(4):
                # the matrix as its eight row addresses give it: features × columns
                feats = 16 * half + 8 * (m >> 1) + torch.arange(8)
                mat = flat[pj][feats][:, 8 * (m & 1):8 * (m & 1) + 8]
                r0, c = 2 * (lanes % 4), lanes // 4  # what .trans hands lane t
                col = 8 * (m & 1) + (lanes >> 2)
                ff = part * DH + 16 * half + 8 * (m >> 1) + 2 * (lanes & 3)
                tt[j, col, ff] = mat[r0, c]
                tt[j, col, ff + 1] = mat[r0 + 1, c]
    else:
        for u in range(3 * N * (cols // 4)):
            quad, pj = u % (cols // 4), u // (cols // 4)
            part, j = pj // N, pj % N
            v = flat[pj][lanes, 4 * quad:4 * quad + 4]  # [lane, 4]
            for i in range(4):
                tt[j, 4 * quad + i, part * DH + lanes] = v[:, i]
    return tt


def _fm_stage_o(tt, cols):
    """O (each column's q rows of the transposed tile) → [joint][feature]
    [column], the box of the TMA store, as ``stage_o``'s lanes write it.
    bf16: unit u (joint u/2, feature half u%2) loads four 8 × 8 matrices with
    ldmatrix.x4.trans (matrix m's row i from lane 8m + i: column 8·(m & 1) +
    i, features 16·half + 8·(m >> 1) …); lane t then holds matrix m's rows
    2·(t%4), + 1 at feature t/4 and writes them as one 4-byte pair.  fp32:
    lane = feature, four columns a float4."""
    os_ = torch.zeros(N, DH, cols, dtype=tt.dtype)
    lanes = torch.arange(32)
    if tt.dtype == torch.bfloat16:
        for u in range(N * 2):
            half, j = u & 1, u >> 1
            for m in range(4):
                mat = tt[j, 8 * (m & 1):8 * (m & 1) + 8,
                         16 * half + 8 * (m >> 1):16 * half + 8 * (m >> 1) + 8]  # columns × features
                r0, c = 2 * (lanes % 4), lanes // 4
                f = 16 * half + 8 * (m >> 1) + (lanes >> 2)
                col = 8 * (m & 1) + 2 * (lanes & 3)
                os_[j, f, col] = mat[r0, c]
                os_[j, f, col + 1] = mat[r0 + 1, c]
    else:
        for u in range(N * (cols // 4)):
            quad, j = u % (cols // 4), u // (cols // 4)
            for i in range(4):
                os_[j, lanes, 4 * quad + i] = tt[j, 4 * quad + i, lanes]
    return os_


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_fm_index_maps_compute_the_core(dtype):
    """A model of the kernel's index maps at a ragged batch (37 columns: the
    last bf16 tile holds 5, the last fp32 tile 5) and two heads: the
    producer's own loads fill the stage the TMA box would; the lanes'
    transpose gives every column's q‖k‖v of all joints; the body (the
    tensor-core model in bf16, the plain core in fp32) on each valid column,
    O's staging into the TMA store's box (clipped to the batch) and the
    direct store of a batch no tensor map addresses give the plain version's
    function exactly."""
    heads, rows = 2, 37
    rng = np.random.default_rng(8)
    qkv = torch.from_numpy(0.5 * rng.standard_normal((N, 3 * heads * DH, rows),
                                                     dtype=np.float32)).to(dtype)
    cols = fm.COLS[dtype]
    out = torch.zeros(N, heads * DH, rows, dtype=dtype)
    body = tensor_core_attention if dtype == torch.bfloat16 else joint_attention.attention_core_plain
    for item in range(-(-rows // cols) * heads):
        b0, h = item // heads * cols, item % heads
        valid = min(cols, rows - b0)
        stage = _fm_box(qkv, heads, cols, b0, h)
        assert torch.equal(_fm_producer_fill(qkv, heads, cols, b0, h), stage)
        tt = _fm_transpose(stage, cols)
        assert torch.equal(tt.reshape(N, cols, 3, DH).permute(2, 0, 3, 1), stage)
        tt[:, :valid, :DH] = body(tt[:, :valid].contiguous(), 1, DH)  # O over q's rows
        # the TMA store's box as stage_o's lanes fill it, clipped to the batch
        box = _fm_stage_o(tt, cols)
        out[:, h * DH:(h + 1) * DH, b0:b0 + valid] = box[:, :, :valid]
        # store_item, the store of a batch no tensor map addresses: the same
        e = torch.arange(N * DH * cols)  # consecutive threads on columns
        col, f, j = e % cols, e // cols % DH, e // (cols * DH)
        keep = col < valid
        direct = torch.zeros_like(out)
        direct.view(-1)[((j * heads * DH + h * DH + f) * rows + b0 + col)[keep]] = \
            tt[j[keep], col[keep], f[keep]]
        assert torch.equal(direct[:, h * DH:(h + 1) * DH, b0:b0 + valid],
                           out[:, h * DH:(h + 1) * DH, b0:b0 + valid])
    want = body(qkv.transpose(1, 2).contiguous(), heads, DH).transpose(1, 2)
    assert torch.equal(out, want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fm_model_holds_to_core_fm_and_the_plain_version(dtype):
    """L1's arithmetic, B2's bodies on the transposed layout (bf16: q·k
    products unrounded on the tensor cores), against ``core_fm`` in interpret
    mode and the plain version: bf16 at the bf16 criteria on q‖k‖v at 1.5×
    the unit scale (softmax rows far from uniform), fp32 at the lab's atol
    2e-5."""
    lab = load_script("attn_core_lab")
    heads, rows = 2, 128
    x = 1.5 * np.random.default_rng(14).standard_normal((N, 3 * heads * DH, rows),
                                                        dtype=np.float32)
    jx = jnp.asarray(x).astype(dtype)
    want = np.asarray(lab.core_fm(jx, heads=heads, dim_head=DH, interpret=True), np.float32)
    qkv = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(getattr(torch, dtype))
    bm = qkv.transpose(1, 2).contiguous()
    if dtype == "bfloat16":
        got = tensor_core_attention(bm, heads, DH).transpose(1, 2)
        assert_bf16_close(got.float().numpy(), want, "vs core_fm")
        plain = fm.attention_core_fm_plain(qkv, heads, DH)
        assert_bf16_close(got.float().numpy(), plain.float().numpy(), "vs plain")
    else:
        got = joint_attention.attention_core_plain(bm, heads, DH).transpose(1, 2)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-5)
