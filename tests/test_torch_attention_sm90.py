"""The host side of B2 (``joint_attention.attention_core``) on its ring of
shared-memory stages, the tensor-core attention body B2 and B9b share, and
B9a's stem pass (``layer_fused.stem_block``) on the whole-row engine of
``csrc/node_mix_sm90.cuh``: B2's plan and shared-memory layout, its refusals
before a launch and the ints its wrapper hands the kernel; a PyTorch model of
the tensor-core body's rounding held against the Pallas kernel and the plain
version; B9a's plan, its stem bank zero-padded to 128 rows and the k-slices
the ring reads from x and then zeros.  The kernels run only on the card,
where ``chip_smoke.py`` holds B2 and B9a against their plain versions at an
even, a ragged and an odd number of their row tiles.

Widths: the bench's (21 joints, 8 heads × 32, latent D 96, F 192).
"""
import numpy as np
import pytest
import torch

from skeletondiffusion_tpu.ops.pallas.joint_attention import attention_core_pallas
from skeletondiffusion_tpu_torch.ops.kernels import build, joint_attention, layer_fused
from skeletondiffusion_tpu_torch.ops.kernels import node_mix_sm90 as engine

from torch_parity import KernelInputs, assert_bf16_close

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
    (lambda: joint_attention.attention_plan(torch.bfloat16, H, 16), ValueError, "heads of 32"),
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
    ((N, 4, 3 * H * 16), H, 16, ValueError, "heads of 32"),
    ((20, 4, 3 * HD), H, DH, ValueError, "takes 21 nodes, got 20"),
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

    def recording(library, symbol, n_pointers, n_ints):
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
    assert ints == (N, rows, H, DH, *joint_attention.attention_plan(dtype, H, DH))
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
