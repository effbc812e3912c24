"""The host side of B1 (``resnet_block``), B9c (``outproj_block``), B9a
(``stem_block``), B4 (``graph_linear_fused``), B3b (``outproj_res``), B5a
(``final_block_in``) and B5b (``final_block_out``) on the whole-row items of
``csrc/node_mix_sm90.cuh``: their tile plans (B4's, B9a's stem pass alone),
the packed banks the ring streams in k-slices (B5a's from two sources, x and
r; B5b's head bank and bias zero-padded to F; the stem bank of B9a and B4
zero-padded to 128 rows, ``tests/test_torch_attention_sm90.py``), and the
wrappers' refusals.  The kernels' walk over row tiles and two-block clusters
runs only on the card, where ``chip_smoke.py`` holds all seven against their
plain versions at an even, a ragged and an odd number of row tiles, and B4's
output against B9a's r bit for bit.

Widths: the bench's (F 192, the attention's 8 heads × 32 = 256, the head's
and the stem's latent 96).
"""
import numpy as np
import pytest
import torch

from skeletondiffusion_tpu_torch.ops.kernels import attention_proj, build, graph_linear_fused
from skeletondiffusion_tpu_torch.ops.kernels import layer_fused, resnet_block
from skeletondiffusion_tpu_torch.ops.kernels import node_mix_sm90 as engine

N, F, HD, FO = 21, 192, 256, 96
WHOLE = ("groups", F, F)
HEAD = ("groups", FO, F)  # the head bank packed into F columns, zero past 96


def _layout_bytes(dtype, plan, f, ks):
    """One block's shared memory, laid out piece by piece as ``block_layout``
    in ``csrc/node_mix_sm90.cuh`` places it."""
    elem = torch.empty((), dtype=dtype).element_size()
    up = lambda n: -(-n // 128) * 128  # noqa: E731
    pad = 16 // elem  # a row of P and of a staged slice: 16 bytes more
    off = 128  # 2 × 4 mbarriers, a 16-byte zero row
    off += up(4 * N * 24 * len(ks)) if elem == 4 else 0  # fp32 influences, rows of 24
    off += up(4 * 2 * f)  # FiLM's scale + 1 and shift in fp32
    stage = up(elem * plan.rows * (plan.kslice + pad)) + up(elem * plan.kslice * f)
    off += plan.stages * stage
    plane = elem * plan.rows * (f + pad) + 16
    return off + up(N * plane)


def _plans():
    return {
        ("resnet_block", torch.bfloat16): (resnet_block.resnet_block_plan(torch.bfloat16, F),
                                           (F, F)),
        ("resnet_block", torch.float32): (resnet_block.resnet_block_plan(torch.float32, F),
                                          (F, F)),
        ("outproj_block", torch.bfloat16): (layer_fused.outproj_block_plan(torch.bfloat16, HD, F),
                                            (HD, F, F)),
        ("outproj_block", torch.float32): (layer_fused.outproj_block_plan(torch.float32, HD, F),
                                           (HD, F, F)),
        ("outproj_res", torch.bfloat16): (attention_proj.outproj_res_plan(torch.bfloat16, HD, F),
                                          (HD,)),
        ("outproj_res", torch.float32): (attention_proj.outproj_res_plan(torch.float32, HD, F),
                                         (HD,)),
        ("final_block_in", torch.bfloat16): (resnet_block.final_block_in_plan(torch.bfloat16, F),
                                             (2 * F, 2 * F)),
        ("final_block_in", torch.float32): (resnet_block.final_block_in_plan(torch.float32, F),
                                            (2 * F, 2 * F)),
        ("final_block_out", torch.bfloat16): (
            resnet_block.final_block_out_plan(torch.bfloat16, F, FO), (F, F)),
        ("final_block_out", torch.float32): (
            resnet_block.final_block_out_plan(torch.float32, F, FO), (F, F)),
        # the stem's contraction of 96 padded to 128 (engine.padded_width)
        ("stem_block", torch.bfloat16): (layer_fused.stem_block_plan(torch.bfloat16, FO, F),
                                         (128, F, F)),
        ("stem_block", torch.float32): (layer_fused.stem_block_plan(torch.float32, FO, F),
                                        (128, F, F)),
        # B9a's stem pass alone
        ("graph_linear_fused", torch.bfloat16): (
            graph_linear_fused.graph_linear_fused_plan(torch.bfloat16, FO, F), (128,)),
        ("graph_linear_fused", torch.float32): (
            graph_linear_fused.graph_linear_fused_plan(torch.float32, FO, F), (128,)),
    }


def test_bench_plans_are_the_documented_ones():
    plans = {k: tuple(v[0]) for k, v in _plans().items()}
    assert plans == {
        ("resnet_block", torch.bfloat16): (16, 64, 3, 2, 217088),
        ("resnet_block", torch.float32): (8, 32, 3, 2, 215040),
        ("outproj_block", torch.bfloat16): (16, 64, 3, 2, 217088),
        ("outproj_block", torch.float32): (8, 32, 3, 2, 217088),
        ("outproj_res", torch.bfloat16): (16, 64, 3, 2, 217088),
        ("outproj_res", torch.float32): (8, 32, 3, 2, 212992),
        ("final_block_in", torch.bfloat16): (16, 64, 3, 2, 217088),
        ("final_block_in", torch.float32): (8, 32, 3, 2, 215040),
        ("final_block_out", torch.bfloat16): (16, 64, 3, 2, 217088),
        ("final_block_out", torch.float32): (8, 32, 3, 2, 215040),
        ("stem_block", torch.bfloat16): (16, 64, 3, 2, 217088),  # B9c's
        ("stem_block", torch.float32): (8, 32, 3, 2, 217088),
        ("graph_linear_fused", torch.bfloat16): (16, 64, 3, 2, 217088),  # B9a's
        ("graph_linear_fused", torch.float32): (8, 32, 3, 2, 212992),  # one fp32 influence
    }


@pytest.mark.parametrize("kernel, dtype", [("resnet_block", torch.bfloat16),
                                           ("resnet_block", torch.float32),
                                           ("outproj_block", torch.bfloat16),
                                           ("outproj_block", torch.float32),
                                           ("outproj_res", torch.bfloat16),
                                           ("outproj_res", torch.float32),
                                           ("final_block_in", torch.bfloat16),
                                           ("final_block_in", torch.float32),
                                           ("final_block_out", torch.bfloat16),
                                           ("final_block_out", torch.float32),
                                           ("stem_block", torch.bfloat16),
                                           ("stem_block", torch.float32),
                                           ("graph_linear_fused", torch.bfloat16),
                                           ("graph_linear_fused", torch.float32)])
def test_block_plans_fit_and_match_the_kernels_layout(kernel, dtype):
    plan, ks = _plans()[(kernel, dtype)]
    elem = torch.empty((), dtype=dtype).element_size()
    assert plan.smem_bytes == _layout_bytes(dtype, plan, F, ks) <= engine.MAX_SMEM == 232448
    assert plan.smem_bytes == engine.block_plan_bytes(elem, plan.rows, F, plan.kslice,
                                                      plan.stages, len(ks))
    assert plan.rows == engine.BLOCK_ROWS[dtype] and plan.cluster == engine.CLUSTER == 2
    assert all(k % plan.kslice == 0 for k in ks)
    # as many stages as fit, and no wider k-slice fits two
    assert 2 <= plan.stages <= engine.MAX_STAGES
    assert plan.stages == engine.MAX_STAGES or engine.block_plan_bytes(
        elem, plan.rows, F, plan.kslice, plan.stages + 1, len(ks)) > engine.MAX_SMEM
    for wider in (k for k in engine.KSLICES if k > plan.kslice):
        assert engine.block_plan_bytes(elem, plan.rows, F, wider, 2, len(ks)) > engine.MAX_SMEM
    if dtype == torch.bfloat16:  # each weight byte from L2 serves the cluster's 32 rows
        assert plan.rows * plan.cluster == 32 and plan.kslice == 64


@pytest.mark.parametrize("call, match", [
    (lambda: resnet_block.resnet_block_plan(torch.bfloat16, 96), "multiple of 64"),
    (lambda: resnet_block.resnet_block_plan(torch.bfloat16, 320), "multiple of 64 up to 256"),
    (lambda: resnet_block.resnet_block_plan(torch.float32, 256), "does not fit"),
    (lambda: layer_fused.outproj_block_plan(torch.bfloat16, 48, F), "multiples of 32"),
    (lambda: layer_fused.outproj_block_plan(torch.float32, 0, F), "multiples of 32"),
    (lambda: attention_proj.outproj_res_plan(torch.bfloat16, 48, F), "multiples of 32"),
    (lambda: attention_proj.outproj_res_plan(torch.float32, HD, 160), "multiple of 64"),
    (lambda: graph_linear_fused.graph_linear_fused_plan(torch.bfloat16, 100, F),
     "multiple of 8"),
    (lambda: graph_linear_fused.graph_linear_fused_plan(torch.bfloat16, 0, F), "multiple of 8"),
    (lambda: graph_linear_fused.graph_linear_fused_plan(torch.bfloat16, FO, 160),
     "multiple of 64"),
    (lambda: graph_linear_fused.graph_linear_fused_plan(torch.float32, FO, 320), "up to 256"),
    (lambda: graph_linear_fused.graph_linear_fused_plan(torch.float32, FO, 256), "does not fit"),
], ids=["f96", "f320", "f32-f256", "hd48", "hd0", "outproj_res-hd48", "outproj_res-f160",
        "stem-d100", "stem-d0", "stem-f160", "stem-f320", "stem-f32-f256"])
def test_block_plans_refuse_what_the_kernels_do_not_take(call, match):
    with pytest.raises(ValueError, match=match):
        call()


@pytest.mark.parametrize("call, match", [
    (lambda: resnet_block.final_block_in_plan(torch.bfloat16, 96), "multiple of 64"),
    (lambda: resnet_block.final_block_in_plan(torch.float32, 320), "multiple of 64 up to 256"),
    (lambda: resnet_block.final_block_out_plan(torch.bfloat16, 160, FO), "multiple of 64"),
    (lambda: resnet_block.final_block_out_plan(torch.bfloat16, F, 100), "multiple of 8 up to"),
    (lambda: resnet_block.final_block_out_plan(torch.bfloat16, F, 4), "multiple of 8 up to"),
    (lambda: resnet_block.final_block_out_plan(torch.bfloat16, F, 2 * F), "up to F=192"),
    (lambda: resnet_block.final_block_out_plan(torch.float32, F, 98), "multiple of 4 up to"),
    (lambda: resnet_block.final_block_out_plan(torch.float32, F, 0), "positive multiple"),
], ids=["in-f96", "in-f320", "out-f160", "out-fo100", "out-fo4", "out-fo384", "out-f32-fo98",
        "out-f32-fo0"])
def test_final_block_plans_refuse_what_the_kernels_do_not_take(call, match):
    """B5a's and B5b's plans refuse what ``block_plan_ok`` and ``out_cols_ok``
    in ``node_mix_sm90.cuh`` refuse: F not a multiple of 64 up to 256, a head
    that is not a positive number of 16-byte chunks up to F."""
    with pytest.raises(ValueError, match=match):
        call()


@pytest.mark.parametrize("dtype, fo", [(torch.bfloat16, 96), (torch.bfloat16, 8),
                                       (torch.bfloat16, 192), (torch.float32, 96),
                                       (torch.float32, 4), (torch.float32, 132)])
def test_final_block_out_plan_takes_heads_of_whole_16_byte_chunks_up_to_f(dtype, fo):
    """The head's store writes 16-byte chunks of its fo columns: any fo in
    whole chunks up to F is taken, with the same plan as an F-wide head."""
    engine.check_out_width("final_block_out", dtype, F, fo)
    assert resnet_block.final_block_out_plan(dtype, F, fo) == \
        resnet_block.final_block_out_plan(dtype, F, F)


@pytest.mark.parametrize("plan", [lambda dt: resnet_block.resnet_block_plan(dt, F),
                                  lambda dt: attention_proj.outproj_res_plan(dt, HD, F),
                                  lambda dt: resnet_block.final_block_in_plan(dt, F),
                                  lambda dt: resnet_block.final_block_out_plan(dt, F, FO)],
                         ids=["resnet_block", "outproj_res", "final_block_in", "final_block_out"])
def test_block_plans_refuse_other_element_types(plan):
    with pytest.raises(TypeError, match="built for bfloat16 and float32"):
        plan(torch.float16)


def _slice_at(dtype, kslice, cols):
    """Where element (k, c) of a k-slice lies in its packed tile of ``cols``
    columns: for bf16 core matrix (k/8, c/8), row c%8, column k%8; for fp32
    row-major."""
    kk = torch.arange(kslice)[:, None].expand(kslice, cols)
    col = torch.arange(cols)[None, :].expand(kslice, cols)
    if dtype == torch.bfloat16:
        return ((kk // 8) * (cols // 8) + col // 8) * 64 + (col % 8) * 8 + kk % 8
    return kk * cols + col


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("k", [F, HD])
def test_each_k_slice_of_a_packed_bank_is_the_bank_rows_the_kernel_reads(k, dtype):
    """The ring copies k-slice j of node n from elements [j·ks·F, (j+1)·ks·F)
    of its packed tile: there lie bank rows j·ks …, for bf16 element (k, c)
    of the slice at the tensor cores' core matrix (k/8, c/8), row c%8,
    column k%8, for fp32 row-major."""
    rng = np.random.default_rng(0)
    w = torch.from_numpy(rng.standard_normal((N, k, F), dtype=np.float32)).to(dtype)
    packed = engine.pack_banks(w, WHOLE)
    assert packed.shape == (N, 1, k * F) and packed.is_contiguous()
    kslice = engine.KSLICES[0] if dtype == torch.bfloat16 else engine.KSLICES[1]
    at = _slice_at(dtype, kslice, F)
    for j in range(k // kslice):
        tile = packed[:, 0, j * kslice * F:(j + 1) * kslice * F]
        assert torch.equal(tile[:, at], w[:, j * kslice:(j + 1) * kslice, :])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_final_block_in_k_slices_read_x_then_r(dtype):
    """B5a's passes contract over x‖r against the whole [2F, F] bank: the
    ring's k-slice j of the packed bank holds bank rows j·ks …, and its input
    rows come from x for j < F/ks and from r after (each with row stride F,
    at column j·ks or j·ks − F).  Summing those slices' products as the
    kernel does gives [x‖r]·W."""
    rng = np.random.default_rng(2)
    rows = 5
    x, r = (torch.from_numpy(rng.standard_normal((N, rows, F), dtype=np.float32)).to(dtype)
            for _ in range(2))
    w = torch.from_numpy(rng.standard_normal((N, 2 * F, F), dtype=np.float32)).to(dtype)
    plan = resnet_block.final_block_in_plan(dtype, F)
    ks = plan.kslice
    packed = engine.pack_banks(w, WHOLE)
    assert packed.shape == (N, 1, 2 * F * F) and packed.is_contiguous()
    at = _slice_at(dtype, ks, F)
    acc = torch.zeros(N, rows, F, dtype=torch.float64)
    sources = []
    for j in range(2 * F // ks):
        tile = packed[:, 0, j * ks * F:(j + 1) * ks * F][:, at]  # [N, ks, F]
        assert torch.equal(tile, w[:, j * ks:(j + 1) * ks, :])
        hi = j * ks >= F  # as the producer picks the slice's source
        src, col = (r, j * ks - F) if hi else (x, j * ks)
        sources.append("r" if hi else "x")
        acc += src[:, :, col:col + ks].double() @ tile.double()
    assert sources == ["x"] * (F // ks) + ["r"] * (F // ks)
    want = torch.cat([x, r], dim=-1).double() @ w.double()
    torch.testing.assert_close(acc, want, rtol=1e-12, atol=1e-9)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_packed_head_bank_is_w_h_then_zero_columns(dtype):
    """B5b's head bank [N, F, 96] packs into one tile of F = 192 columns a
    node, as an F-wide bank: each k-slice's first 96 columns are W_h's,
    columns 96–191 zero (the head pass computes and mixes them, zeros, and
    stores only 96)."""
    rng = np.random.default_rng(3)
    wh = torch.from_numpy(rng.standard_normal((N, F, FO), dtype=np.float32)).to(dtype)
    packed = engine.pack_banks(wh, HEAD)
    assert packed.shape == (N, 1, F * F) and packed.is_contiguous()
    ks = resnet_block.final_block_out_plan(dtype, F, FO).kslice
    at = _slice_at(dtype, ks, F)
    for j in range(F // ks):
        tile = packed[:, 0, j * ks * F:(j + 1) * ks * F][:, at]  # [N, ks, F]
        assert torch.equal(tile[:, :, :FO], wh[:, j * ks:(j + 1) * ks, :])
        assert not tile[:, :, FO:].any()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_padded_head_bias_is_b_h_then_zeros_and_cached(dtype):
    """B5b's head bias [N, 96] reaches the kernel as [N, F]: the kernel adds
    a bias to all F columns of the head pass, so columns 96–191 must read 0."""
    bh = torch.from_numpy(np.random.default_rng(4).standard_normal((N, FO),
                                                                   dtype=np.float32)).to(dtype)
    padded = engine.pack(bh, ("pad", F))
    assert padded.shape == (N, F) and padded.is_contiguous() and padded.dtype == dtype
    assert torch.equal(padded[:, :FO], bh) and not padded[:, FO:].any()
    assert engine.pack(bh, ("pad", F)) is padded


def test_packed_whole_banks_are_cached_until_the_bank_changes():
    w = torch.randn(N, F, F).to(torch.bfloat16)
    first = engine.pack_banks(w, WHOLE)
    assert engine.pack_banks(w, WHOLE) is first
    w.mul_(2)  # in place: a new version of the bank
    again = engine.pack_banks(w, WHOLE)
    assert again is not first and torch.equal(again.float(), 2 * first.float())


def _zeros(dtype, rows=4, f=F, hd=HD):
    z = lambda *s: torch.zeros(*s, dtype=dtype)  # noqa: E731
    block = (z(N, f, f), z(N, f), z(N, N), z(N, f, f), z(N, f), z(N, N))
    x = z(N, rows, f)
    return {
        "final_block_in": (resnet_block, "launches_final_in",
                           lambda: resnet_block.final_block_in(x, x, z(2 * f), z(N, 2 * f, f),
                                                               z(N, f), z(N, N), z(N, 2 * f, f),
                                                               z(N, N))),
        "final_block_out": (resnet_block, "launches_final_out",
                            lambda: resnet_block.final_block_out(x, x, *block[:3], z(N, f, FO),
                                                                 z(N, FO), z(N, N))),
        "resnet_block": (resnet_block, "launches_block",
                         lambda: resnet_block.resnet_block(z(N, rows, f), z(2 * f), *block)),
        "outproj_block": (layer_fused, "launches_outproj_block",
                          lambda: layer_fused.outproj_block(z(N, rows, hd), z(N, rows, f),
                                                            z(2 * f), z(N, hd, f), z(N, N),
                                                            *block)),
        "outproj_res": (attention_proj, "launches_outproj_res",
                        lambda: attention_proj.outproj_res(z(N, rows, hd), z(N, rows, f),
                                                           z(N, hd, f), z(N, N))),
        "stem_block": (layer_fused, "launches_stem_block",
                       lambda: layer_fused.stem_block(z(N, rows, hd), z(N, rows, f), z(2 * f),
                                                      z(N, hd, f), z(N, f), z(N, N), *block)),
        "graph_linear_fused": (graph_linear_fused, "launches",
                               lambda: graph_linear_fused.graph_linear_fused(
                                   z(N, rows, hd), z(N, hd, f), z(N, f), z(N, N),
                                   z(N, rows, f))),
    }


@pytest.mark.parametrize("kernel", ["resnet_block", "outproj_block", "outproj_res",
                                    "final_block_in", "final_block_out", "stem_block",
                                    "graph_linear_fused"])
@pytest.mark.parametrize("widths, match", [(dict(f=96), "multiple of 64"),
                                           (dict(f=320), "up to 256"),
                                           (dict(hd=48), "multiples of 32")],
                         ids=["f96", "f320", "hd48"])
def test_wrappers_raise_before_launching_what_the_plans_refuse(monkeypatch, kernel, widths,
                                                               match):
    """On a CUDA request the wrapper refuses a width its plan refuses before
    it names a C entry, and counts no launch (the stem input of B9a and B4:
    its D, here hd, a multiple of 8)."""
    if kernel in ("resnet_block", "final_block_in", "final_block_out") and "hd" in widths:
        widths, match = dict(f=160), "multiple of 64"
    if kernel in ("stem_block", "graph_linear_fused") and "hd" in widths:
        widths, match = dict(hd=100), "multiple of 8"
    monkeypatch.setattr(build, "kernel_device", lambda **tensors: "cuda")
    monkeypatch.setattr(build, "c_entry", lambda *a: pytest.fail("launched"))
    module, counter, call = _zeros(torch.bfloat16, **widths)[kernel]
    before = getattr(module, counter)
    with pytest.raises(ValueError, match=match):
        call()
    assert getattr(module, counter) == before


def test_outproj_res_refuses_other_node_counts_before_launching(monkeypatch):
    """B3b's kernel is built for 2 to 51 nodes; the wrapper refuses others
    (naming the ROADMAP item) before it names a C entry, and counts no
    launch."""
    monkeypatch.setattr(build, "kernel_device", lambda **tensors: "cuda")
    monkeypatch.setattr(build, "c_entry", lambda *a: pytest.fail("launched"))
    z = lambda *s: torch.zeros(*s, dtype=torch.bfloat16)  # noqa: E731
    before = attention_proj.launches_outproj_res
    with pytest.raises(ValueError, match="takes 2 to 51 nodes, got 52 .*ROADMAP"):
        attention_proj.outproj_res(z(52, 4, HD), z(52, 4, F), z(52, HD, F), z(52, 52))
    assert attention_proj.launches_outproj_res == before


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("kernel", ["resnet_block", "outproj_block", "outproj_res",
                                    "final_block_in", "final_block_out", "stem_block",
                                    "graph_linear_fused", "graph_linear_fused_no_u"])
def test_wrappers_hand_the_kernel_packed_banks_and_the_plan(monkeypatch, kernel, dtype):
    """The C entry gets the packed tiles of the banks (the cached ones; B5b's
    head bank and its bias zero-padded to F columns, the stem bank of B9a and
    B4 to 128 rows), the other tensors as they are (the stem's u among them;
    B4 without u: a null pointer), the outputs, and the widths followed by
    the plan."""
    calls = []

    def recording(library, symbol, n_pointers, n_ints, nodes=21):
        def entry(*args):
            calls.append((library, symbol, args[:n_pointers], args[n_pointers:-1]))
            return 0
        return entry

    monkeypatch.setattr(build, "kernel_device", lambda **tensors: "cuda")
    monkeypatch.setattr(build, "c_entry", recording)
    monkeypatch.setattr(build, "stream_of", lambda t: 0)
    monkeypatch.setattr(build, "check_aligned", lambda *a, **k: None)
    rng = np.random.default_rng(1)
    r = lambda *s: torch.from_numpy(rng.standard_normal(s, dtype=np.float32)).to(dtype)  # noqa
    rows = 4
    block = [r(N, F, F), r(N, F), r(N, N), r(N, F, F), r(N, F), r(N, N)]
    if kernel == "resnet_block":
        args = [r(N, rows, F), r(2 * F)] + block
        module, counter, plan = resnet_block, "launches_block", resnet_block.resnet_block_plan(
            dtype, F)
        banks, widths = {2: WHOLE, 5: WHOLE}, (N, rows, F)
        fn = resnet_block.resnet_block
    elif kernel == "final_block_in":
        args = [r(N, rows, F), r(N, rows, F), r(2 * F), r(N, 2 * F, F), r(N, F), r(N, N),
                r(N, 2 * F, F), r(N, N)]
        module, counter, plan = resnet_block, "launches_final_in", \
            resnet_block.final_block_in_plan(dtype, F)
        banks, widths = {3: WHOLE, 6: WHOLE}, (N, rows, F)
        fn = resnet_block.final_block_in
    elif kernel == "final_block_out":
        args = [r(N, rows, F), r(N, rows, F)] + block[:3] + [r(N, F, FO), r(N, FO), r(N, N)]
        module, counter, plan = resnet_block, "launches_final_out", \
            resnet_block.final_block_out_plan(dtype, F, FO)
        banks, widths = {2: WHOLE, 5: HEAD, 6: ("pad", F)}, (N, rows, F, FO)
        fn = resnet_block.final_block_out
    elif kernel == "outproj_res":
        args = [r(N, rows, HD), r(N, rows, F), r(N, HD, F), r(N, N)]
        module, counter, plan = attention_proj, "launches_outproj_res", \
            attention_proj.outproj_res_plan(dtype, HD, F)
        banks, widths = {2: WHOLE}, (N, rows, HD, F)
        fn = attention_proj.outproj_res
    elif kernel == "stem_block":
        args = [r(N, rows, FO), r(N, rows, F), r(2 * F), r(N, FO, F), r(N, F), r(N, N)] + block
        module, counter, plan = layer_fused, "launches_stem_block", \
            layer_fused.stem_block_plan(dtype, FO, F)
        banks, widths = {3: ("rows", 128, WHOLE), 6: WHOLE, 9: WHOLE}, (N, rows, FO, F)
        fn = layer_fused.stem_block
    elif kernel.startswith("graph_linear_fused"):
        args = [r(N, rows, FO), r(N, FO, F), r(N, F), r(N, N)]
        args += [None] if kernel.endswith("no_u") else [r(N, rows, F)]
        module, counter, plan = graph_linear_fused, "launches", \
            graph_linear_fused.graph_linear_fused_plan(dtype, FO, F)
        banks, widths = {1: ("rows", 128, WHOLE)}, (N, rows, FO, F)
        fn = graph_linear_fused.graph_linear_fused
    else:
        args = [r(N, rows, HD), r(N, rows, F), r(2 * F), r(N, HD, F), r(N, N)] + block
        module, counter, plan = layer_fused, "launches_outproj_block", \
            layer_fused.outproj_block_plan(dtype, HD, F)
        banks, widths = {3: WHOLE, 5: WHOLE, 8: WHOLE}, (N, rows, HD, F)
        fn = layer_fused.outproj_block
    before = getattr(module, counter)
    out = fn(*args)
    assert getattr(module, counter) == before + 1
    (library, symbol, pointers, ints), = calls
    suffix = "bf16" if dtype == torch.bfloat16 else "f32"
    library_of = {"outproj_block": "layer_fused", "outproj_res": "attention_proj",
                  "stem_block": "layer_fused", "graph_linear_fused": "graph_linear_fused",
                  "graph_linear_fused_no_u": "graph_linear_fused"}
    entry = "graph_linear_fused" if kernel.startswith("graph_linear_fused") else kernel
    assert (library, symbol) == (library_of.get(kernel, "resnet_block"), f"{entry}_{suffix}")
    assert ints == (*widths, *plan)
    outs = out if isinstance(out, tuple) else (out,)
    want = [engine.pack(a, banks[i]).data_ptr() if i in banks else
            None if a is None else a.data_ptr()
            for i, a in enumerate(args)] + [o.data_ptr() for o in outs]
    assert list(pointers) == want
    assert len({p for p in pointers}) == len(pointers)  # the outputs are new tensors


# ---- B4: the stem pass of B9a alone ------------------------------------------

@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_graph_linear_fused_plan_is_stem_blocks_first_pass(dtype):
    """B4 runs B9a's stem pass alone: the same rows, k-slice and cluster, so
    the same k-slices reach the same products in the same order and its
    output is B9a's r bit for bit (held on the card by chip_smoke); in bf16
    also the same stages and shared memory (the fp32 plan keeps one
    influence where B9a keeps three)."""
    stem = graph_linear_fused.graph_linear_fused_plan(dtype, FO, F)
    block = layer_fused.stem_block_plan(dtype, FO, F)
    assert (stem.rows, stem.kslice, stem.cluster) == (block.rows, block.kslice, block.cluster)
    elem = torch.empty((), dtype=dtype).element_size()
    assert stem.smem_bytes == engine.block_plan_bytes(elem, stem.rows, F, stem.kslice,
                                                      stem.stages, 1) <= engine.MAX_SMEM
    if dtype == torch.bfloat16:
        assert stem == block


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_graph_linear_fused_hands_the_kernel_stem_blocks_packed_bank(monkeypatch, dtype):
    """B4's wrapper and B9a's pack the stem bank W_s alike and share the
    cached copy: the two kernels read the same tiles."""
    seen = {}

    def recording(library, symbol, n_pointers, n_ints, nodes=21):
        def entry(*args):
            seen[library] = args[:n_pointers]
            return 0
        return entry

    monkeypatch.setattr(build, "kernel_device", lambda **tensors: "cuda")
    monkeypatch.setattr(build, "c_entry", recording)
    monkeypatch.setattr(build, "stream_of", lambda t: 0)
    monkeypatch.setattr(build, "check_aligned", lambda *a, **k: None)
    rng = np.random.default_rng(2)
    r = lambda *s: torch.from_numpy(rng.standard_normal(s, dtype=np.float32)).to(dtype)  # noqa
    rows = 4
    x, u, ws, bs, gs = r(N, rows, FO), r(N, rows, F), r(N, FO, F), r(N, F), r(N, N)
    block = [r(N, F, F), r(N, F), r(N, N), r(N, F, F), r(N, F), r(N, N)]
    graph_linear_fused.graph_linear_fused(x, ws, bs, gs, u)
    layer_fused.stem_block(x, u, r(2 * F), ws, bs, gs, *block)
    b4, b9a = seen["graph_linear_fused"], seen["layer_fused"]
    # B4: x, w, b, g, u, out; B9a: x, u, film, ws, bs, gs, …
    assert b4[1] == b9a[3] == engine.pack(ws, ("rows", 128, WHOLE)).data_ptr()
    assert (b4[0], b4[2], b4[3], b4[4]) == (b9a[0], b9a[4], b9a[5], b9a[1])
