"""The host side of B1 (``resnet_block``), B9c (``outproj_block``) and B3b
(``outproj_res``) on the whole-row items of ``csrc/node_mix_sm90.cuh``:
their tile plans, the packed banks the ring streams in k-slices, and the
wrappers' refusals.  The kernels' walk over row tiles and two-block clusters
runs only on the card, where ``chip_smoke.py`` holds all three against their
plain versions at an even, a ragged and an odd number of row tiles.

Widths: the bench's (F 192, the attention's 8 heads × 32 = 256).
"""
import numpy as np
import pytest
import torch

from skeletondiffusion_tpu_torch.ops.kernels import attention_proj, build, layer_fused, resnet_block
from skeletondiffusion_tpu_torch.ops.kernels import node_mix_sm90 as engine

N, F, HD = 21, 192, 256
WHOLE = ("groups", F, F)


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
    }


@pytest.mark.parametrize("kernel, dtype", [("resnet_block", torch.bfloat16),
                                           ("resnet_block", torch.float32),
                                           ("outproj_block", torch.bfloat16),
                                           ("outproj_block", torch.float32),
                                           ("outproj_res", torch.bfloat16),
                                           ("outproj_res", torch.float32)])
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
], ids=["f96", "f320", "f32-f256", "hd48", "hd0", "outproj_res-hd48", "outproj_res-f160"])
def test_block_plans_refuse_what_the_kernels_do_not_take(call, match):
    with pytest.raises(ValueError, match=match):
        call()


@pytest.mark.parametrize("plan", [lambda dt: resnet_block.resnet_block_plan(dt, F),
                                  lambda dt: attention_proj.outproj_res_plan(dt, HD, F)],
                         ids=["resnet_block", "outproj_res"])
def test_block_plans_refuse_other_element_types(plan):
    with pytest.raises(TypeError, match="built for bfloat16 and float32"):
        plan(torch.float16)


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
    kk = torch.arange(kslice)[:, None].expand(kslice, F)
    col = torch.arange(F)[None, :].expand(kslice, F)
    if dtype == torch.bfloat16:
        at = ((kk // 8) * (F // 8) + col // 8) * 64 + (col % 8) * 8 + kk % 8
    else:
        at = kk * F + col
    for j in range(k // kslice):
        tile = packed[:, 0, j * kslice * F:(j + 1) * kslice * F]
        assert torch.equal(tile[:, at], w[:, j * kslice:(j + 1) * kslice, :])


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
    return {
        "resnet_block": (resnet_block, "launches_block",
                         lambda: resnet_block.resnet_block(z(N, rows, f), z(2 * f), *block)),
        "outproj_block": (layer_fused, "launches_outproj_block",
                          lambda: layer_fused.outproj_block(z(N, rows, hd), z(N, rows, f),
                                                            z(2 * f), z(N, hd, f), z(N, N),
                                                            *block)),
        "outproj_res": (attention_proj, "launches_outproj_res",
                        lambda: attention_proj.outproj_res(z(N, rows, hd), z(N, rows, f),
                                                           z(N, hd, f), z(N, N))),
    }


@pytest.mark.parametrize("kernel", ["resnet_block", "outproj_block", "outproj_res"])
@pytest.mark.parametrize("widths, match", [(dict(f=96), "multiple of 64"),
                                           (dict(f=320), "up to 256"),
                                           (dict(hd=48), "multiples of 32")],
                         ids=["f96", "f320", "hd48"])
def test_wrappers_raise_before_launching_what_the_plans_refuse(monkeypatch, kernel, widths,
                                                               match):
    """On a CUDA request the wrapper refuses a width its plan refuses before
    it names a C entry, and counts no launch."""
    if kernel == "resnet_block" and "hd" in widths:
        widths, match = dict(f=160), "multiple of 64"
    monkeypatch.setattr(build, "kernel_device", lambda **tensors: "cuda")
    monkeypatch.setattr(build, "c_entry", lambda *a: pytest.fail("launched"))
    module, counter, call = _zeros(torch.bfloat16, **widths)[kernel]
    before = getattr(module, counter)
    with pytest.raises(ValueError, match=match):
        call()
    assert getattr(module, counter) == before


def test_outproj_res_refuses_other_node_counts_before_launching(monkeypatch):
    """B3b's kernel takes 21 nodes; the wrapper refuses others before it
    names a C entry, and counts no launch."""
    monkeypatch.setattr(build, "kernel_device", lambda **tensors: "cuda")
    monkeypatch.setattr(build, "c_entry", lambda *a: pytest.fail("launched"))
    z = lambda *s: torch.zeros(*s, dtype=torch.bfloat16)  # noqa: E731
    before = attention_proj.launches_outproj_res
    with pytest.raises(ValueError, match="takes 21 nodes, got 20"):
        attention_proj.outproj_res(z(20, 4, HD), z(20, 4, F), z(20, HD, F), z(20, 20))
    assert attention_proj.launches_outproj_res == before


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("kernel", ["resnet_block", "outproj_block", "outproj_res"])
def test_wrappers_hand_the_kernel_packed_banks_and_the_plan(monkeypatch, kernel, dtype):
    """The C entry gets the packed tiles of the banks (the cached ones), the
    other tensors as they are, and the widths followed by the plan."""
    calls = []

    def recording(library, symbol, n_pointers, n_ints):
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
        banks, widths = {2: block[0], 5: block[3]}, (N, rows, F)
        fn = resnet_block.resnet_block
    elif kernel == "outproj_res":
        args = [r(N, rows, HD), r(N, rows, F), r(N, HD, F), r(N, N)]
        module, counter, plan = attention_proj, "launches_outproj_res", \
            attention_proj.outproj_res_plan(dtype, HD, F)
        banks, widths = {2: args[2]}, (N, rows, HD, F)
        fn = attention_proj.outproj_res
    else:
        args = [r(N, rows, HD), r(N, rows, F), r(2 * F), r(N, HD, F), r(N, N)] + block
        module, counter, plan = layer_fused, "launches_outproj_block", \
            layer_fused.outproj_block_plan(dtype, HD, F)
        banks, widths = {3: args[3], 5: block[0], 8: block[3]}, (N, rows, HD, F)
        fn = layer_fused.outproj_block
    before = getattr(module, counter)
    out = fn(*args)
    assert getattr(module, counter) == before + 1
    (library, symbol, pointers, ints), = calls
    suffix = "bf16" if dtype == torch.bfloat16 else "f32"
    assert (library, symbol) == ({"resnet_block": "resnet_block", "outproj_block": "layer_fused",
                                  "outproj_res": "attention_proj"}[kernel], f"{kernel}_{suffix}")
    assert ints == (*widths, *plan)
    want = [engine.pack_banks(a, WHOLE).data_ptr() if i in banks else a.data_ptr()
            for i, a in enumerate(args)] + [out.data_ptr()]
    assert list(pointers) == want
