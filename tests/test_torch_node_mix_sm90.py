"""The host side of the RMSNorm → per-node product → node-mix engine of B3a
and B9b (``skeletondiffusion_tpu_torch/ops/kernels/node_mix_sm90.py``): the
tile plans the kernels are launched with and the packed weight tiles a bulk
copy brings into shared memory.  The kernels' walk over row tiles and
clusters runs only on the card, where ``chip_smoke.py`` holds it against the
plain versions at an even, a ragged and an odd number of row tiles.

Widths: the bench's (F 192, 8 heads × 32) and the CPU tests' small model
(latent 16, so F 32, 2 heads × 4).
"""
import importlib.util
import pathlib

import numpy as np
import pytest
import torch

from skeletondiffusion_tpu_torch.ops.kernels import attention_proj, build, layer_fused
from skeletondiffusion_tpu_torch.ops.kernels import node_mix_sm90 as engine

N = 21
BENCH = dict(f=192, heads=8, dim_head=32)
SMALL = dict(f=32, heads=2, dim_head=4)


def _qkv_plan(dtype, f, heads, dim_head):
    return attention_proj.rms_qkv_plan(dtype, f, 3 * heads * dim_head)


def _core_plan(dtype, f, heads, dim_head):
    return layer_fused.rms_qkv_core_plan(dtype, f, heads, dim_head)


PLANS = [(_qkv_plan, BENCH), (_qkv_plan, SMALL), (_core_plan, BENCH)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("plan_of, widths", PLANS, ids=["rms_qkv-bench", "rms_qkv-small",
                                                        "rms_qkv_core-bench"])
def test_tile_plans_fit_shared_memory(plan_of, widths, dtype):
    plan = plan_of(dtype, **widths)
    elem = torch.empty((), dtype=dtype).element_size()
    assert plan.smem_bytes <= engine.MAX_SMEM == 232448
    assert plan.smem_bytes == engine.plan_bytes(elem, plan.rows, plan.cols, widths["f"],
                                                plan.stages)
    assert 2 <= plan.stages <= engine.MAX_STAGES
    # one more stage would not fit: the plan takes as many as fit
    assert (plan.stages == engine.MAX_STAGES or engine.plan_bytes(
        elem, plan.rows, plan.cols, widths["f"], plan.stages + 1) > engine.MAX_SMEM)
    assert plan.cluster == engine.CLUSTER == 2
    if dtype == torch.bfloat16:  # each weight tile from L2 serves 64 rows
        assert plan.rows * plan.cluster == 64 and plan.cols == 96


def test_bench_plans_are_the_documented_ones():
    assert tuple(_qkv_plan(torch.bfloat16, **BENCH)) == (32, 96, 2, 2, 227840)
    assert tuple(_core_plan(torch.bfloat16, **BENCH)) == (32, 96, 2, 2, 227840)
    assert tuple(_qkv_plan(torch.float32, **BENCH)) == (8, 96, 2, 2, 226816)


@pytest.mark.parametrize("call, error, match", [
    (lambda: attention_proj.rms_qkv_plan(torch.bfloat16, 48, 768), ValueError, "multiple of 32"),
    (lambda: attention_proj.rms_qkv_plan(torch.bfloat16, 288, 768), ValueError, "exceeds 256"),
    (lambda: attention_proj.rms_qkv_plan(torch.float32, 192, 20), ValueError, "multiple of 8"),
    (lambda: attention_proj.rms_qkv_plan(torch.float16, 192, 768), TypeError, "built for"),
    (lambda: layer_fused.rms_qkv_core_plan(torch.bfloat16, 192, 8, 16), ValueError, "heads of 32"),
    (lambda: layer_fused.rms_qkv_core_plan(torch.bfloat16, 32, 2, 4), ValueError, "heads of 32"),
    (lambda: layer_fused.rms_qkv_core_plan(torch.float32, 40, 8, 32), ValueError, "multiple of 32"),
    (lambda: engine.plan("k", torch.float32, 64, 96, 192), ValueError, "does not fit"),
], ids=["f48", "f288", "fo20", "fp16", "dh16", "small-core", "f40", "too-big"])
def test_plans_refuse_what_the_kernels_do_not_take(call, error, match):
    with pytest.raises(error, match=match):
        call()


@pytest.mark.parametrize("kernel", ["rms_qkv", "rms_qkv_core"])
def test_wrappers_raise_before_launching_what_the_kernels_do_not_take(monkeypatch, kernel):
    """On a CUDA request the wrapper refuses a width the kernel does not take
    before it names a C entry, and counts no launch."""
    monkeypatch.setattr(build, "kernel_device", lambda **tensors: "cuda")
    monkeypatch.setattr(build, "c_entry", lambda *a: pytest.fail("launched"))
    z = lambda *s: torch.zeros(*s, dtype=torch.bfloat16)  # noqa: E731
    f = 48  # not a multiple of 32
    if kernel == "rms_qkv":
        call, module, counter = (lambda: attention_proj.rms_qkv(z(N, 4, f), z(f), z(N, f, 768),
                                                                z(N, N))), attention_proj, \
            "launches_rms_qkv"
    else:
        call, module, counter = (lambda: layer_fused.rms_qkv_core(
            z(N, 4, f), z(f), z(N, f, 768), z(N, N), heads=8, dim_head=32)), layer_fused, \
            "launches_rms_qkv_core"
    before = getattr(module, counter)
    with pytest.raises(ValueError, match="multiple of 32"):
        call()
    assert getattr(module, counter) == before


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("columns", [("groups", 24, 96), ("groups", 768, 96), ("heads", 8, 32),
                                     ("heads", 2, 32)])
def test_packed_tiles_hold_the_bank_where_the_kernel_reads_it(columns, dtype):
    """bf16: element (k, c) of a tile at the tensor cores' core matrix
    (k/8, c/8), row c%8, column k%8; fp32: row-major [F][C]; −1 columns zero."""
    f = 64
    rng = np.random.default_rng(0)
    fo = {"groups": lambda out, c: out, "heads": lambda h, d: 3 * h * d}[columns[0]](*columns[1:])
    w = torch.from_numpy(rng.standard_normal((N, f, fo), dtype=np.float32)).to(dtype)
    packed = engine.pack_banks(w, columns)
    idx = engine.COLUMNS[columns[0]](*columns[1:])
    g, c = idx.shape
    assert packed.shape == (N, g, f * c) and packed.is_contiguous()
    k = torch.arange(f)[:, None].expand(f, c)
    col = torch.arange(c)[None, :].expand(f, c)
    if dtype == torch.bfloat16:
        at = ((k // 8) * (c // 8) + col // 8) * 64 + (col % 8) * 8 + k % 8
    else:
        at = k * c + col
    padded = torch.cat([w, torch.zeros(N, f, 1, dtype=dtype)], dim=-1)
    for grp in range(g):
        src = torch.where(idx[grp] < 0, fo, idx[grp])
        assert torch.equal(packed[:, grp][:, at], padded[:, :, src])
    if columns[0] == "heads":
        h, d = columns[1:]
        assert idx[1].tolist() == ([d + i for i in range(d)] + [h * d + d + i for i in range(d)]
                                   + [2 * h * d + d + i for i in range(d)])


def test_packed_banks_are_cached_until_the_bank_changes():
    w = torch.randn(N, 32, 24).to(torch.bfloat16)
    first = engine.pack_banks(w, ("groups", 24, 96))
    assert engine.pack_banks(w, ("groups", 24, 96)) is first
    assert engine.pack_banks(w, ("groups", 24, 8)) is not first
    w.mul_(2)  # in place: a new version of the bank
    again = engine.pack_banks(w, ("groups", 24, 96))
    assert again is not first and torch.equal(again.float(), 2 * first.float())


def test_head_attention_ab_switches_off_the_bf16_branch(tmp_path):
    """``scripts/torch_head_attention_ab.py`` builds its CUDA-core variant by
    switching off the bf16 tensor-core body (``kTensorCoreBody``, which B2
    and B9b read) in a copy of the sources; the sources hold that switch
    once, and the copy holds it no more."""
    path = pathlib.Path(__file__).resolve().parents[1] / "scripts" / "torch_head_attention_ab.py"
    spec = importlib.util.spec_from_file_location("torch_head_attention_ab", path)
    ab = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ab)
    header = (build.CSRC_DIR / "joint_attention.cuh").read_text()
    assert header.count(ab.TC_SWITCH) == 1
    for kernel in ("joint_attention.cu", "layer_fused.cu"):
        assert "kTensorCoreBody<T>)" in (build.CSRC_DIR / kernel).read_text(), kernel
    copy = ab.cuda_core_sources(tmp_path / "src")
    text = (copy / "joint_attention.cuh").read_text()
    assert ab.TC_SWITCH not in text and "constexpr bool kTensorCoreBody = false;" in text
    assert {p.name for p in copy.iterdir()} == {p.name for p in build.CSRC_DIR.iterdir()}
