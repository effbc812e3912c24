"""The predictor's kernels at the H36M (16) and FreeMan (17) node counts on
the CPU: each plain PyTorch version against the JAX package's Pallas kernel
in interpret mode at small widths (F 64, D 32, 4 heads × 32, a batch of 8),
the plans the wrappers hand the kernels at those counts, the library each
wrapper asks for (the one built at the tensors' node count), build.py's
per-count builds, and the refusals past the counts the kernels take (naming
the ROADMAP item).  Tolerances as ``tests/test_torch_denoiser_kernels.py``:
float32 at atol 2e-5, rtol 1e-4; bf16 at the bf16 criteria."""
import os
import pathlib
import stat

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skeletondiffusion_tpu.ops.pallas import resnet_block as pallas_resnet
from skeletondiffusion_tpu.ops.pallas.attention_proj import outproj_res_pallas, rms_qkv_pallas
from skeletondiffusion_tpu.ops.pallas.graph_linear_fused import graph_linear_pallas
from skeletondiffusion_tpu.ops.pallas.gru_rollout import gru_rollout_pallas
from skeletondiffusion_tpu.ops.pallas.joint_attention import attention_core_pallas
from skeletondiffusion_tpu.ops.pallas.layer_fused import (
    outproj_block_pallas,
    rms_qkv_core_pallas,
    stem_block_pallas,
)
from skeletondiffusion_tpu.ops.pallas.posterior_step import posterior_step_pallas
from skeletondiffusion_tpu_torch.ops.graph_linear import l1_normalize_rows
from skeletondiffusion_tpu_torch.ops.kernels import attention_core_fm, attention_proj, build
from skeletondiffusion_tpu_torch.ops.kernels import graph_linear_fused
from skeletondiffusion_tpu_torch.ops.kernels import gru_rollout, joint_attention, layer_fused
from skeletondiffusion_tpu_torch.ops.kernels import node_mix_sm90, posterior_step, resnet_block

from torch_parity import KernelInputs, check_kernel, pad_to

B, D, F, HEADS, DH = 8, 32, 64, 4, 32
HD = HEADS * DH
FP = 128  # the Pallas kernels' padded feature width
NODES = pytest.mark.parametrize("n", [16, 17])
both = pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
# the Pallas comparisons: H36M in bf16 (the default path), FreeMan in fp32
# (each kernel's plain version at both counts and in both types is held on
# the card against its kernel)
NODES_DTYPES = pytest.mark.parametrize("n, dtype", [(16, "bfloat16"), (17, "float32")])


def _split(made):
    return [t for t, _ in made], [j for _, j in made]


def _block(inp):
    """A ResnetBlock's FiLM row and banks: film, w1, b1, g1, w2, b2, g2."""
    return [inp.film(F), inp.bank(F, F), inp.bias(F), inp.influence(), inp.bank(F, F),
            inp.bias(F), inp.influence()]


def _pallas_block(film, w1, b1, g1, w2, b2, g2):
    return (pallas_resnet.pad_film(film[None], F, FP).astype(film.dtype),
            dict(w1=pad_to(w1, FP, FP), b1=pad_to(b1, FP), g1=g1, w2=pad_to(w2, FP, FP),
                 b2=pad_to(b2, FP), g2=g2))


@NODES_DTYPES
def test_stem_and_resnet_block_plain_match_pallas(n, dtype):
    inp = KernelInputs(dtype, 20 + n, nodes=n)
    (x, jx), (w, jw), (b, jb), (g, jg), (u, ju) = (
        inp.act(n, B, D), inp.bank(D, F), inp.bias(F), inp.influence(), inp.act(n, B, F))
    got = graph_linear_fused.graph_linear_fused(x, w, b, g, u)
    want = graph_linear_pallas(pad_to(jx, 128), pad_to(jw, 128, FP), pad_to(jb, FP), jg,
                               u=pad_to(ju, FP), batch_tile=8, interpret=True)[:, :, :F]
    check_kernel(got, want, dtype, "stem")
    t, j = _split([inp.act(n, B, F), *_block(inp)])
    got = resnet_block.resnet_block(*t)
    want = pallas_resnet.resnet_block_pallas(j[0], j[1][None], *j[2:], f_pad=FP, batch_tile=8,
                                             interpret=True)
    check_kernel(got, want, dtype, "block")


def _rect(w):
    """[N, 2F, F] → the Pallas layout: the x and r halves of the rows each
    padded to FP."""
    pad = lambda h: pad_to(h.swapaxes(1, 2), FP).swapaxes(1, 2)  # noqa: E731
    return pad_to(jnp.concatenate([pad(w[:, :F]), pad(w[:, F:])], 1), FP)


@NODES_DTYPES
def test_final_block_plain_matches_pallas(n, dtype):
    inp = KernelInputs(dtype, 30 + n, nodes=n)
    t, j = _split([inp.act(n, B, F), inp.act(n, B, F), inp.film(F), inp.bank(2 * F, F),
                   inp.bias(F), inp.influence(), inp.bank(2 * F, F), inp.influence(),
                   inp.bank(F, F), inp.bias(F), inp.influence(), inp.bank(F, D), inp.bias(D),
                   inp.influence()])
    h, res = resnet_block.final_block_in(*t[:8])
    got = resnet_block.final_block_out(h, res, *t[8:])
    dt = j[0].dtype
    want = pallas_resnet.final_block_head_pallas_padded(
        pad_to(j[0], FP), pad_to(j[1], FP), pallas_resnet.pad_film(j[2][None], F, FP).astype(dt),
        _rect(j[3]), pad_to(j[4], FP), j[5], _rect(j[6]), j[7], pad_to(j[8], FP, FP),
        pad_to(j[9], FP), j[10], pad_to(j[11], FP, 128), pad_to(j[12], 128), j[13],
        batch_tile_in=8, batch_tile_out=8, interpret=True)[:, :, :D]
    check_kernel(got, want, dtype)


@NODES_DTYPES
def test_attention_layer_plain_matches_pallas(n, dtype):
    """B3a, B2 and B3b in turn, each on the Pallas kernel's own input."""
    inp = KernelInputs(dtype, 40 + n, nodes=n)
    (x, jx), (w, jw), (g, jg) = inp.act(n, B, F), inp.bank(F, 3 * HD), inp.influence()
    g_rms, jg_rms = inp._make((1.0 + 0.1 * inp.rng.standard_normal(F)) * np.sqrt(F))
    qkv = attention_proj.rms_qkv(x, g_rms, w, g)
    jqkv = rms_qkv_pallas(pad_to(jx, FP), pad_to(jg_rms[None], FP),
                          pad_to(jw.swapaxes(1, 2), FP).swapaxes(1, 2), jg, batch_tile=8,
                          interpret=True)
    check_kernel(qkv, jqkv, dtype, "rms_qkv")
    as_t = lambda a: torch.from_numpy(np.array(a.astype(jnp.float32))).to(x.dtype)  # noqa: E731
    core = joint_attention.attention_core(as_t(jqkv), heads=HEADS, dim_head=DH)
    jcore = attention_core_pallas(jqkv, heads=HEADS, dim_head=DH, batch_tile=8, interpret=True)
    check_kernel(core, jcore, dtype, "attention_core")
    (wo, jwo), (go, jgo) = inp.bank(HD, F), inp.influence()
    out = attention_proj.outproj_res(as_t(jcore), x, wo, go)
    want = outproj_res_pallas(jcore, pad_to(jx, FP), pad_to(jwo, FP), jgo, batch_tile=8,
                              interpret=True)[:, :, :F]
    check_kernel(out, want, dtype, "outproj_res")


@NODES_DTYPES
def test_layer_fused_kernels_plain_match_pallas(n, dtype):
    """B9a, B9b and B9c."""
    inp = KernelInputs(dtype, 50 + n, nodes=n)
    t, j = _split([inp.act(n, B, D), inp.act(n, B, F), inp.bank(D, F), inp.bias(F),
                   inp.influence(), *_block(inp)])
    r, out = layer_fused.stem_block(*t[:2], t[5], *t[2:5], *t[6:])
    filmp, blk = _pallas_block(*j[5:])
    jr, jout = stem_block_pallas(pad_to(j[0], 128), pad_to(j[1], FP), filmp,
                                 dict(w=pad_to(j[2], 128, FP), b=pad_to(j[3], FP), g=j[4]), blk,
                                 batch_tile=8, interpret=True)
    check_kernel(r, jr[:, :, :F], dtype, "stem_block r")
    check_kernel(out, jout[:, :, :F], dtype, "stem_block out")
    (x, jx), (w, jw), (g, jg) = inp.act(n, B, F), inp.bank(F, 3 * HD), inp.influence()
    g_rms, jg_rms = inp._make((1.0 + 0.1 * inp.rng.standard_normal(F)) * np.sqrt(F))
    got = layer_fused.rms_qkv_core(x, g_rms, w, g, heads=HEADS, dim_head=DH)
    want = rms_qkv_core_pallas(pad_to(jx, FP), pad_to(jg_rms[None], FP),
                               pad_to(jw.swapaxes(1, 2), FP).swapaxes(1, 2), jg, heads=HEADS,
                               dim_head=DH, batch_tile=8, query_chunk=2, interpret=True)
    check_kernel(got, want, dtype, "rms_qkv_core")
    t, j = _split([inp.act(n, B, HD), inp.act(n, B, F), inp.bank(HD, F), inp.influence(),
                   *_block(inp)])
    got = layer_fused.outproj_block(*t[:2], t[4], t[2], t[3], *t[5:])
    filmp, blk = _pallas_block(*j[4:])
    want = outproj_block_pallas(j[0], pad_to(j[1], FP), filmp, pad_to(j[2], FP), j[3], blk,
                                batch_tile=8, interpret=True)[:, :, :F]
    check_kernel(got, want, dtype, "outproj_block")


@NODES
@pytest.mark.parametrize("x0_dtype", ["float32", "bfloat16"])
def test_posterior_step_plain_matches_pallas(n, x0_dtype):
    inp = KernelInputs(x0_dtype, 60 + n, nodes=n)
    x0, jx0 = inp.act(n, B, 128, scale=1.5)  # some |x̂₀| > 1: the clip acts
    rng = np.random.default_rng(n)
    xt, eps = (rng.standard_normal((n, B, 128), dtype=np.float32) for _ in range(2))
    m = 0.3 * rng.standard_normal((n, 3 * n), dtype=np.float32)
    got = posterior_step.posterior_step(x0, torch.from_numpy(xt), torch.from_numpy(eps),
                                        torch.from_numpy(m))
    want = posterior_step_pallas(jx0, jnp.asarray(xt), jnp.asarray(eps), jnp.asarray(m),
                                 batch_tile=8, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


@NODES
def test_gru_rollout_plain_matches_pallas(n):
    """K1 over the FreeMan horizon's step count cut to 12, H 16."""
    rng, h, ph = np.random.default_rng(70 + n), 16, 12
    norm = lambda g: l1_normalize_rows(torch.from_numpy(g)).numpy()  # noqa: E731
    infl = lambda: norm(np.eye(n, dtype=np.float32) + 0.2 * rng.random((n, n), dtype=np.float32))
    inp = dict(cx=rng.standard_normal((n, B, 3 * h), dtype=np.float32),
               h0=0.5 * rng.standard_normal((n, B, h), dtype=np.float32),
               w_hh=0.3 * rng.standard_normal((n, h, 3 * h), dtype=np.float32),
               b_hh=0.3 * rng.standard_normal((n, 3 * h), dtype=np.float32), g0=infl(),
               g_add=0.05 * (rng.random((n, n), dtype=np.float32) - 0.5),
               w_fc=0.3 * rng.standard_normal((n, h, 3), dtype=np.float32),
               b_fc=0.3 * rng.standard_normal((n, 3), dtype=np.float32), g_fc=infl())
    got = gru_rollout.gru_rollout(**{k: torch.from_numpy(v) for k, v in inp.items()}, ph=ph)
    want = gru_rollout_pallas(**{k: jnp.asarray(v) for k, v in inp.items()}, ph=ph,
                              batch_tile=8, interpret=True)
    assert got.shape == want.shape == (ph, n, B, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


# ---- plans, libraries and refusals on a CUDA request ------------------------------


def _zeros(n, dtype=torch.bfloat16, rows=4):
    """(module, counter, call) of every predictor kernel's wrapper at the
    flagship's widths (F 192, D 96, 8 heads × 32) and ``n`` nodes."""
    f, d, hd = 192, 96, 256
    z = lambda *s: torch.zeros(*s, dtype=dtype)  # noqa: E731
    x, g = z(n, rows, f), z(n, n)
    blk = (z(n, f, f), z(n, f), g, z(n, f, f), z(n, f), g)
    return [
        (graph_linear_fused, "launches", lambda: graph_linear_fused.graph_linear_fused(
            z(n, rows, d), z(n, d, f), z(n, f), g, x)),
        (resnet_block, "launches_block", lambda: resnet_block.resnet_block(x, z(2 * f), *blk)),
        (resnet_block, "launches_final_in", lambda: resnet_block.final_block_in(
            x, x, z(2 * f), z(n, 2 * f, f), z(n, f), g, z(n, 2 * f, f), g)),
        (resnet_block, "launches_final_out", lambda: resnet_block.final_block_out(
            x, x, z(n, f, f), z(n, f), g, z(n, f, d), z(n, d), g)),
        (attention_proj, "launches_rms_qkv", lambda: attention_proj.rms_qkv(
            x, z(f), z(n, f, 3 * hd), g)),
        (joint_attention, "launches", lambda: joint_attention.attention_core(
            z(n, rows, 3 * hd), heads=8, dim_head=32)),
        (attention_proj, "launches_outproj_res", lambda: attention_proj.outproj_res(
            z(n, rows, hd), x, z(n, hd, f), g)),
        (layer_fused, "launches_stem_block", lambda: layer_fused.stem_block(
            z(n, rows, d), x, z(2 * f), z(n, d, f), z(n, f), g, *blk)),
        (layer_fused, "launches_rms_qkv_core", lambda: layer_fused.rms_qkv_core(
            x, z(f), z(n, f, 3 * hd), g, heads=8, dim_head=32)),
        (layer_fused, "launches_outproj_block", lambda: layer_fused.outproj_block(
            z(n, rows, hd), x, z(2 * f), z(n, hd, f), g, *blk)),
        (posterior_step, "launches_x0_bf16" if dtype == torch.bfloat16 else "launches",
         lambda: posterior_step.posterior_step(
            z(n, rows, d), torch.zeros(n, rows, d), torch.zeros(n, rows, d),
            torch.zeros(n, 3 * n))),
    ]


def _cuda_request(monkeypatch, entry):
    monkeypatch.setattr(build, "kernel_device", lambda **tensors: "cuda")
    monkeypatch.setattr(build, "c_entry", entry)
    monkeypatch.setattr(build, "stream_of", lambda t: 0)
    monkeypatch.setattr(build, "check_aligned", lambda *a, **k: None)


@NODES
@both
def test_wrappers_ask_for_the_library_built_at_their_node_count(monkeypatch, n, dtype):
    """Every wrapper names the C entry of the library built at the tensors'
    node count and hands it that count and a plan that fits."""
    calls = []

    def recording(library, symbol, n_pointers, n_ints, nodes=build.DEFAULT_NODES):
        def entry(*args):
            calls.append((symbol, nodes, args[n_pointers:n_pointers + n_ints]))
            return 0
        return entry

    _cuda_request(monkeypatch, recording)
    dt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    for module, counter, call in _zeros(n, dt):
        before = getattr(module, counter)
        call()
        assert getattr(module, counter) == before + 1, counter
    assert len(calls) == len(_zeros(n))
    for symbol, nodes, ints in calls:
        assert nodes == ints[0] == n, symbol
        if symbol.startswith("posterior"):
            continue
        smem = ints[-1]
        assert 0 < smem <= node_mix_sm90.MAX_SMEM, (symbol, ints)


@NODES
def test_plans_at_the_skeletons_node_counts(n):
    """P and the fp32 influences take a plane or row a node: fewer nodes,
    less shared memory, so the ring holds at least as many bank rows as at
    21 nodes (more stages, or wider k-slices)."""
    for dt in (torch.bfloat16, torch.float32):
        small = resnet_block.resnet_block_plan(dt, 192, n)
        flagship = resnet_block.resnet_block_plan(dt, 192)
        assert small.stages * small.kslice >= flagship.stages * flagship.kslice
        elem = torch.empty((), dtype=dt).element_size()
        assert small.smem_bytes == node_mix_sm90.block_plan_bytes(
            elem, small.rows, 192, small.kslice, small.stages, 2, n)
        qkv = attention_proj.rms_qkv_plan(dt, 192, 768, n)
        assert qkv.smem_bytes == node_mix_sm90.plan_bytes(elem, qkv.rows, qkv.cols, 192,
                                                          qkv.stages, n)
        att = joint_attention.attention_plan(dt, 8, 32, n)
        assert att.smem_bytes == joint_attention.plan_bytes(elem, att.rows, att.group_heads, 32,
                                                            att.stages, n)
    assert node_mix_sm90.g_stride(n) == {16: 16, 17: 20}[n]
    plan = gru_rollout.rollout_plan(n, 96)
    assert plan.smem_bytes == gru_rollout.rollout_plan_bytes(n, 96, plan.stages) <= 232448
    assert plan.stages == {16: 4, 17: 3}[n]


def test_past_32_nodes_the_wrappers_refuse_naming_the_roadmap_item(monkeypatch):
    """The kernels take up to AMASS-MANO's 51 nodes since its slice (they
    took 32 before); past 51 every wrapper refuses, naming the ROADMAP item
    of other shapes, and counts no launch."""
    _cuda_request(monkeypatch, lambda *a: pytest.fail("launched"))
    for module, counter, call in _zeros(52):
        before = getattr(module, counter)
        with pytest.raises(ValueError, match="takes 2 to 51 nodes, got 52 .*Queue B item 9"):
            call()
        assert getattr(module, counter) == before


def test_the_fp32_rollout_refuses_past_21_nodes(monkeypatch):
    """K1's first design fills the 256 consumers at 21 nodes; past 21 its
    second design (2 rows a block) takes up to 51, and past 51 the wrapper
    refuses."""
    _cuda_request(monkeypatch, lambda *a: pytest.fail("launched"))
    n, b, h = 52, 8, 96
    z = torch.zeros
    with pytest.raises(ValueError, match="takes 2 to 51 nodes, got 52 .*Queue B item 9"):
        gru_rollout.gru_rollout(z(n, b, 3 * h), z(n, b, h), z(n, h, 3 * h), z(n, 3 * h),
                                z(n, n), z(n, n), z(n, h, 3), z(n, 3), z(n, n), ph=4)


def test_the_bf16_rollout_and_the_lab_core_stay_at_21_nodes(monkeypatch):
    """B8 and L1 take every skeleton's count now (2 to 51 nodes, as every
    source): their wrappers refuse 52 before they name a C entry."""
    _cuda_request(monkeypatch, lambda *a: pytest.fail("launched"))
    n, b, h = 52, 8, 96
    z = torch.zeros
    with pytest.raises(ValueError, match="takes 2 to 51 nodes, got 52 .*Queue B item 9"):
        gru_rollout.gru_rollout(z(n, b, 3 * h, dtype=torch.bfloat16), z(n, b, h),
                                z(n, h, 3 * h, dtype=torch.bfloat16), z(n, 3 * h), z(n, n),
                                z(n, n), z(n, h, 3, dtype=torch.bfloat16), z(n, 3), z(n, n), ph=4,
                                compute_dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="takes 2 to 51 nodes, got 52 .*Queue B item 9"):
        attention_core_fm.attention_core_fm(z(n, 3 * 256, b, dtype=torch.bfloat16), heads=8,
                                            dim_head=32)


FAKE_NVCC = """#!/bin/sh
printf '%s\\n' "$@" > "$(dirname "$0")/args.$$"
while [ "$#" -gt 1 ]; do
  if [ "$1" = "-o" ]; then echo lib > "$2"; fi
  shift
done
"""


def test_build_all_builds_each_source_once_for_each_node_count(tmp_path, monkeypatch):
    """One nvcc a (source, count) with -DSKD_NODES, all at once, into a
    directory of its own for each count (B8 and L1 too, as every source),
    and a library that exists is not built again."""
    home = tmp_path / "cuda"
    (home / "bin").mkdir(parents=True)
    nvcc = home / "bin" / "nvcc"
    nvcc.write_text(FAKE_NVCC)
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("CUDA_HOME", str(home))
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for name in ("resnet_block", "gru_rollout", "gru_rollout_merged", "attention_core_fm"):
        (csrc / f"{name}.cu").write_text(f"// {name}\n")
    monkeypatch.setattr(build, "CSRC_DIR", csrc)
    monkeypatch.setattr(build, "BUILD_ROOT", tmp_path / "build")
    build.build_all((21, 16, 17))
    calls = [p.read_text().split("\n") for p in (home / "bin").glob("args.*")]
    built = sorted((pathlib.Path(a[-2]).name, a[len(build.NVCC_FLAGS)]) for a in calls)
    assert built == sorted(
        (f"{s}.cu", f"-DSKD_NODES={n}") for n in (16, 17, 21)
        for s in ("resnet_block", "gru_rollout", "gru_rollout_merged", "attention_core_fm"))
    dirs = {n: build.build_dir(n) for n in (16, 17, 21)}
    assert len(set(dirs.values())) == 3
    assert all(build.library_path(s, n).is_file() for n in dirs
               for s in ("resnet_block", "gru_rollout_merged"))
    for p in (home / "bin").glob("args.*"):
        os.remove(p)
    assert build.build_all((16,)) == 0.0 and not list((home / "bin").glob("args.*"))


def test_library_refuses_a_node_count_before_building(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(build, "build_all", lambda *a: pytest.fail("built"))
    with pytest.raises(ValueError, match="got 52"):
        build.library("resnet_block", 52)
    with pytest.raises(ValueError, match="got 1 "):
        build.library("gru_rollout_merged", 1)
