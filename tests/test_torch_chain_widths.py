"""The fused denoiser's kernel chain at every width the JAX predictor's fused
gate admits (bf16, attention, heads·dh a multiple of 128, F = dim +
cond_dim ≤ 256), on the CPU where each kernel is its plain version:

- the route: ``chain_plans`` takes the grid G below at 16, 17, 21 and 51
  nodes in bf16, and ``chain_refusal`` on a CUDA device is None (plans
  only, nothing built); heads·dh of 384 and 512 are taken too;
- the padding (``denoiser_fused.chain_widths``, ``prep_fused_denoiser``):
  F to a multiple of 64, D and the head's columns to a multiple of 8, dh to
  the attention kernels' width, all with zeros, and sliced back;
- the port's padded fused core against the JAX package's
  ``fused_denoiser_core_nm`` with its Pallas kernels in interpret mode
  (which pads to its own 256 / 128 lanes), at G1, G2, G4 and G6: depth 2, 21
  nodes, 2 × 4 rows; one JAX trace a width, float32 at G2 and G4 (5e-5,
  rtol 1e-4, the tolerance of ``test_fused_denoiser_matches_flax``), bf16 at
  G1 and G6 (``assert_bf16_close``);
- the attention core's plain version against ``attention_core_pallas`` in
  interpret mode at dim_head 4 (zero-padded to 16), 16, 64 and 128;
- the host side of the kernels at the new widths: B9b's plan and its head
  tiles in parts, B3a's 16-row tile at F = 256, the whole-row engine's 4
  rows past 21 nodes at F = 256, and the ints the wrappers hand the C
  entries;
- the sampler's K2 entry at a latent off the 8-granule: a bf16 x̂₀ whose
  B·D is not a multiple of 8 is widened for the fp32 entry.

The grid G (encoder and decoder hidden 96 on the card; here the denoiser
alone):

    G1  latent 80 (F 160)   8 × 16     G4  latent 100 (F 200)  4 × 32
    G2  latent 96 (F 192)   2 × 64     G5  latent 128 (F 256)  4 × 64
    G3  latent 112 (F 224)  1 × 128    G6  latent 48 (F 96)    32 × 4
"""
import re
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skeletondiffusion_tpu.diffusion.manager import create_diffusion as jax_create_diffusion
from skeletondiffusion_tpu.ops.pallas import denoiser_fused as jax_fused
from skeletondiffusion_tpu.ops.pallas.joint_attention import attention_core_pallas
from skeletondiffusion_tpu_torch.diffusion.engine import GaussianDiffusion
from skeletondiffusion_tpu_torch.diffusion.manager import create_diffusion
from skeletondiffusion_tpu_torch.models.denoiser import Denoiser
from skeletondiffusion_tpu_torch.ops.kernels import (attention_proj, build, denoiser_fused,
                                                     joint_attention, layer_fused)
from skeletondiffusion_tpu_torch.ops.kernels import node_mix_sm90 as engine
from skeletondiffusion_tpu_torch.ops.kernels import posterior_step as k2
from skeletondiffusion_tpu_torch.weights import load_denoiser_params

from torch_parity import (ARCH, TIMESTEPS, as_jax, assert_bf16_close, pad_to, perturb_influence,
                          skeletons, spread_weights)

GRID = {"G1": (80, 8, 16), "G2": (96, 2, 64), "G3": (112, 1, 128), "G4": (100, 4, 32),
        "G5": (128, 4, 64), "G6": (48, 32, 4)}
CUDA = torch.device("cuda")
N, ROWS = 21, 2 * 4


def _denoiser(dim, heads, dim_head, n=N, depth=4, dtype=torch.bfloat16):
    return Denoiser(dim=dim, out_dim=dim, channels=n, generator=torch.Generator().manual_seed(0),
                    cond_dim=dim, depth=depth, attn_heads=heads, attn_dim_head=dim_head,
                    compute_dtype=dtype)


# ---- the route ---------------------------------------------------------------

@pytest.mark.parametrize("n", [16, 17, 21, 51])
@pytest.mark.parametrize("name", sorted(GRID))
def test_the_chain_takes_every_grid_width(n, name):
    """Every G width passes the JAX gate and every plan of the chain."""
    dim, heads, dim_head = GRID[name]
    assert (heads * dim_head) % 128 == 0 and 2 * dim <= 256  # the JAX gate
    den = _denoiser(dim, heads, dim_head, n)
    plans = denoiser_fused.chain_plans(den)
    assert len(plans) == 10 and all(p.smem_bytes <= engine.MAX_SMEM for p in plans)
    assert denoiser_fused.chain_refusal(den, CUDA) is None
    # fp32 keeps its refusal: the JAX gate is bf16 only (ROADMAP Queue B item 5)
    den.compute_dtype = torch.float32
    assert "bf16" in denoiser_fused.chain_refusal(den, CUDA)


@pytest.mark.parametrize("n", [21, 51])
@pytest.mark.parametrize("heads, dim_head", [(12, 32), (3, 128), (16, 32), (4, 128), (8, 64)])
def test_the_chain_takes_heads_of_384_and_512_columns(n, heads, dim_head):
    den = _denoiser(96, heads, dim_head, n)
    assert denoiser_fused.chain_refusal(den, CUDA) is None


@pytest.mark.parametrize("heads, dim_head, match", [
    (1, 256, "heads of 16, 32, 64 or 128 columns .*got 1 × 256 .*Queue B item 9"),
    (64, 2, "1 to 32 heads .*got 64 × 16 .*Queue B item 9"),
])
def test_the_chain_refuses_heads_past_the_kernels_naming_the_roadmap(heads, dim_head, match):
    den = _denoiser(64, heads, dim_head)
    refusal = denoiser_fused.chain_refusal(den, CUDA)
    assert refusal is not None and re.search(match, refusal), refusal
    assert "[the chain's widths: F 128 → 128" in refusal
    assert denoiser_fused.chain_refusal(den, torch.device("cpu")) is None


def test_chain_widths_pad_to_the_kernels_granules():
    widths = {name: denoiser_fused.chain_widths(_denoiser(*GRID[name], depth=1))
              for name in GRID}
    assert widths["G1"][:6] == (160, 192, 80, 80, 80, 80) and widths["G1"].width == 16
    assert widths["G3"][:2] == (224, 256) and widths["G3"].width == 128
    assert widths["G4"][:6] == (200, 256, 100, 104, 100, 104) and widths["G4"].width == 32
    assert widths["G5"][:2] == (256, 256) and widths["G5"].width == 64
    assert widths["G6"][:2] == (96, 128) and widths["G6"].width == 16
    # the flagship's widths are the kernels' own: nothing is padded
    flag = denoiser_fused.chain_widths(_denoiser(96, 8, 32, depth=1))
    assert (flag.f, flag.d, flag.out, flag.dim_head) == (flag.f_pad, flag.d_pad, flag.out_pad,
                                                         flag.width)


@pytest.mark.parametrize("name", ["G4", "G6"])
def test_prep_pads_with_zeros_and_keeps_the_true_widths(name):
    """The padded banks hold the module's weights in place and zeros past
    them; the RMSNorm gain keeps √F of the true F; the head's q, k and v
    columns are padded each to W."""
    dim, heads, dim_head = GRID[name]
    den = _denoiser(dim, heads, dim_head, depth=1, dtype=None)
    prep = denoiser_fused.prep_fused_denoiser(den)
    w = prep["widths"]
    f, fp, width = w.f, w.f_pad, w.width
    blk, att = prep["blocks"][0], prep["attns"][0]
    assert blk["w1"].shape == (N, fp, fp) and blk["b1"].shape == (N, fp)
    proj = den.res0.block1.proj
    assert torch.equal(blk["w1"][:, :f, :f], proj.weight[proj.type_index])
    assert not blk["w1"][:, f:].any() and not blk["w1"][:, :, f:].any()
    assert not blk["b1"][:, f:].any()
    g_rms = att["g_rms"]
    assert torch.allclose(g_rms[:f], den.attn0.norm.g.reshape(f) * f ** 0.5)
    assert not g_rms[f:].any()
    qkv = att["w_qkv"].reshape(N, fp, 3, heads, width)
    assert not qkv[..., dim_head:].any() and not qkv[:, f:].any()
    bank = den.attn0.attn.to_qkv.weight[den.attn0.attn.to_qkv.type_index]
    assert torch.equal(qkv[:, :f, :, :, :dim_head], bank.reshape(N, f, 3, heads, dim_head))
    out = att["w_out"].reshape(N, heads, width, fp)
    assert not out[:, :, dim_head:].any() and not out[..., f:].any()
    stem, head, fin = prep["stem"], prep["head"], prep["final"]
    assert stem["w"].shape == (N, w.d_pad, fp) and not stem["w"][:, w.d:].any()
    assert head["w"].shape == (N, fp, w.out_pad) and not head["w"][:, :, w.out:].any()
    assert fin["w1"].shape == (N, 2 * fp, fp)
    assert not fin["w1"][:, f:fp].any() and not fin["w1"][:, fp + f:].any()
    assert torch.equal(fin["w1"][:, fp:fp + f, :f],
                       den.final_res_block.block1.proj.weight[
                           den.final_res_block.block1.proj.type_index][:, f:])


def test_the_sampler_pads_the_condition_once_a_call(monkeypatch):
    """The engine pads u to the chain's width once a sampling call; the
    chain's steps take it as it is."""
    _, sk = skeletons()
    engine_port, _ = create_diffusion(sk, torch.Generator().manual_seed(0), latent_size=100,
                                      diffusion_conditioning=True, diffusion_timesteps=3,
                                      diffusion_arch={**ARCH, "attn_heads": 4,
                                                      "attn_dim_head": 32},
                                      device="cpu", compute_dtype=torch.bfloat16)
    engine_port.fused = denoiser_fused.prep_fused_denoiser(engine_port.denoiser)
    pads, widths = [], []
    real_pad = denoiser_fused.pad_condition
    monkeypatch.setattr("skeletondiffusion_tpu_torch.diffusion.engine.pad_condition",
                        lambda *a: pads.append(1) or real_pad(*a))
    real_core = denoiser_fused.fused_denoiser_core_nm
    monkeypatch.setattr("skeletondiffusion_tpu_torch.diffusion.engine.fused_denoiser_core_nm",
                        lambda den, x, t, u, p: widths.append(u.shape[-1]) or real_core(
                            den, x, t, u, p))
    xc = torch.randn(2, sk.num_nodes, 100)
    out, _ = engine_port.p_sample_loop(xc, generator=torch.Generator().manual_seed(1))
    assert pads == [1] and widths == [256] * 3 and out.shape == (2, sk.num_nodes, 100)


# ---- the padded core against the JAX fused core --------------------------------

def _model_pair(name: str, dtype):
    """The JAX denoiser and the port's with the same weights (perturbed
    influences, spread banks) at G width ``name``, depth 2."""
    dim, heads, dim_head = GRID[name]
    jsk, sk = skeletons()
    arch = {**ARCH, "depth": 2, "attn_heads": heads, "attn_dim_head": dim_head}
    rng = np.random.default_rng(11)
    _, jden = jax_create_diffusion(
        jsk, diffusion_type="NonisotropicGaussianDiffusion", covariance_matrix_type="adjacency",
        latent_size=dim, diffusion_conditioning=True, diffusion_timesteps=TIMESTEPS,
        diffusion_arch=dict(arch), compute_dtype=dtype)
    params = jden.init(jax.random.key(5), jnp.zeros((1, N, dim)), jnp.zeros((1,), jnp.int32),
                       jnp.zeros((1, N, dim)))
    params = spread_weights(perturb_influence(jax.device_get(params), rng), rng)
    _, den = create_diffusion(sk, torch.Generator().manual_seed(0), latent_size=dim,
                              diffusion_conditioning=True, diffusion_timesteps=TIMESTEPS,
                              diffusion_arch=dict(arch), device="cpu",
                              compute_dtype={None: None, "bfloat16": torch.bfloat16}[dtype])
    load_denoiser_params(den, params)
    return jden, as_jax(params), den


@pytest.mark.parametrize("name, dtype", [("G1", "bfloat16"), ("G2", None), ("G4", None),
                                         ("G6", "bfloat16")])
def test_padded_core_matches_the_jax_fused_core(name, dtype):
    dim = GRID[name][0]
    jden, params, den = _model_pair(name, dtype)
    rng = np.random.default_rng(3)
    x = 0.5 * rng.standard_normal((N, ROWS, dim), dtype=np.float32)
    xc = np.tanh(rng.standard_normal((ROWS, N, dim), dtype=np.float32))
    u = jden.apply(params, jnp.asarray(xc), method=jden.cond_embedding)
    want = jax_fused.fused_denoiser_core_nm(
        jden, params, pad_to(jnp.asarray(x), 128), jnp.asarray(1, jnp.int32), pad_to(u, 256),
        batch_tile=8, interpret=True)[:, :, :dim]
    want = np.asarray(want.astype(jnp.float32))
    with torch.no_grad():
        got = denoiser_fused.fused_denoiser_core_nm(den, torch.from_numpy(x), 1,
                                                    den.cond_embedding(torch.from_numpy(xc)))
    assert got.shape == (N, ROWS, dim)
    if dtype is None:
        np.testing.assert_allclose(got.numpy(), want, atol=5e-5, rtol=1e-4)
    else:
        assert got.dtype == torch.bfloat16
        assert_bf16_close(got.float().numpy(), want, name)


# ---- the attention core at other head widths -----------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("heads, dim_head", [(32, 4), (8, 16), (2, 64), (1, 128)])
def test_attention_core_plain_matches_pallas_at_every_head_width(heads, dim_head, dtype):
    """The plain version on q‖k‖v with each head's columns zero-padded to the
    kernels' width W (dh 4 → 16) gives the Pallas kernel's output in its
    first dh columns a head and zeros past them; unpadded it gives the
    same."""
    tdt, jdt = {"float32": (torch.float32, jnp.float32),
                "bfloat16": (torch.bfloat16, jnp.bfloat16)}[dtype]
    width = joint_attention.head_width(dim_head)
    rng = np.random.default_rng(dim_head)
    qkv = torch.from_numpy(rng.standard_normal((N, ROWS, 3 * heads * dim_head),
                                               dtype=np.float32)).to(tdt)
    want = attention_core_pallas(jnp.asarray(qkv.float().numpy(), jdt), heads=heads,
                                 dim_head=dim_head, batch_tile=8, interpret=True)
    want = np.asarray(jnp.asarray(want, jnp.float32)).reshape(N, ROWS, heads, dim_head)
    padded = torch.nn.functional.pad(qkv.reshape(N, ROWS, 3 * heads, dim_head),
                                     (0, width - dim_head)).reshape(N, ROWS, -1)
    got = joint_attention.attention_core_plain(padded, heads, dim_head)
    assert got.shape == (N, ROWS, heads * width)
    got = got.float().reshape(N, ROWS, heads, width).numpy()
    assert not got[..., dim_head:].any()
    unpadded = joint_attention.attention_core_plain(qkv, heads, dim_head).float().numpy()
    np.testing.assert_array_equal(unpadded.reshape(N, ROWS, heads, dim_head), got[..., :dim_head])
    if dtype == "float32":
        np.testing.assert_allclose(got[..., :dim_head], want, atol=2e-5, rtol=1e-4)
    else:
        assert_bf16_close(got[..., :dim_head], want, f"{heads} × {dim_head}")


# ---- the kernels' host side at the new widths -------------------------------------

@pytest.mark.parametrize("n", [16, 17, 21, 51])
@pytest.mark.parametrize("width", [16, 32, 64, 128])
@pytest.mark.parametrize("f", [64, 128, 192, 256])
def test_b9b_plan_takes_every_head_width(n, width, f):
    """B9b's item holds a head's whole products (N × rows × 3·W) and brings
    its weight tile in parts where the whole would not fit two stages; the
    plan is the first part width of CORE_TILES that fits, with as many
    stages as fit."""
    plan = layer_fused.rms_qkv_core_plan(torch.bfloat16, f, 4, width, n)
    rows, parts = (layer_fused.CORE_TILES_WIDE if build.wide(n)
                   else layer_fused.CORE_TILES)[torch.bfloat16][width]
    assert plan.rows == rows and plan.cols in parts and (3 * width) % plan.cols == 0
    assert plan.smem_bytes == engine.plan_bytes(2, rows, 3 * width, f, plan.stages, n, plan.cols)
    assert plan.smem_bytes <= engine.MAX_SMEM and 2 <= plan.stages <= engine.MAX_STAGES
    for wider in parts[:parts.index(plan.cols)]:  # the wider parts do not fit two stages
        assert engine.plan_bytes(2, rows, 3 * width, f, 2, n, wider) > engine.MAX_SMEM
    # the flagship's plan is the one it had: one part of all 96 columns
    if (n, width, f) == (21, 32, 192):
        assert tuple(plan) == (32, 96, 2, 2, 227840)


def test_b9b_refuses_fp32_heads_past_32():
    with pytest.raises(ValueError, match="bf16 only .*Queue B item 5"):
        layer_fused.rms_qkv_core_plan(torch.float32, 64, 2, 64)


def test_head_columns_in_parts_are_the_heads_columns_in_order():
    whole = engine.head_columns(2, 64)
    parts = engine.head_columns(2, 64, 64)
    assert whole.shape == (2, 192) and parts.shape == (6, 64)
    assert torch.equal(parts.reshape(2, 192), whole)
    w = torch.randn(N, 32, 3 * 2 * 64).to(torch.bfloat16)
    packed = engine.pack_banks(w, ("heads", 2, 64, 64))
    assert packed.shape == (N, 6, 32 * 64)
    assert torch.equal(packed[:, 3], engine.pack_banks(w[:, :, whole[1, :64]],
                                                        ("groups", 64, 64))[:, 0])


def test_rms_qkv_and_the_whole_row_engine_at_f_256():
    """B3a takes 16 × 96 tiles where 32 × 96 do not fit (F = 256 up to 21
    nodes); the whole-row kernels take 4 rows past 21 nodes at F = 256."""
    assert tuple(attention_proj.rms_qkv_plan(torch.bfloat16, 192, 768))[:2] == (32, 96)
    assert tuple(attention_proj.rms_qkv_plan(torch.bfloat16, 256, 384))[:2] == (16, 96)
    assert tuple(attention_proj.rms_qkv_plan(torch.bfloat16, 256, 384, 51))[:2] == (16, 64)
    assert engine.block_rows(torch.bfloat16, 51, 256) == 4
    assert engine.block_rows(torch.bfloat16, 51, 192) == 8
    assert engine.block_rows(torch.bfloat16, 21, 256) == 16
    assert engine.block_rows(torch.float32, 51, 256) == 8
    plan = engine.block_plan("resnet_block", torch.bfloat16, 256, (256, 256), 51)
    assert plan.rows == 4 and plan.smem_bytes == engine.block_plan_bytes(
        2, 4, 256, plan.kslice, plan.stages, 2, 51) <= engine.MAX_SMEM


def _recording(calls):
    def entry_of(library, symbol, n_pointers, n_ints, nodes=21):
        def entry(*args):
            calls.append((symbol, args[n_pointers:-1]))
            return 0
        return entry
    return entry_of


def test_wrappers_hand_the_kernels_the_head_width_and_the_true_dim_head(monkeypatch):
    """A padded head (dh 4 → W 16): B2 and B9b get W and dh (the scale's),
    B9b its head tiles in the plan's parts; both return H·W columns."""
    calls = []
    monkeypatch.setattr(build, "kernel_device", lambda **tensors: "cuda")
    monkeypatch.setattr(build, "c_entry", _recording(calls))
    monkeypatch.setattr(build, "stream_of", lambda t: 0)
    z = lambda *s: torch.zeros(*s, dtype=torch.bfloat16)  # noqa: E731
    out = joint_attention.attention_core(z(N, 5, 3 * 32 * 16), heads=32, dim_head=4)
    assert out.shape == (N, 5, 32 * 16)
    plan = joint_attention.attention_plan(torch.bfloat16, 32, 16)
    assert calls[-1] == ("attention_core_bf16", (N, 5, 32, 16, 4, *plan))
    out = layer_fused.rms_qkv_core(z(N, 5, 256), z(256), z(N, 256, 3 * 4 * 64), z(N, N),
                                   heads=4, dim_head=64)
    plan = layer_fused.rms_qkv_core_plan(torch.bfloat16, 256, 4, 64)
    assert out.shape == (N, 5, 256) and plan.cols == 64
    assert calls[-1] == ("rms_qkv_core_bf16", (N, 5, 256, 4, 64, 64, *plan))


@pytest.mark.parametrize("rows,symbol", [(4, "posterior_step_x0_bf16"), (3, "posterior_step_f32")])
def test_the_sampler_widens_a_bf16_x0_the_bf16_entry_cannot_read(monkeypatch, rows, symbol):
    """G4's latent 100 at an odd row count: B·D is not a multiple of 8, so
    the sampler hands K2 its x̂₀ widened to fp32 (exact), the fp32 entry;
    at an even count the bf16 entry takes it."""
    calls = []
    monkeypatch.setattr(build, "kernel_device", lambda **tensors: "cuda")
    monkeypatch.setattr(build, "c_entry", _recording(calls))
    monkeypatch.setattr(build, "stream_of", lambda t: 0)
    x0 = torch.zeros(N, rows, 100, dtype=torch.bfloat16)
    xt = torch.zeros(N, rows, 100)
    sampler = SimpleNamespace(step_tables=torch.zeros(1, N, 3 * N))
    out = GaussianDiffusion.posterior_step(sampler, x0, xt, torch.zeros_like(xt), 0)
    plan = k2.posterior_plan(N, torch.bfloat16 if rows == 4 else torch.float32)
    assert out.shape == xt.shape
    assert calls == [(symbol, (N, rows * 100, plan.warps, plan.stages, plan.smem))]
