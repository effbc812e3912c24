"""The predictor's kernels at AMASS-MANO's 51 nodes on the CPU: each plain
PyTorch version against the JAX package's Pallas kernel in interpret mode at
small widths (F 64, D 32, 4 heads × 32, a batch of 8): the engine's kernels
(B4, B1, B5a, B5b, B3a, B3b, B9b) and B2 in bf16, the path's type; B2,
K2 (both entries) and K1 (H 16, 12 steps) in fp32.  Tolerances as
``tests/test_torch_skeleton_kernels.py``: float32 at atol 2e-5 (K1, K2
1e-5), bf16 at the bf16 criteria."""
import jax.numpy as jnp
import numpy as np
import torch

from skeletondiffusion_tpu.ops.pallas import resnet_block as pallas_resnet
from skeletondiffusion_tpu.ops.pallas.attention_proj import outproj_res_pallas, rms_qkv_pallas
from skeletondiffusion_tpu.ops.pallas.graph_linear_fused import graph_linear_pallas
from skeletondiffusion_tpu.ops.pallas.gru_rollout import gru_rollout_pallas
from skeletondiffusion_tpu.ops.pallas.joint_attention import attention_core_pallas
from skeletondiffusion_tpu.ops.pallas.layer_fused import rms_qkv_core_pallas
from skeletondiffusion_tpu.ops.pallas.posterior_step import posterior_step_pallas
from skeletondiffusion_tpu_torch.ops.graph_linear import l1_normalize_rows
from skeletondiffusion_tpu_torch.ops.kernels import attention_proj, graph_linear_fused
from skeletondiffusion_tpu_torch.ops.kernels import gru_rollout, joint_attention, layer_fused
from skeletondiffusion_tpu_torch.ops.kernels import posterior_step, resnet_block

from test_torch_skeleton_kernels import _block, _rect, _split
from torch_parity import KernelInputs, check_kernel, pad_to

N, B, D, F, HEADS, DH = 51, 8, 32, 64, 4, 32
HD = HEADS * DH
FP = 128  # the Pallas kernels' padded feature width
BF16 = "bfloat16"


def test_stem_block_and_final_block_plain_match_pallas():
    """B4, B1, B5a and B5b."""
    inp = KernelInputs(BF16, 151, nodes=N)
    (x, jx), (w, jw), (b, jb), (g, jg), (u, ju) = (
        inp.act(N, B, D), inp.bank(D, F), inp.bias(F), inp.influence(), inp.act(N, B, F))
    got = graph_linear_fused.graph_linear_fused(x, w, b, g, u)
    want = graph_linear_pallas(pad_to(jx, 128), pad_to(jw, 128, FP), pad_to(jb, FP), jg,
                               u=pad_to(ju, FP), batch_tile=8, interpret=True)[:, :, :F]
    check_kernel(got, want, BF16, "stem")
    t, j = _split([inp.act(N, B, F), *_block(inp)])
    got = resnet_block.resnet_block(*t)
    want = pallas_resnet.resnet_block_pallas(j[0], j[1][None], *j[2:], f_pad=FP, batch_tile=8,
                                             interpret=True)
    check_kernel(got, want, BF16, "block")
    t, j = _split([inp.act(N, B, F), inp.act(N, B, F), inp.film(F), inp.bank(2 * F, F),
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
    check_kernel(got, want, BF16, "final block")


def test_attention_layer_plain_matches_pallas():
    """B3a, B2 (bf16 and fp32) and B3b in turn, each on the Pallas kernel's
    own input."""
    inp = KernelInputs(BF16, 152, nodes=N)
    (x, jx), (w, jw), (g, jg) = inp.act(N, B, F), inp.bank(F, 3 * HD), inp.influence()
    g_rms, jg_rms = inp._make((1.0 + 0.1 * inp.rng.standard_normal(F)) * np.sqrt(F))
    qkv = attention_proj.rms_qkv(x, g_rms, w, g)
    jqkv = rms_qkv_pallas(pad_to(jx, FP), pad_to(jg_rms[None], FP),
                          pad_to(jw.swapaxes(1, 2), FP).swapaxes(1, 2), jg, batch_tile=8,
                          interpret=True)
    check_kernel(qkv, jqkv, BF16, "rms_qkv")
    as_t = lambda a: torch.from_numpy(np.array(a.astype(jnp.float32))).to(x.dtype)  # noqa: E731
    core = joint_attention.attention_core(as_t(jqkv), heads=HEADS, dim_head=DH)
    jcore = attention_core_pallas(jqkv, heads=HEADS, dim_head=DH, batch_tile=8, interpret=True)
    check_kernel(core, jcore, BF16, "attention_core")
    j32 = jqkv.astype(jnp.float32)
    core32 = joint_attention.attention_core(as_t(j32).float(), heads=HEADS, dim_head=DH)
    check_kernel(core32, attention_core_pallas(j32, heads=HEADS, dim_head=DH, batch_tile=8,
                                               interpret=True), "float32", "attention_core fp32")
    (wo, jwo), (go, jgo) = inp.bank(HD, F), inp.influence()
    out = attention_proj.outproj_res(as_t(jcore), x, wo, go)
    want = outproj_res_pallas(jcore, pad_to(jx, FP), pad_to(jwo, FP), jgo, batch_tile=8,
                              interpret=True)[:, :, :F]
    check_kernel(out, want, BF16, "outproj_res")


def test_layer_fused_kernels_plain_match_pallas():
    """B9b (its plain version, B3a's followed by B2's, against the fused
    Pallas kernel); B9a's and B9c's plain versions compose B4, B1 and B3b,
    held above, and the kernels themselves are held on the card."""
    inp = KernelInputs(BF16, 153, nodes=N)
    (x, jx), (w, jw), (g, jg) = inp.act(N, B, F), inp.bank(F, 3 * HD), inp.influence()
    g_rms, jg_rms = inp._make((1.0 + 0.1 * inp.rng.standard_normal(F)) * np.sqrt(F))
    got = layer_fused.rms_qkv_core(x, g_rms, w, g, heads=HEADS, dim_head=DH)
    want = rms_qkv_core_pallas(pad_to(jx, FP), pad_to(jg_rms[None], FP),
                               pad_to(jw.swapaxes(1, 2), FP).swapaxes(1, 2), jg, heads=HEADS,
                               dim_head=DH, batch_tile=8, query_chunk=3, interpret=True)
    check_kernel(got, want, BF16, "rms_qkv_core")


def test_posterior_step_plain_matches_pallas():
    rng = np.random.default_rng(N)
    xt, eps = (rng.standard_normal((N, B, 128), dtype=np.float32) for _ in range(2))
    m = 0.3 * rng.standard_normal((N, 3 * N), dtype=np.float32)
    for x0_dtype in ("float32", BF16):
        x0, jx0 = KernelInputs(x0_dtype, 160, nodes=N).act(N, B, 128, scale=1.5)
        got = posterior_step.posterior_step(x0, torch.from_numpy(xt), torch.from_numpy(eps),
                                            torch.from_numpy(m))
        want = posterior_step_pallas(jx0, jnp.asarray(xt), jnp.asarray(eps), jnp.asarray(m),
                                     batch_tile=8, interpret=True)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


def test_gru_rollout_plain_matches_pallas():
    """K1 at 51 nodes, 12 steps, H 16."""
    rng, h, ph = np.random.default_rng(170), 16, 12
    norm = lambda g: l1_normalize_rows(torch.from_numpy(g)).numpy()  # noqa: E731
    infl = lambda: norm(np.eye(N, dtype=np.float32) + 0.2 * rng.random((N, N), dtype=np.float32))
    inp = dict(cx=rng.standard_normal((N, B, 3 * h), dtype=np.float32),
               h0=0.5 * rng.standard_normal((N, B, h), dtype=np.float32),
               w_hh=0.3 * rng.standard_normal((N, h, 3 * h), dtype=np.float32),
               b_hh=0.3 * rng.standard_normal((N, 3 * h), dtype=np.float32), g0=infl(),
               g_add=0.05 * (rng.random((N, N), dtype=np.float32) - 0.5),
               w_fc=0.3 * rng.standard_normal((N, h, 3), dtype=np.float32),
               b_fc=0.3 * rng.standard_normal((N, 3), dtype=np.float32), g_fc=infl())
    got = gru_rollout.gru_rollout(**{k: torch.from_numpy(v) for k, v in inp.items()}, ph=ph)
    want = gru_rollout_pallas(**{k: jnp.asarray(v) for k, v in inp.items()}, ph=ph,
                              batch_tile=8, interpret=True)
    assert got.shape == want.shape == (ph, N, B, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)
