"""The layer-fused bf16 denoiser path (``SKELDIFF_LAYER_FUSED=1``) on the
CPU, and where the port's plain bf16 modules round.

* The per-layer kernels' plain versions (B9a–c) against the JAX package's
  Pallas kernels (``skeletondiffusion_tpu/ops/pallas/layer_fused.py``) run
  with ``interpret=True``, at the flagship's widths and a batch of 16; the
  Pallas kernels get their feature axes zero-padded to 128-lane multiples,
  as ``tests/test_torch_denoiser_kernels.py`` pads them.  float32 at atol
  2e-5, rtol 1e-4; bf16 by ``assert_bf16_close``.
* The port's ``fused_denoiser_core_nm`` with the variable set against the
  JAX one with the variable set, at depth 2 (float32 at 5e-5, as
  ``tests/test_pallas_resnet.py::test_fused_denoiser_matches_flax`` holds
  it; bf16 by ``assert_bf16_close``), and against the port's own
  single-stage core (float32, ≤ 1e-5).
* The bf16 predictor with the variable set, end to end with injected noise,
  against the JAX fused chain with the variable set, within ``BF16_SPREAD``
  of the JAX chain's own bf16-vs-fp32 deviation.
* ``test_plain_bf16_modules_round_where_xla_rounds``: one graph-GRU encoder
  pass and each module of one denoiser forward against the jitted flax
  modules under ``compute_dtype="bfloat16"``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skeletondiffusion_tpu.models import AutoEncoder as JaxAutoEncoder
from skeletondiffusion_tpu.ops.attention import PreNormAttentionResidual as JaxAttention
from skeletondiffusion_tpu.ops.attention import ResnetBlock as JaxResnetBlock
from skeletondiffusion_tpu.ops.graph_linear import StaticGraphLinear as JaxGraphLinear
from skeletondiffusion_tpu.ops.pallas import denoiser_fused as jax_fused
from skeletondiffusion_tpu.ops.pallas.layer_fused import (outproj_block_pallas,
                                                           rms_qkv_core_pallas, stem_block_pallas)
from skeletondiffusion_tpu.ops.pallas.resnet_block import pad_film
from skeletondiffusion_tpu_torch.ops.kernels import denoiser_fused, layer_fused

from torch_parity import (WIDE, KernelInputs, assert_bf16_close, check_kernel,
                          golden_predictor_runs, hold_bf16_predictor, pad_to, wide_model_pair)

N, L = 21, WIDE["latent"]
F = 2 * L  # the denoiser's width: latent ‖ conditioning
HEADS, DH = WIDE["arch"]["attn_heads"], WIDE["arch"]["attn_dim_head"]
HD = HEADS * DH
B, FP = 16, 256  # the kernel tests' batch; the Pallas kernels' padded width
ROWS = 8         # the denoiser tests' batch rows


@pytest.fixture(scope="module")
def wide_models():
    """(JAX skeleton, port skeleton, {dtype: models}) of the flagship-width
    test model with spread denoiser weights, as ``tests/test_torch_fused.py``
    builds them."""
    return wide_model_pair()


# ---- the per-layer kernels' plain versions against their Pallas kernels -----

both = pytest.mark.parametrize("dtype", ["float32", "bfloat16"])


def _split(made):
    return [t for t, _ in made], [j for _, j in made]


def _block_inputs(inp: KernelInputs):
    """A ResnetBlock's FiLM row and banks: film, w1, b1, g1, w2, b2, g2."""
    return [inp.film(F), inp.bank(F, F), inp.bias(F), inp.influence(), inp.bank(F, F),
            inp.bias(F), inp.influence()]


def _pallas_block(film, w1, b1, g1, w2, b2, g2):
    """(padded FiLM row, padded block banks) as ``prep_fused_denoiser`` pads
    them for the Pallas kernels."""
    return (pad_film(film[None], F, FP).astype(film.dtype),
            dict(w1=pad_to(w1, FP, FP), b1=pad_to(b1, FP), g1=g1, w2=pad_to(w2, FP, FP),
                 b2=pad_to(b2, FP), g2=g2))


@both
def test_stem_block_plain_matches_pallas(dtype):
    inp = KernelInputs(dtype, 10)
    t, j = _split([inp.act(N, B, L), inp.act(N, B, F), inp.bank(L, F), inp.bias(F),
                   inp.influence(), *_block_inputs(inp)])
    r, out = layer_fused.stem_block(*t[:2], t[5], *t[2:5], *t[6:])
    assert r.dtype == out.dtype == t[0].dtype and r.shape == out.shape == (N, B, F)
    filmp, blk = _pallas_block(*j[5:])
    jr, jout = stem_block_pallas(pad_to(j[0], 128), pad_to(j[1], FP), filmp,
                                 dict(w=pad_to(j[2], 128, FP), b=pad_to(j[3], FP), g=j[4]), blk,
                                 batch_tile=8, interpret=True)
    check_kernel(r, jr[:, :, :F], dtype, "r")
    check_kernel(out, jout[:, :, :F], dtype, "out")


@both
def test_rms_qkv_core_plain_matches_pallas(dtype):
    inp = KernelInputs(dtype, 11)
    (x, jx), (w, jw), (g, jg) = inp.act(N, B, F), inp.bank(F, 3 * HD), inp.influence()
    g_rms, jg_rms = inp._make((1.0 + 0.1 * inp.rng.standard_normal(F)) * np.sqrt(F))
    got = layer_fused.rms_qkv_core(x, g_rms, w, g, heads=HEADS, dim_head=DH)
    assert got.dtype == x.dtype and got.shape == (N, B, HD)
    want = rms_qkv_core_pallas(pad_to(jx, FP), pad_to(jg_rms[None], FP),
                               pad_to(jw.swapaxes(1, 2), FP).swapaxes(1, 2), jg, heads=HEADS,
                               dim_head=DH, batch_tile=8, query_chunk=2, interpret=True)
    check_kernel(got, want, dtype)


@both
def test_outproj_block_plain_matches_pallas(dtype):
    inp = KernelInputs(dtype, 12)
    t, j = _split([inp.act(N, B, HD), inp.act(N, B, F), inp.bank(HD, F), inp.influence(),
                   *_block_inputs(inp)])
    got = layer_fused.outproj_block(*t[:2], t[4], t[2], t[3], *t[5:])
    assert got.dtype == t[1].dtype and got.shape == (N, B, F)
    filmp, blk = _pallas_block(*j[4:])
    want = outproj_block_pallas(j[0], pad_to(j[1], FP), filmp, pad_to(j[2], FP), j[3], blk,
                                batch_tile=8, interpret=True)[:, :, :F]
    check_kernel(got, want, dtype)


# ---- the layer-fused denoiser core -------------------------------------------

def _core_inputs(seed: int):
    rng = np.random.default_rng(seed)
    x = 0.5 * rng.standard_normal((N, ROWS, L), dtype=np.float32)
    xc = np.tanh(rng.standard_normal((ROWS, N, L), dtype=np.float32))
    return x, xc


def _jax_core(m, x, xc, t):
    u = m["jden"].apply(m["den_params"], jnp.asarray(xc), method=m["jden"].cond_embedding)
    out = jax_fused.fused_denoiser_core_nm(
        m["jden"], m["den_params"], pad_to(jnp.asarray(x), 128), jnp.asarray(t, jnp.int32),
        pad_to(u, FP), batch_tile=8, interpret=True)[:, :, :L]
    return np.asarray(out.astype(jnp.float32))


@pytest.mark.parametrize("dtype", [None, "bfloat16"])
def test_layer_fused_core_matches_jax(wide_models, monkeypatch, dtype):
    """Both packages' cores with SKELDIFF_LAYER_FUSED=1: float32 at the
    tolerance of ``test_fused_denoiser_matches_flax``, bf16 by the bf16
    criteria."""
    monkeypatch.setenv("SKELDIFF_LAYER_FUSED", "1")
    _, _, models = wide_models
    m = models[dtype]
    x, xc = _core_inputs(1)
    want = _jax_core(m, x, xc, 2)
    with torch.no_grad():
        u = m["den"].cond_embedding(torch.from_numpy(xc))
        got = denoiser_fused.fused_denoiser_core_nm(m["den"], torch.from_numpy(x), 2, u)
    assert got.shape == (N, ROWS, L)
    if dtype is None:
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, atol=5e-5, rtol=1e-4)
    else:
        assert got.dtype == torch.bfloat16
        got = got.float().numpy()
        assert_bf16_close(got, want)


def test_layer_fused_core_matches_single_stage(wide_models, monkeypatch):
    """The port's layer-fused float32 core computes its single-stage core."""
    _, _, models = wide_models
    den = models[None]["den"]
    x, xc = _core_inputs(2)
    with torch.no_grad():
        u = den.cond_embedding(torch.from_numpy(xc))
        prepped = denoiser_fused.prep_fused_denoiser(den)
        monkeypatch.setenv("SKELDIFF_LAYER_FUSED", "0")
        want = denoiser_fused.fused_denoiser_core_nm(den, torch.from_numpy(x), 1, u, prepped)
        monkeypatch.setenv("SKELDIFF_LAYER_FUSED", "1")
        got = denoiser_fused.fused_denoiser_core_nm(den, torch.from_numpy(x), 1, u, prepped)
    assert float((got - want).abs().max()) <= 1e-5


def test_layer_fused_bf16_predictor_matches_jax_chain(wide_models, monkeypatch):
    """The bf16 predictor with SKELDIFF_LAYER_FUSED=1 against the JAX fused
    chain with SKELDIFF_LAYER_FUSED=1 (its runs on the inputs of seed 9 from
    ``tests/goldens/wide_bf16.npz``, ``scripts/wide_bf16_golden.py``), within
    BF16_SPREAD of the JAX chain's own bf16-vs-fp32 deviation."""
    monkeypatch.setenv("SKELDIFF_LAYER_FUSED", "1")
    jsk, sk, models = wide_models
    hold_bf16_predictor(jsk, sk, models, seed=9,
                        runs=golden_predictor_runs(sk, models, "layer_fused_s9"))


# ---- where the plain bf16 modules round ------------------------------------
#
# Criteria, set before the port's modules were changed to meet them: with
# the same bf16 inputs, a port module and the jitted flax module that round
# at the same points differ only where a sum taken in another order lands on
# the other side of a rounding point, which is rare.  So in each output at
# most ROUNDING_SHARE of the elements may differ (by more than 2^-12·|ref|,
# i.e. beyond the float32 noise of the encoder's float32 tail), and the mean
# |Δ| may be at most ROUNDING_MEAN times the flax module's own bf16-vs-fp32
# mean |Δ| on the same inputs.  Measured on the modules as they were before
# (one rounding after every PyTorch op): the encoder's past embedding
# differed in 65% of its elements by 0.49× that mean; the attention
# residuals in 32–40% by 0.62–0.75×; the other modules already matched.
ROUNDING_SHARE = 0.01
ROUNDING_MEAN = 0.05


def _rounding_deviation(got, want, want_f32):
    """(share of elements that differ, mean |Δ| / the reference's own
    bf16-vs-fp32 mean |Δ|)."""
    got, want, want_f32 = (np.asarray(a, dtype=np.float32) for a in (got, want, want_f32))
    diff = np.abs(got - want)
    share = float(np.mean(diff > 2.0 ** -12 * np.abs(want)))
    return share, float(diff.mean() / np.abs(want - want_f32).mean())


def _flax_module(name: str, jsk, compute_dtype):
    """The flax submodule ``name`` of the test Denoiser, standalone."""
    arch = WIDE["arch"]
    common = dict(num_nodes=N, node_types=jsk.nodes_type_id, learn_influence=True,
                  node_major=True, compute_dtype=compute_dtype)
    if name in ("init_lin", "final_glin"):
        return JaxGraphLinear(F, F if name == "init_lin" else L, **common)
    if name == "final_res_block":
        return JaxResnetBlock(2 * F, F, time_emb_dim=4 * F, **common)
    if name.startswith("res"):
        return JaxResnetBlock(F, F, time_emb_dim=4 * F, **common)
    return JaxAttention(F, heads=arch["attn_heads"], dim_head=arch["attn_dim_head"], **common)


def _as_port(a):
    """A JAX bf16 array as a torch bf16 tensor of the same values."""
    return torch.from_numpy(np.asarray(a.astype(jnp.float32))).to(torch.bfloat16)


def test_plain_bf16_modules_round_where_xla_rounds(wide_models):
    """The port's plain bf16 encoder and denoiser modules against the jitted
    flax modules (XLA), on the same inputs: ROUNDING_SHARE, ROUNDING_MEAN."""
    jsk, _, m = wide_models
    bf, f32 = m["bfloat16"], m[None]
    failures, report = [], []

    def hold(what, got, want, want_f32):
        share, mean = _rounding_deviation(got, want, want_f32)
        report.append(f"{what}: {share:.4f} of elements differ, mean |Δ| {mean:.3f}×")
        if not (share <= ROUNDING_SHARE and mean <= ROUNDING_MEAN):
            failures.append(report[-1])

    # one graph-GRU encoder pass (the scanned cell is compiled by XLA)
    obs = 0.3 * np.random.default_rng(7).standard_normal((2, 6, N, 3), dtype=np.float32)
    z = {d: jax.jit(lambda o, mm=mm: mm["jae"].apply(
        mm["ae_params"], o, method=JaxAutoEncoder.get_past_embedding))(jnp.asarray(obs))
         for d, mm in ((None, f32), ("bfloat16", bf))}
    with torch.no_grad():
        got = bf["ae"].get_past_embedding(torch.from_numpy(obs))
    hold("encoder past embedding", got.numpy(), z["bfloat16"], z[None])

    # each module of one jitted flax forward, on the flax bf16 activations
    rng = np.random.default_rng(6)
    x = 0.5 * rng.standard_normal((8, N, L), dtype=np.float32)
    xc = np.tanh(rng.standard_normal((8, N, L), dtype=np.float32))
    jden, params, den = bf["jden"], bf["den_params"], bf["den"]
    u = jden.apply(params, jnp.asarray(xc), method=jden.cond_embedding)
    _, state = jax.jit(lambda a, uc: jden.apply(params, a, jnp.asarray(1, jnp.int32), u_cond=uc,
                                                capture_intermediates=True,
                                                mutable=["intermediates"]))(jnp.asarray(x), u)
    act = {k: v["__call__"][0] for k, v in state["intermediates"].items() if k != "__call__"}
    t = act["time_mlp1"]
    t_port = torch.from_numpy(np.asarray(t))
    u_port = _as_port(u)
    n_pairs = 2 * WIDE["arch"]["depth"]
    names = (["init_lin"] + [f"{k}{i}" for i in range(n_pairs) for k in ("res", "attn")
                             if not (k == "attn" and i == n_pairs - 1)]
             + ["final_res_block", "final_glin"])
    prev = jnp.swapaxes(jnp.asarray(x), 0, 1).astype(jnp.bfloat16)
    for name in names:
        p = {"params": params["params"][name]}
        if name == "init_lin":
            inp = prev
            flax_call = lambda mod, a: mod.apply(p, a, input_offset=L,  # noqa: E731
                                                 partial_in=u.astype(a.dtype))
            port_call = lambda a: den.init_lin(a, input_offset=L, partial_in=u_port)  # noqa
        elif name == "final_res_block":
            inp = jnp.concatenate([prev, act["init_lin"]], axis=-1)
            flax_call = lambda mod, a: mod.apply(p, a, t)  # noqa: E731
            port_call = lambda a: den.final_res_block(a, t_port)  # noqa: E731
        elif name.startswith("res"):
            inp = prev
            flax_call = lambda mod, a: mod.apply(p, a, t)  # noqa: E731
            port_call = lambda a, name=name: getattr(den, name)(a, t_port)  # noqa: E731
        else:
            inp = prev
            flax_call = lambda mod, a: mod.apply(p, a)  # noqa: E731
            port_call = lambda a, name=name: getattr(den, name)(a)  # noqa: E731
        want = jax.jit(lambda a: flax_call(_flax_module(name, jsk, "bfloat16"), a))(inp)
        want_f32 = jax.jit(lambda a: flax_call(_flax_module(name, jsk, None), a))(
            inp.astype(jnp.float32))
        with torch.no_grad():
            got = port_call(_as_port(inp))
        assert got.dtype == torch.bfloat16, name
        hold(f"denoiser {name}", got.float().numpy(), want.astype(jnp.float32), want_f32)
        prev = act[name]
    print("\n".join(report))
    assert not failures, failures
