"""The fused denoiser's kernels (B1–B5 and K2's bf16-x̂₀ entry): their plain
PyTorch versions against the JAX package's Pallas kernels, run with
``interpret=True`` on the CPU as the repo's own Pallas tests run them, and
the wrappers' refusal to fall back when a CUDA launch is asked for (those of
the layer-fused kernels B9a–c, the feature-major attention core L1 and the
merged-gate bf16 rollout B8 too; their plain versions are held in
``tests/test_torch_layer_fused.py`` and ``tests/test_torch_decode_bf16.py``).

Shapes are the flagship's widths (21 nodes, D 96, F 192, 8 heads × 32) at a
batch of 16.  The Pallas kernels need their feature axes padded to 128-lane
multiples; the inputs are zero-padded for them and their outputs sliced.

Tolerances: float32 at the JAX tests' own atol 2e-5, rtol 1e-4 (sums in
another order); bfloat16 compared in float32, max |Δ| ≤ 3e-2·max|ref| and
mean |Δ| ≤ 2e-3·max|ref| (8 significant bits, and each kernel rounds 2–4
times, so a sum-order difference can flip a rounding)."""
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from skeletondiffusion_tpu.ops.pallas import resnet_block as pallas_resnet
from skeletondiffusion_tpu.ops.pallas.attention_proj import outproj_res_pallas, rms_qkv_pallas
from skeletondiffusion_tpu.ops.pallas.graph_linear_fused import graph_linear_pallas
from skeletondiffusion_tpu.ops.pallas.joint_attention import attention_core_pallas
from skeletondiffusion_tpu.ops.pallas.posterior_step import posterior_step_pallas
from skeletondiffusion_tpu_torch.ops.kernels import attention_core_fm, attention_proj, build
from skeletondiffusion_tpu_torch.ops.kernels import graph_linear_fused, gru_rollout
from skeletondiffusion_tpu_torch.ops.kernels import joint_attention, layer_fused, posterior_step
from skeletondiffusion_tpu_torch.ops.kernels import resnet_block

from torch_parity import KernelInputs, check_kernel, pad_to

N, B, D, F, HEADS, DH = 21, 16, 96, 192, 8, 32
HD = HEADS * DH
FP = 256  # the Pallas kernels' padded feature width
both = pytest.mark.parametrize("dtype", ["float32", "bfloat16"])


@both
def test_graph_linear_fused_plain_matches_pallas(dtype):
    inp = KernelInputs(dtype, 0)
    (x, jx), (w, jw), (b, jb), (g, jg), (u, ju) = (
        inp.act(N, B, D), inp.bank(D, F), inp.bias(F), inp.influence(), inp.act(N, B, F))
    got = graph_linear_fused.graph_linear_fused(x, w, b, g, u)
    want = graph_linear_pallas(pad_to(jx, 128), pad_to(jw, 128, FP), pad_to(jb, FP), jg,
                               u=pad_to(ju, FP), batch_tile=8, interpret=True)[:, :, :F]
    assert got.dtype == x.dtype and got.shape == (N, B, F)
    check_kernel(got, want, dtype)


@both
def test_resnet_block_plain_matches_pallas(dtype):
    inp = KernelInputs(dtype, 1)
    (x, jx), (film, jfilm) = inp.act(N, B, F), inp.film(F)
    (w1, jw1), (b1, jb1), (g1, jg1) = inp.bank(F, F), inp.bias(F), inp.influence()
    (w2, jw2), (b2, jb2), (g2, jg2) = inp.bank(F, F), inp.bias(F), inp.influence()
    got = resnet_block.resnet_block(x, film, w1, b1, g1, w2, b2, g2)
    want = pallas_resnet.resnet_block_pallas(jx, jfilm[None], jw1, jb1, jg1, jw2, jb2, jg2,
                                             f_pad=FP, batch_tile=8, interpret=True)
    check_kernel(got, want, dtype)


def _rect_weights(w):
    """[N, 2F, F] → the Pallas layout [N, 2·Fp, Fp]: the x and r halves of
    the rows each padded to Fp (`denoiser_fused.py::_rect_w`)."""
    return pad_to(jnp.concatenate([pad_to(w[:, :F].swapaxes(1, 2), FP).swapaxes(1, 2),
                                   pad_to(w[:, F:].swapaxes(1, 2), FP).swapaxes(1, 2)], 1), FP)


def _pallas_final_in(x, r, film, w1, b1, g1, wr, gr):
    """The first pallas_call of ``final_block_head_pallas_padded``
    (``_rect_in_kernel``) on padded inputs."""
    dt = x.dtype
    tile = lambda f: pl.BlockSpec((N, 8, f), lambda i: (0, i, 0))  # noqa: E731
    const = lambda s: pl.BlockSpec(s, lambda i: (0,) * len(s))  # noqa: E731
    h, res = pl.pallas_call(
        functools.partial(pallas_resnet._rect_in_kernel, num_nodes=N, f_pad=FP, batch_tile=8),
        grid=(B // 8,),
        in_specs=[tile(FP), tile(FP), const((1, 2 * FP)), const((N, 2 * FP, FP)),
                  const((N, FP)), const((N, N)), const((N, 2 * FP, FP)), const((N, N))],
        out_specs=(tile(FP), tile(FP)),
        out_shape=(jax.ShapeDtypeStruct((N, B, FP), dt), jax.ShapeDtypeStruct((N, B, FP), dt)),
        scratch_shapes=[pltpu.VMEM((N, 8, FP), dt)],
        interpret=True,
    )(pad_to(x, FP), pad_to(r, FP), pallas_resnet.pad_film(film[None], F, FP).astype(dt),
      _rect_weights(w1), pad_to(b1, FP), g1, _rect_weights(wr), gr)
    return h[:, :, :F], res[:, :, :F]


def _pallas_final_out(h, res, w2, b2, g2, wh, bh, gh):
    """The second pallas_call of ``final_block_head_pallas_padded``
    (``_rect_out_head_kernel``) on padded inputs."""
    dt = h.dtype
    tile = lambda f: pl.BlockSpec((N, 8, f), lambda i: (0, i, 0))  # noqa: E731
    const = lambda s: pl.BlockSpec(s, lambda i: (0,) * len(s))  # noqa: E731
    out = pl.pallas_call(
        functools.partial(pallas_resnet._rect_out_head_kernel, num_nodes=N, f_pad=FP,
                          h_out=128, batch_tile=8),
        grid=(B // 8,),
        in_specs=[tile(FP), tile(FP), const((N, FP, FP)), const((N, FP)), const((N, N)),
                  const((N, FP, 128)), const((N, 128)), const((N, N))],
        out_specs=tile(128),
        out_shape=jax.ShapeDtypeStruct((N, B, 128), dt),
        scratch_shapes=[pltpu.VMEM((N, 8, FP), dt), pltpu.VMEM((N, 8, 128), dt)],
        interpret=True,
    )(pad_to(h, FP), pad_to(res, FP), pad_to(w2, FP, FP), pad_to(b2, FP), g2,
      pad_to(wh, FP, 128), pad_to(bh, 128), gh)
    return out[:, :, :D]


def _final_inputs(dtype):
    inp = KernelInputs(dtype, 2)
    names = ["x", "r", "film", "w1", "b1", "g1", "wr", "gr", "w2", "b2", "g2", "wh", "bh", "gh"]
    made = [inp.act(N, B, F), inp.act(N, B, F), inp.film(F), inp.bank(2 * F, F), inp.bias(F),
            inp.influence(), inp.bank(2 * F, F), inp.influence(), inp.bank(F, F), inp.bias(F),
            inp.influence(), inp.bank(F, D), inp.bias(D), inp.influence()]
    return ({k: t for k, (t, _) in zip(names, made)}, {k: j for k, (_, j) in zip(names, made)})


@both
def test_final_block_passes_plain_match_pallas(dtype):
    t, j = _final_inputs(dtype)
    in_keys = ["x", "r", "film", "w1", "b1", "g1", "wr", "gr"]
    h, res = resnet_block.final_block_in(*(t[k] for k in in_keys))
    jh, jres = _pallas_final_in(*(j[k] for k in in_keys))
    check_kernel(h, jh, dtype, "h")
    check_kernel(res, jres, dtype, "res")
    # the second pass on the same (Pallas) h and res, so each pass is held alone
    out_keys = ["w2", "b2", "g2", "wh", "bh", "gh"]
    as_torch = lambda a: torch.from_numpy(np.array(a.astype(jnp.float32))).to(h.dtype)  # noqa
    out = resnet_block.final_block_out(as_torch(jh), as_torch(jres), *(t[k] for k in out_keys))
    check_kernel(out, _pallas_final_out(jh, jres, *(j[k] for k in out_keys)), dtype, "out")


@both
def test_final_block_chain_matches_pallas_function(dtype):
    """Both passes together against the public ``final_block_head_pallas_padded``."""
    t, j = _final_inputs(dtype)
    h, res = resnet_block.final_block_in(*(t[k] for k in ["x", "r", "film", "w1", "b1", "g1",
                                                          "wr", "gr"]))
    got = resnet_block.final_block_out(h, res, *(t[k] for k in ["w2", "b2", "g2", "wh", "bh",
                                                                "gh"]))
    dt = j["x"].dtype
    want = pallas_resnet.final_block_head_pallas_padded(
        pad_to(j["x"], FP), pad_to(j["r"], FP),
        pallas_resnet.pad_film(j["film"][None], F, FP).astype(dt), _rect_weights(j["w1"]),
        pad_to(j["b1"], FP), j["g1"], _rect_weights(j["wr"]), j["gr"],
        pad_to(j["w2"], FP, FP), pad_to(j["b2"], FP), j["g2"], pad_to(j["wh"], FP, 128),
        pad_to(j["bh"], 128), j["gh"], batch_tile_in=8, batch_tile_out=8, interpret=True,
    )[:, :, :D]
    check_kernel(got, want, dtype)


@both
def test_rms_qkv_plain_matches_pallas(dtype):
    inp = KernelInputs(dtype, 3)
    (x, jx), (w, jw), (g, jg) = inp.act(N, B, F), inp.bank(F, 3 * HD), inp.influence()
    g_rms, jg_rms = inp._make((1.0 + 0.1 * inp.rng.standard_normal(F)) * np.sqrt(F))
    got = attention_proj.rms_qkv(x, g_rms, w, g)
    want = rms_qkv_pallas(pad_to(jx, FP), pad_to(jg_rms[None], FP), pad_to(jw.swapaxes(1, 2),
                          FP).swapaxes(1, 2), jg, batch_tile=8, interpret=True)
    check_kernel(got, want, dtype)


@both
def test_outproj_res_plain_matches_pallas(dtype):
    inp = KernelInputs(dtype, 4)
    (a, ja), (x, jx), (w, jw), (g, jg) = (inp.act(N, B, HD), inp.act(N, B, F), inp.bank(HD, F),
                                          inp.influence())
    got = attention_proj.outproj_res(a, x, w, g)
    want = outproj_res_pallas(ja, pad_to(jx, FP), pad_to(jw, FP), jg, batch_tile=8,
                              interpret=True)[:, :, :F]
    check_kernel(got, want, dtype)


@both
def test_attention_core_plain_matches_pallas(dtype):
    """In bf16 the Pallas kernel also rounds k·(q·scale) and p·v products to
    bf16 before summing; the port sums in fp32 (inside the bf16 criteria)."""
    qkv, jqkv = KernelInputs(dtype, 5).act(N, B, 3 * HD, scale=1.5)
    got = joint_attention.attention_core(qkv, heads=HEADS, dim_head=DH)
    want = attention_core_pallas(jqkv, heads=HEADS, dim_head=DH, batch_tile=8, interpret=True)
    assert got.shape == (N, B, HD)
    check_kernel(got, want, dtype)


def test_posterior_step_bf16_x0_plain_matches_pallas():
    """K2 with x̂₀ in bf16 (the fused denoiser's output): x_t, the noise and
    the result stay float32, so the tolerance is float32's."""
    inp = KernelInputs("bfloat16", 6)
    x0, jx0 = inp.act(N, B, D, scale=1.5)
    rng = np.random.default_rng(7)
    xt, eps = (rng.standard_normal((N, B, D), dtype=np.float32) for _ in range(2))
    m = 0.3 * rng.standard_normal((N, 3 * N), dtype=np.float32)
    got = posterior_step.posterior_step(x0, torch.from_numpy(xt), torch.from_numpy(eps),
                                        torch.from_numpy(m))
    assert got.dtype == torch.float32
    want = posterior_step_pallas(pad_to(jx0, 128), pad_to(jnp.asarray(xt), 128),
                                 pad_to(jnp.asarray(eps), 128), jnp.asarray(m), batch_tile=8,
                                 interpret=True)[:, :, :D]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


# ---- the wrappers on a CUDA request ---------------------------------------

def _cuda_request(monkeypatch):
    """Make the wrappers take their CUDA branch for CPU tensors, as on a
    machine whose tensors live on a GPU, with no GPU to build for."""
    monkeypatch.setattr(build, "kernel_device", lambda **tensors: "cuda")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    build.c_entry.cache_clear()


def _wrapper_calls(dtype=torch.bfloat16):
    """(name, counter module, counter attribute, call) of every new wrapper at
    small flagship-width shapes."""
    z = lambda *s: torch.zeros(*s, dtype=dtype)  # noqa: E731
    bf = lambda *s: torch.zeros(*s, dtype=torch.bfloat16)  # noqa: E731
    f32 = lambda *s: torch.zeros(*s)  # noqa: E731
    bf16 = dtype == torch.bfloat16
    rb = bf if bf16 else f32
    x, g = z(N, 4, F), z(N, N)
    block = lambda: (z(N, F, F), z(N, F), g, z(N, F, F), z(N, F), g)  # noqa: E731
    return [
        ("graph_linear_fused", graph_linear_fused, "launches",
         lambda: graph_linear_fused.graph_linear_fused(z(N, 4, D), z(N, D, F), z(N, F), g,
                                                       z(N, 4, F))),
        ("resnet_block", resnet_block, "launches_block",
         lambda: resnet_block.resnet_block(x, z(2 * F), z(N, F, F), z(N, F), g, z(N, F, F),
                                           z(N, F), g)),
        ("final_block_in", resnet_block, "launches_final_in",
         lambda: resnet_block.final_block_in(x, x, z(2 * F), z(N, 2 * F, F), z(N, F), g,
                                             z(N, 2 * F, F), g)),
        ("final_block_out", resnet_block, "launches_final_out",
         lambda: resnet_block.final_block_out(x, x, z(N, F, F), z(N, F), g, z(N, F, D), z(N, D),
                                              g)),
        ("rms_qkv", attention_proj, "launches_rms_qkv",
         lambda: attention_proj.rms_qkv(x, z(F), z(N, F, 3 * HD), g)),
        ("outproj_res", attention_proj, "launches_outproj_res",
         lambda: attention_proj.outproj_res(z(N, 4, HD), x, z(N, HD, F), g)),
        ("attention_core", joint_attention, "launches",
         lambda: joint_attention.attention_core(z(N, 4, 3 * HD), heads=HEADS, dim_head=DH)),
        ("posterior_step", posterior_step, "launches_x0_bf16" if bf16 else "launches",
         lambda: posterior_step.posterior_step(z(N, 4, D), torch.zeros(N, 4, D),
                                               torch.zeros(N, 4, D), torch.zeros(N, 3 * N))),
        ("stem_block", layer_fused, "launches_stem_block",
         lambda: layer_fused.stem_block(z(N, 4, D), x, z(2 * F), z(N, D, F), z(N, F), g,
                                        *block())),
        ("rms_qkv_core", layer_fused, "launches_rms_qkv_core",
         lambda: layer_fused.rms_qkv_core(x, z(F), z(N, F, 3 * HD), g, heads=HEADS,
                                          dim_head=DH)),
        ("outproj_block", layer_fused, "launches_outproj_block",
         lambda: layer_fused.outproj_block(z(N, 4, HD), x, z(2 * F), z(N, HD, F), g, *block())),
        ("attention_core_fm", attention_core_fm, "launches",
         lambda: attention_core_fm.attention_core_fm(z(N, 3 * HD, 4), heads=HEADS, dim_head=DH)),
        # the rollout: in bf16 the merged-gate one (cx and the banks bf16, the
        # rest fp32), in fp32 the fp32 one
        ("gru_rollout", gru_rollout, "launches_bf16" if bf16 else "launches",
         lambda: gru_rollout.gru_rollout(
             rb(N, 4, 3 * D), f32(N, 4, D), rb(N, D, 3 * D), f32(N, 3 * D), f32(N, N), f32(N, N),
             rb(N, D, 3), f32(N, 3), f32(N, N), ph=3,
             compute_dtype=torch.bfloat16 if bf16 else None)),
    ]


@pytest.mark.parametrize("index", range(13))
def test_new_wrappers_raise_instead_of_falling_back(monkeypatch, index):
    name, module, counter, call = _wrapper_calls()[index]
    _cuda_request(monkeypatch)
    before = getattr(module, counter)
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        call()
    # a C entry that refuses the shapes (cudaErrorInvalidValue) raises too
    monkeypatch.setattr(build, "c_entry", lambda *a: (lambda *args: 1))
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(cuda_stream=0))
    with pytest.raises(RuntimeError, match="cudaError 1"):
        call()
    assert getattr(module, counter) == before, name


def test_new_wrappers_check_dtype_and_layout(monkeypatch):
    _cuda_request(monkeypatch)
    with pytest.raises(TypeError, match="built for bfloat16 and float32"):
        _wrapper_calls(torch.float64)[1][3]()
    x = torch.zeros(N, 4, F, dtype=torch.bfloat16)
    g = torch.zeros(N, N, dtype=torch.bfloat16)
    with pytest.raises(TypeError, match="w1 must be bfloat16, got torch.float32"):
        resnet_block.resnet_block(x, x[0, 0].repeat(2), torch.zeros(N, F, F), x[:, 0], g,
                                  torch.zeros(N, F, F, dtype=torch.bfloat16), x[:, 0], g)
    with pytest.raises(ValueError, match="contiguous"):
        attention_proj.rms_qkv(x.transpose(0, 1).contiguous().transpose(0, 1), x[0, 0],
                               torch.zeros(N, F, 3 * HD, dtype=torch.bfloat16), g)
    # the layer-fused kernels' wrappers
    with pytest.raises(TypeError, match="built for bfloat16 and float32"):
        _wrapper_calls(torch.float64)[10][3]()
    bank, bias = torch.zeros(N, F, F, dtype=torch.bfloat16), x[:, 0]
    with pytest.raises(TypeError, match="u must be bfloat16, got torch.float32"):
        layer_fused.stem_block(torch.zeros(N, 4, D, dtype=torch.bfloat16), x.float(),
                               x[0, 0].repeat(2), torch.zeros(N, D, F, dtype=torch.bfloat16), bias,
                               g, bank, bias, g, bank, bias, g)
    with pytest.raises(ValueError, match="contiguous"):
        layer_fused.rms_qkv_core(x.transpose(0, 1).contiguous().transpose(0, 1), x[0, 0],
                                 torch.zeros(N, F, 3 * HD, dtype=torch.bfloat16), g, heads=HEADS,
                                 dim_head=DH)
    with pytest.raises(ValueError, match="w_out has shape"):
        layer_fused.outproj_block(torch.zeros(N, 4, HD, dtype=torch.bfloat16), x,
                                  x[0, 0].repeat(2), bank, g, bank, bias, g, bank, bias, g)


def _c_signature(source: str, symbol: str):
    """(pointer parameters, int parameters) of ``extern "C" int symbol(...)``."""
    head = f'extern "C" int {symbol}('
    assert head in source, symbol
    params = source[source.index(head) + len(head):].split(")", 1)[0].split(",")
    pointers = sum("*" in p for p in params)
    return pointers, sum(p.split()[0] == "int" for p in params if "*" not in p)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_wrappers_call_c_entries_that_exist(monkeypatch, dtype):
    """Each wrapper names a C entry of its source with the pointer and int
    parameters it passes (the sources are compiled only on the card)."""
    import pathlib

    csrc = pathlib.Path(build.__file__).resolve().parents[2] / "csrc"
    calls = []

    def recording(name, symbol, n_pointers, n_ints, nodes=21):
        assert nodes == N, symbol  # the library built at the tensors' node count
        calls.append((name, symbol, n_pointers, n_ints))
        return lambda *args: 0

    monkeypatch.setattr(build, "kernel_device", lambda **tensors: "cuda")
    monkeypatch.setattr(build, "c_entry", recording)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(cuda_stream=0))
    for name, module, counter, call in _wrapper_calls(dtype):
        monkeypatch.setattr(module, counter, 0)
        call()
        assert getattr(module, counter) == 1, name
    assert len(calls) == 13
    for name, symbol, n_pointers, n_ints in calls:
        pointers, ints = _c_signature((csrc / f"{name}.cu").read_text(), symbol)
        assert (pointers, ints) == (n_pointers + 1, n_ints), symbol  # + the stream
