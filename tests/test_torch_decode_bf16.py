"""The bf16 decode check's slice of the port: the merged-gate bf16 rollout
(B8) and the feature-major attention core of the attention lab (L1).

* B8's plain version against ``gru_rollout_pallas(compute_dtype='bfloat16')``
  and the port's ``decode_rollout`` against the JAX one (bf16 and fp32), the
  Pallas kernels run with ``interpret=True`` on the CPU as the repo's own
  Pallas tests run them;
* L1's plain version against ``scripts/attn_core_lab.py::core_fm`` in
  interpret mode, and against the port's batch-major attention core (B2);
* the two entry points (``scripts/torch_decode_bf16_check.py``,
  ``scripts/torch_attn_core_lab.py``) on the CPU at a small size;
* the new wrappers' dtype, shape and layout checks and their refusal to fall
  back when a CUDA launch is asked for (their C entries are checked with the
  other wrappers' in ``test_torch_denoiser_kernels.py``).

Tolerances, set before the first comparison: float32 at 1e-5 for the decode
(as ``test_torch_kernels.py``) and at the lab's own atol 2e-5 for L1; bf16
compared in float32 at max |Δ| ≤ 3e-2·max|ref| and mean |Δ| ≤ 2e-3·max|ref|
(``assert_bf16_close``) and, for the rollout and the decode, a mean |Δ| of at
most 0.1× the Pallas merged kernel's own mean deviation from the fp32 Pallas
kernel on the same inputs.  Probed one rounding point at a time, the plain
versions round where the Pallas kernels round in interpret mode (B8: cx, hw3,
bf16(G_t), r and z, bf16(h) into both products; L1: q·scale, each k·q
product, the probabilities and the node sum once, not the v·a products).
"""
import json
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skeletondiffusion_tpu.ops.pallas.gru_rollout import decode_rollout as jax_decode_rollout
from skeletondiffusion_tpu.ops.pallas.gru_rollout import gru_rollout_pallas
from skeletondiffusion_tpu.models import AutoEncoder as JaxAutoEncoder
from skeletondiffusion_tpu.skeleton import create_skeleton as jax_create_skeleton
from skeletondiffusion_tpu_torch.models import AutoEncoder
from skeletondiffusion_tpu_torch.ops.graph_linear import gmix_nm, l1_normalize_rows
from skeletondiffusion_tpu_torch.ops.kernels import attention_core_fm as fm_mod
from skeletondiffusion_tpu_torch.ops.kernels import build
from skeletondiffusion_tpu_torch.ops.kernels import gru_rollout as rollout_mod
from skeletondiffusion_tpu_torch.ops.kernels.joint_attention import attention_core_plain
from skeletondiffusion_tpu_torch.skeleton import create_skeleton
from skeletondiffusion_tpu_torch.weights import load_autoencoder_params

from test_torch_kernels import _rollout_inputs
from torch_parity import (LATENT, PRED_LEN, as_jax, assert_bf16_close, jax_models, port_models,
                          skeletons)
from torch_parity import load_script as _script

N = 21
# the merged kernel's mean deviation from the plain version may reach this
# share of the Pallas merged kernel's own deviation from its fp32 kernel
MEAN_SHARE = 0.1


def _hold_merged(got, want, want_f32, what: str):
    """The bf16 criteria, and the mean within MEAN_SHARE of the Pallas merged
    kernel's own mean deviation from the fp32 kernel."""
    got, want, want_f32 = (np.asarray(a, np.float32) for a in (got, want, want_f32))
    assert_bf16_close(got, want, what)
    own = np.abs(want - want_f32).mean()
    assert own > 0, what
    print(f"{what}: max |Δ| {np.abs(got - want).max():.3e}, mean {np.abs(got - want).mean():.3e}"
          f" against the Pallas merged kernel's own mean deviation {own:.3e} from fp32")
    assert np.abs(got - want).mean() <= MEAN_SHARE * own, (what, np.abs(got - want).mean(), own)


# ---- B8: the merged-gate bf16 rollout ---------------------------------------

@pytest.mark.parametrize("with_types", [True, False])
def test_gru_rollout_merged_plain_matches_pallas(with_types):
    _, sk = skeletons()
    inp = _rollout_inputs(np.random.default_rng(11), sk.nodes_type_id if with_types else None)
    jin = {k: jnp.asarray(v) for k, v in inp.items()}
    want = gru_rollout_pallas(**jin, ph=PRED_LEN, batch_tile=8, compute_dtype="bfloat16",
                              interpret=True)
    want_f32 = gru_rollout_pallas(**jin, ph=PRED_LEN, batch_tile=8, interpret=True)
    tin = {k: torch.from_numpy(v) for k, v in inp.items()}
    got = rollout_mod.gru_rollout(**tin, ph=PRED_LEN, compute_dtype=torch.bfloat16)
    assert got.shape == want.shape == (PRED_LEN, N, 8, 3) and got.dtype == torch.float32
    _hold_merged(got.numpy(), want, want_f32, "rollout")
    # the kernel's dtypes (cx and the banks in bf16) give the same function
    cast = {k: v.to(torch.bfloat16) if k in ("cx", "w_hh", "w_fc") else v for k, v in tin.items()}
    np.testing.assert_array_equal(
        rollout_mod.gru_rollout(**cast, ph=PRED_LEN, compute_dtype=torch.bfloat16).numpy(),
        got.numpy())


def _merged_variant(cx, h0, w_hh, b_hh, g0, g_add, w_fc, b_fc, g_fc, *, ph, drop):
    """``gru_rollout_merged_plain`` with the rounding point ``drop`` left out."""
    from skeletondiffusion_tpu_torch.ops.graph_linear import gmix_nm, gmm_nm, l1_normalize_rows

    rnd = {k: (lambda t: t) if k == drop else rollout_mod._bf16
           for k in ("g", "hw3", "h", "rz", "h_fc")}
    cx, w_hh, w_fc = (rollout_mod._bf16(t) for t in (cx, w_hh, w_fc))
    hid, h, g, ys = h0.shape[-1], h0, g0, []
    for _ in range(ph):
        gc = rnd["g"](g)
        hw3 = rnd["hw3"](gmm_nm(rnd["h"](h), w_hh) + b_hh[:, None, :])
        xg, hg = gmix_nm(gc, cx), gmix_nm(gc, hw3)
        rz = rnd["rz"](torch.sigmoid(xg[..., :2 * hid] + hg[..., :2 * hid]))
        r, z = rz[..., :hid], rz[..., hid:]
        n = torch.tanh(xg[..., 2 * hid:] + r * hg[..., 2 * hid:])
        h = n - n * z + z * h
        ys.append(torch.tanh(gmix_nm(g_fc, gmm_nm(rnd["h_fc"](h), w_fc) + b_fc[:, None, :])))
        g = l1_normalize_rows(g + g_add)
    return torch.stack(ys)


@pytest.fixture(scope="module")
def merged_reference():
    _, sk = skeletons()
    inp = _rollout_inputs(np.random.default_rng(11), sk.nodes_type_id)
    jin = {k: jnp.asarray(v) for k, v in inp.items()}
    want = np.asarray(gru_rollout_pallas(**jin, ph=PRED_LEN, batch_tile=8,
                                         compute_dtype="bfloat16", interpret=True))
    own = np.abs(want - np.asarray(gru_rollout_pallas(**jin, ph=PRED_LEN, batch_tile=8,
                                                      interpret=True))).mean()
    return {k: torch.from_numpy(v) for k, v in inp.items()}, want, own


@pytest.mark.parametrize("drop", ["g", "hw3", "h", "rz", "h_fc"])
def test_each_rounding_point_of_the_merged_rollout_is_needed(merged_reference, drop):
    """Without any one of the plain version's rounding points (bf16(G_t),
    hw3, bf16(h) into the product, r and z, bf16(h') into the head), its
    mean deviation from the Pallas merged kernel exceeds the criterion."""
    tin, want, own = merged_reference
    got = _merged_variant(**tin, ph=PRED_LEN, drop=drop).numpy()
    share = np.abs(got - want).mean() / own
    print(f"without the {drop} rounding: mean |Δ| {share:.3f}× the Pallas merged kernel's "
          f"own deviation from fp32")
    assert share > MEAN_SHARE, drop


def _chunked_mix(g, x, chunk=16):
    """G·x over the input nodes, [n_out, m]·[m, B, F] → [n_out, B, F], summed
    in fp32 a tensor-core k-step (``chunk`` input rows) at a time."""
    n, b, f = x.shape
    acc = torch.zeros(g.shape[0], b * f)
    for k0 in range(0, n, chunk):
        acc = acc + g[:, k0:k0 + chunk] @ x[k0:k0 + chunk].reshape(-1, b * f)
    return acc.reshape(g.shape[0], b, f)


def _rollout_as_b8_sums(cx, h0, w_hh, b_hh, g0, g_add, w_fc, b_fc, g_fc, *, ph):
    """The merged rollout with B8's order of sums (``csrc/gru_rollout_merged.cu``)
    and the plain version's rounding points: hw3 from the bias plus one k-step
    of 16 bank rows at a time; r and z mixed once as [gc | gc]·[cx ; hw3] over
    2N input rows, k-steps of 16 (the third ends in zero rows); n's two parts
    mixed apart (a k16 step, then the k8 step over nodes 16–20); the head's
    product by k-steps, then its bias; sums fp32 throughout."""
    bf = rollout_mod._bf16
    cx, w_hh, w_fc = bf(cx), bf(w_hh), bf(w_fc)
    hid = h0.shape[-1]
    h, g, ys = h0.float(), g0.float(), []
    for _ in range(ph):
        gc, hb = bf(g), bf(h)
        p = b_hh[:, None, :].expand(-1, h.shape[1], -1)
        for k0 in range(0, hid, 16):
            p = p + torch.bmm(hb[..., k0:k0 + 16], w_hh[:, k0:k0 + 16])
        hw3 = bf(p)
        g2 = torch.cat([gc, gc], dim=1)
        rz = bf(torch.sigmoid(_chunked_mix(g2, torch.cat([cx[..., :2 * hid],
                                                           hw3[..., :2 * hid]]))))
        r, z = rz[..., :hid], rz[..., hid:]
        n = torch.tanh(_chunked_mix(gc, cx[..., 2 * hid:])
                       + r * _chunked_mix(gc, hw3[..., 2 * hid:]))
        h = n - n * z + z * h
        hb = bf(h)
        q = torch.zeros(h.shape[0], h.shape[1], w_fc.shape[-1])
        for k0 in range(0, hid, 16):
            q = q + torch.bmm(hb[..., k0:k0 + 16], w_fc[:, k0:k0 + 16])
        ys.append(torch.tanh(gmix_nm(g_fc, q + b_fc[:, None, :])))
        g = l1_normalize_rows(g + g_add)
    return torch.stack(ys)


def test_b8_order_of_sums_meets_the_bound_against_pallas(merged_reference):
    """A PyTorch model of B8's order of sums (tensor-core k-steps, r and z over
    [gc | gc]·[cx ; hw3], bias first) meets the bf16 criteria against the
    Pallas merged kernel in interpret mode, its mean deviation within
    MEAN_SHARE of the Pallas kernel's own from fp32, as the plain version's."""
    tin, want, own = merged_reference
    got = _rollout_as_b8_sums(**tin, ph=PRED_LEN)
    plain = rollout_mod.gru_rollout_merged_plain(**tin, ph=PRED_LEN)
    assert got.shape == want.shape
    assert_bf16_close(got.numpy(), want, "B8's order of sums")
    share = np.abs(got.numpy() - want).mean() / own
    print(f"B8's order of sums: mean |Δ| {share:.4f}× the Pallas merged kernel's own deviation "
          f"from fp32; the plain version {np.abs(plain.numpy() - want).mean() / own:.4f}×")
    assert share <= MEAN_SHARE


@pytest.fixture(scope="module")
def decoder_pair():
    jsk, sk = skeletons()
    _, ae_params, _, _, den_params = jax_models(jsk, seed=5)
    ae, _, _ = port_models(sk, ae_params, den_params)
    rng = np.random.default_rng(6)
    x_last2 = 0.2 * rng.standard_normal((8, 2, N, 3), dtype=np.float32)
    z = rng.standard_normal((8, N, LATENT), dtype=np.float32)
    dec = as_jax(ae_params)["params"]["decoder"]
    want = {dt: np.asarray(jax_decode_rollout(dec, jsk.nodes_type_id, jnp.asarray(x_last2),
                                              jnp.asarray(z), PRED_LEN, batch_tile=8,
                                              compute_dtype=dt, interpret=True))
            for dt in (None, "bfloat16")}
    return ae.decoder, torch.from_numpy(x_last2), torch.from_numpy(z), want


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_rollout_matches_jax(decoder_pair, dtype):
    decoder, x_last2, z, want = decoder_pair
    compute = {"float32": None, "bfloat16": torch.bfloat16}[dtype]
    with torch.no_grad():
        got = rollout_mod.decode_rollout(decoder, x_last2, z, PRED_LEN, compute_dtype=compute)
    assert got.shape == (8, PRED_LEN, N, 3) and got.dtype == torch.float32
    if compute is None:
        np.testing.assert_allclose(got.numpy(), want[None], rtol=0, atol=1e-5)
        # Decoder.forward is this decode
        with torch.no_grad():
            np.testing.assert_array_equal(decoder(x_last2, z, PRED_LEN).numpy(), got.numpy())
    else:
        _hold_merged(got.numpy(), want["bfloat16"], want[None], "decode")


# ---- the decode check's mean on the JAX check's own model ------------------

# rows of the JAX decode check's inputs taken (of its 12 800), all 120 steps
CHECK_ROWS = 48
# the port's plain decode and the JAX decode (Pallas in interpret mode) give
# the same bf16-vs-fp32 metric-space mean on the same model and rows within
# this share of the JAX mean: they round alike, and their fp32 decodes agree
# to 1e-5 (test_decode_rollout_matches_jax)
CHECK_MEAN_SHARE = 0.03


def test_decode_check_mean_equals_the_jax_decodes_on_its_model():
    """``scripts/decode_bf16_check.py``'s model (the flax AutoEncoder at hidden
    and latent 96 from key 0) carried through the weight bridge, and its
    inputs (keys 1 and 2), first CHECK_ROWS rows × 120 steps: the port's plain
    bf16 decode deviates from its fp32 decode by the same metric-space mean
    as the JAX package's decodes on the CPU (~0.93 mm, not the TPU-era 0.55
    mm of that script's docstring, whose "fp32" reference ran single-pass bf16
    dots)."""
    import jax

    kw = dict(dataset_name="amass", motion_repr_type="SkeletonRescalePose", num_joints=22,
              pose_box_size=1.5, obs_length=30, pred_length=120, if_consider_hip=False)
    jsk, sk = jax_create_skeleton(**kw), create_skeleton(**kw)
    n, ph, lat = jsk.num_nodes, 120, 96
    jae = JaxAutoEncoder(num_nodes=n, encoder_hidden_size=96, decoder_hidden_size=96,
                         latent_size=lat, node_types=jsk.nodes_type_id)
    params = jae.init(jax.random.key(0), jnp.zeros((1, ph, n, 3)), jnp.zeros((1, 30, n, 3)),
                      ph=ph, method=JaxAutoEncoder.autoencode)
    x_last2 = np.array(jax.random.normal(jax.random.key(1), (12800, 2, n, 3)) * 0.2)[:CHECK_ROWS]
    z = np.array(jax.random.normal(jax.random.key(2), (12800, n, lat)))[:CHECK_ROWS]
    dec = params["params"]["decoder"]
    jax_out = {dt: jax_decode_rollout(dec, jsk.nodes_type_id, jnp.asarray(x_last2),
                                      jnp.asarray(z), ph, batch_tile=8, compute_dtype=dt,
                                      interpret=True)
               for dt in (None, "bfloat16")}
    jm = {dt: np.asarray(jsk.transform_to_metric_space(o)) for dt, o in jax_out.items()}
    jax_mean = (np.linalg.norm(jm[None] - jm["bfloat16"], axis=-1) * 1000.0).mean()

    ae = AutoEncoder(n, 96, 96, lat, torch.Generator().manual_seed(0),
                     node_types=sk.nodes_type_id)
    load_autoencoder_params(ae, jax.device_get(params))
    with torch.no_grad():
        port_out = {dt: rollout_mod.decode_rollout(ae.decoder, torch.from_numpy(x_last2),
                                                   torch.from_numpy(z), ph, compute_dtype=dt)
                    for dt in (None, torch.bfloat16)}
    pm = {dt: sk.transform_to_metric_space(o) for dt, o in port_out.items()}
    port_mean = (torch.linalg.vector_norm(pm[None] - pm[torch.bfloat16], dim=-1)
                 * 1000.0).mean().item()
    print(f"decode check at {CHECK_ROWS} rows × {ph} steps: bf16-vs-fp32 mean {jax_mean:.4f} mm "
          f"(JAX, interpret mode), {port_mean:.4f} mm (port, plain)")
    assert abs(port_mean - jax_mean) <= CHECK_MEAN_SHARE * jax_mean
    assert jax_mean > 0.8  # the CPU's JAX decodes are nowhere near the TPU's 0.55 mm


# ---- L1: the feature-major attention core -----------------------------------

@pytest.fixture(scope="module")
def lab():
    return _script("attn_core_lab")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_core_fm_plain_matches_pallas(lab, dtype):
    heads, dh = 2, 32
    x = 0.5 * np.random.default_rng(12).standard_normal((N, 3 * heads * dh, 128),
                                                        dtype=np.float32)
    jx = jnp.asarray(x).astype(dtype)
    want = np.asarray(lab.core_fm(jx, heads=heads, dim_head=dh, interpret=True), np.float32)
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(getattr(torch, dtype))
    got = fm_mod.attention_core_fm(tx, heads=heads, dim_head=dh)
    assert got.shape == (N, heads * dh, 128) and got.dtype == tx.dtype
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-5)
    else:
        assert_bf16_close(got.float().numpy(), want, "core_fm")


@pytest.mark.parametrize("variant", ["rounded_products", "rounded_partial_sums"])
def test_the_node_sum_of_core_fm_is_rounded_once(lab, variant):
    """core_fm in interpret mode does not round the v·a products and rounds
    the node sum once: the plain version, which does the same, differs from
    it only where a sum in another order flips a rounding (≤ 0.01% of
    elements), and rounding either moves the result 100× farther off."""
    heads, dh, dt = 2, 32, torch.bfloat16
    x = 0.5 * np.random.default_rng(12).standard_normal((N, 3 * heads * dh, 128),
                                                        dtype=np.float32)
    jx = jnp.asarray(x).astype("bfloat16")
    want = np.asarray(lab.core_fm(jx, heads=heads, dim_head=dh, interpret=True), np.float32)
    qkv = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(dt)
    got = np.abs(fm_mod.attention_core_fm_plain(qkv, heads, dh).float().numpy() - want)
    assert (got > 0).mean() <= 1e-4
    # the same core with its v·a products rounded, or its node sum rounded
    # after each add
    rnd = lambda t: t.to(dt).float()  # noqa: E731
    q, k, v = (t.reshape(N, heads, dh, -1) for t in qkv.float().split(heads * dh, dim=1))
    qn = rnd(q * rnd(torch.tensor(dh ** -0.5)))
    a = rnd(torch.softmax(torch.stack([rnd(k * qn[i]).sum(dim=2) for i in range(N)]), dim=1))
    seg = a[:, :, :, None, :] * v[None]  # [n, m, h, c, b]
    if variant == "rounded_products":
        out = rnd(rnd(seg).sum(dim=1))
    else:
        out = seg[:, 0]
        for m in range(1, N):
            out = rnd(out + seg[:, m])
    off = np.abs(out.reshape(N, heads * dh, -1).numpy() - want).mean()
    print(f"core_fm with {variant}: mean |Δ| {off:.3e}; the plain version {got.mean():.3e}")
    assert off > 100 * got.mean()


def test_attention_core_fm_plain_equals_batch_major_core():
    """In fp32 the feature-major core is B2's function on the transposed layout."""
    heads, dh = 8, 32
    qkv = 0.5 * torch.from_numpy(np.random.default_rng(13).standard_normal(
        (N, 3 * heads * dh, 16), dtype=np.float32))
    got = fm_mod.attention_core_fm_plain(qkv, heads, dh)
    want = attention_core_plain(qkv.transpose(1, 2).contiguous(), heads, dh).transpose(1, 2)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-5)


# ---- the entry points on the CPU --------------------------------------------

def test_decode_check_script_runs_on_cpu(capsys):
    script = _script("torch_decode_bf16_check")
    assert script.main(["--device", "cpu", "--batch", "16", "--ph", "4"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert set(out) == {"batch", "ph", "mm_mean", "mm_max", "mm_mean_step0", "mm_mean_step3",
                        "fp32_s", "bf16_s", "speedup", "device"}
    assert (out["batch"], out["ph"], out["device"]) == (16, 4, "cpu")
    # bf16 operands move the poses by well under a centimetre, but move them
    assert 0 < out["mm_mean"] <= out["mm_max"] < 10


@pytest.mark.parametrize("check", [True, False])
def test_attention_lab_script_runs_on_cpu(capsys, check):
    script = _script("torch_attn_core_lab")
    argv = ["--device", "cpu"] + (["--check"] if check else ["--batch", "8"])
    assert script.main(argv) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    if check:
        assert out["f32_max_err"] < 2e-5 and 0 < out["bf16_max_err"] < 1e-2
    else:
        assert set(out) == {"batch", "depth", "bm_ms_per_call", "fm_ms_per_call", "device"}


# ---- the wrappers on a CUDA request -----------------------------------------

def _cuda_request(monkeypatch):
    """The wrappers' CUDA branch for CPU tensors, with no GPU to build for."""
    monkeypatch.setattr(build, "kernel_device", lambda **tensors: "cuda")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    build.c_entry.cache_clear()


def _refusing_entry(monkeypatch):
    """A C entry that refuses the shapes (cudaErrorInvalidValue) and launches
    nothing."""
    monkeypatch.setattr(build, "c_entry", lambda *a: (lambda *args: 1))
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(cuda_stream=0))


def _bf16_rollout_inputs(h: int):
    inp = {k: torch.from_numpy(v)
           for k, v in _rollout_inputs(np.random.default_rng(4), None, b=4, h=h).items()}
    return {k: v.to(torch.bfloat16) if k in ("cx", "w_hh", "w_fc") else v for k, v in inp.items()}


def test_gru_rollout_bf16_raises_instead_of_falling_back(monkeypatch):
    inp = _bf16_rollout_inputs(96)
    _cuda_request(monkeypatch)
    before = (rollout_mod.launches, rollout_mod.launches_bf16)
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        rollout_mod.gru_rollout(**inp, ph=3, compute_dtype=torch.bfloat16)
    with pytest.raises(TypeError, match="cx must be bfloat16, got torch.float32"):
        rollout_mod.gru_rollout(**{**inp, "cx": inp["cx"].float()}, ph=3,
                                compute_dtype=torch.bfloat16)
    with pytest.raises(TypeError, match="h0 must be float32, got torch.bfloat16"):
        rollout_mod.gru_rollout(**{**inp, "h0": inp["h0"].to(torch.bfloat16)}, ph=3,
                                compute_dtype=torch.bfloat16)
    with pytest.raises(TypeError, match="compute_dtype must be None or bfloat16"):
        rollout_mod.gru_rollout(**inp, ph=3, compute_dtype=torch.float16)
    _refusing_entry(monkeypatch)
    with pytest.raises(RuntimeError, match=r"gru_rollout_bf16 at .*=\(21, 16, 3\): .*cudaError 1"):
        rollout_mod.gru_rollout(**_bf16_rollout_inputs(16), ph=3, compute_dtype=torch.bfloat16)
    assert (rollout_mod.launches, rollout_mod.launches_bf16) == before


def test_attention_core_fm_raises_instead_of_falling_back(monkeypatch):
    qkv = torch.zeros(N, 3 * 8 * 32, 4, dtype=torch.bfloat16)
    _cuda_request(monkeypatch)
    before = fm_mod.launches
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        fm_mod.attention_core_fm(qkv, heads=8, dim_head=32)
    with pytest.raises(TypeError, match="built for bfloat16 and float32"):
        fm_mod.attention_core_fm(qkv.double(), heads=8, dim_head=32)
    with pytest.raises(ValueError, match="qkv has shape"):
        fm_mod.attention_core_fm(qkv, heads=4, dim_head=32)
    with pytest.raises(ValueError, match="contiguous"):
        fm_mod.attention_core_fm(qkv.transpose(1, 2).contiguous().transpose(1, 2), heads=8,
                                 dim_head=32)
    # a head width the kernel is not built for: refused by its plan before a launch
    with pytest.raises(ValueError, match="heads of 32, got 8 × 16"):
        fm_mod.attention_core_fm(torch.zeros(N, 3 * 8 * 16, 4), heads=8, dim_head=16)
    _refusing_entry(monkeypatch)
    with pytest.raises(RuntimeError, match=r"=\(21, 8, 32, 8, 2, 218240\): .*cudaError 1"):
        fm_mod.attention_core_fm(torch.zeros(N, 3 * 8 * 32, 4), heads=8, dim_head=32)
    assert fm_mod.launches == before
