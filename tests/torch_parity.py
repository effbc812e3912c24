"""Shared set-up of the PyTorch port's parity tests (tests/test_torch_*.py):
the same small AMASS model in the JAX package and in the port, with the
same weights, and inputs made with numpy from a seed.

Small size: the real 21-node AMASS skeleton, latent and hidden 16, denoiser
depth 1 with 2 heads × 4, 4 diffusion steps.  The fused-denoiser tests use
the flagship's widths at a small depth instead (``WIDE``: latent 96, so
F = 192, denoiser depth 2 with 8 heads × 32; ``wide_model_pair``), the bf16
predictor check ``hold_bf16_predictor`` against the JAX fused chain and its
bound ``BF16_SPREAD``, and the kernel tests ``KernelInputs``, ``pad_to`` and
``check_kernel``.
"""
from __future__ import annotations

import importlib.util
import os
import pathlib
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import torch

from skeletondiffusion_tpu.diffusion.manager import create_diffusion as jax_create_diffusion
from skeletondiffusion_tpu.models import AutoEncoder as JaxAutoEncoder
from skeletondiffusion_tpu.skeleton import create_skeleton as jax_create_skeleton
from skeletondiffusion_tpu_torch.diffusion.manager import create_diffusion
from skeletondiffusion_tpu_torch.models import AutoEncoder
from skeletondiffusion_tpu_torch.ops.graph_linear import l1_normalize_rows
from skeletondiffusion_tpu_torch.skeleton import create_skeleton
from skeletondiffusion_tpu_torch.weights import load_autoencoder_params, load_denoiser_params

LATENT = HIDDEN = 16
TIMESTEPS = 4
OBS_LEN, PRED_LEN = 6, 10
ARCH = {"depth": 1, "attn_heads": 2, "attn_dim_head": 4, "use_attention": True,
        "learn_influence": True, "self_condition": False, "norm_type": "none"}
WIDE = dict(latent=96, hidden=16,
            arch={**ARCH, "depth": 2, "attn_heads": 8, "attn_dim_head": 32})
SKELETON_KW = dict(dataset_name="amass", motion_repr_type="SkeletonRescalePose", num_joints=22,
                   pose_box_size=1.5, obs_length=OBS_LEN, pred_length=PRED_LEN,
                   if_consider_hip=False)


def skeletons():
    """(JAX skeleton, port skeleton) of the same configuration."""
    return jax_create_skeleton(**SKELETON_KW), create_skeleton(**SKELETON_KW)


def skeletons_of(dataset: str, joints: int, obs: int = OBS_LEN, pred: int = PRED_LEN):
    """(JAX skeleton, port skeleton) of ``dataset`` with ``joints`` joints
    (h36m 17, freeman 18, 3dpw 22), the hip dropped."""
    kw = dict(SKELETON_KW, dataset_name=dataset, num_joints=joints, obs_length=obs,
              pred_length=pred)
    return jax_create_skeleton(**kw), create_skeleton(**kw)


def perturb_influence(tree, rng: np.random.Generator):
    """Move every influence matrix off its identity/zero init (as training
    does), so that the node mixes are exercised."""
    out = {}
    for key, value in tree.items():
        if isinstance(value, dict):
            out[key] = perturb_influence(value, rng)
        elif key in ("G", "G0"):
            out[key] = np.asarray(value) + 0.2 * rng.random(value.shape, dtype=np.float32)
        elif key == "G_add":
            out[key] = 0.05 * (rng.random(value.shape, dtype=np.float32) - 0.5)
        else:
            out[key] = np.asarray(value)
    return out


def spread_weights(tree, rng: np.random.Generator):
    """Add N(0, 1/fan_in) to every weight bank and Dense kernel, so that the
    denoiser's activations and its x̂₀ are O(1) as a trained model's are (the
    init's are ~1e-2: bf16 effects would sit at the last rounding of the
    output)."""
    out = {}
    for key, value in tree.items():
        if isinstance(value, dict):
            out[key] = spread_weights(value, rng)
        elif key in ("weight", "kernel"):
            fan_in = value.shape[-2]
            out[key] = (np.asarray(value) + rng.standard_normal(value.shape).astype(np.float32)
                        / np.sqrt(fan_in))
        else:
            out[key] = np.asarray(value)
    return out


def jax_models(jax_skeleton, seed: int = 0, latent: int = LATENT, hidden: int = HIDDEN,
               arch=ARCH, compute_dtype=None, spread: bool = False):
    """(flax AutoEncoder, its params, engine, denoiser, its params) with
    perturbed influence matrices, params as numpy trees; ``compute_dtype``
    (e.g. ``"bfloat16"``) is the AutoEncoder's and the denoiser's;
    ``spread`` spreads the denoiser's weights (``spread_weights``)."""
    rng = np.random.default_rng(seed)
    N = jax_skeleton.num_nodes
    ae = JaxAutoEncoder(num_nodes=N, encoder_hidden_size=hidden, decoder_hidden_size=hidden,
                        latent_size=latent, node_types=jax_skeleton.nodes_type_id,
                        compute_dtype=compute_dtype)
    ae_params = ae.init(jax.random.key(seed), jnp.zeros((1, PRED_LEN, N, 3)),
                        jnp.zeros((1, OBS_LEN, N, 3)), ph=PRED_LEN,
                        method=JaxAutoEncoder.autoencode)
    engine, den = jax_create_diffusion(
        jax_skeleton, diffusion_type="NonisotropicGaussianDiffusion",
        covariance_matrix_type="adjacency", latent_size=latent, diffusion_conditioning=True,
        diffusion_timesteps=TIMESTEPS, diffusion_arch=dict(arch), compute_dtype=compute_dtype,
    )
    den_params = den.init(jax.random.key(seed + 1), jnp.zeros((1, N, latent)),
                          jnp.zeros((1,), jnp.int32), jnp.zeros((1, N, latent)))
    ae_params = perturb_influence(jax.device_get(ae_params), rng)
    den_params = perturb_influence(jax.device_get(den_params), rng)
    if spread:
        den_params = spread_weights(den_params, rng)
    return ae, ae_params, engine, den, den_params


def port_models(port_skeleton, ae_params, den_params, latent: int = LATENT,
                hidden: int = HIDDEN, arch=ARCH, compute_dtype=None):
    """The port's AutoEncoder and engine on the CPU, loaded with the flax
    weights through the bridge; ``compute_dtype`` as ``jax_models`` takes it."""
    compute_dtype = {None: None, "bfloat16": torch.bfloat16}[compute_dtype]
    gen = torch.Generator().manual_seed(123)
    ae = AutoEncoder(port_skeleton.num_nodes, hidden, hidden, latent, gen,
                     node_types=port_skeleton.nodes_type_id, compute_dtype=compute_dtype)
    load_autoencoder_params(ae, ae_params)
    engine, den = create_diffusion(
        port_skeleton, gen, latent_size=latent, diffusion_conditioning=True,
        diffusion_timesteps=TIMESTEPS, diffusion_arch=dict(arch), device="cpu",
        compute_dtype=compute_dtype,
    )
    load_denoiser_params(den, den_params)
    return ae, engine, den


def as_jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def assert_bf16_close(got, want, what: str = ""):
    """The bf16 criteria, compared in float32: max |Δ| ≤ 3e-2·max|ref| and
    mean |Δ| ≤ 2e-3·max|ref| (bf16 keeps 8 significant bits, unit roundoff
    2^-8, and each kernel rounds 2–4 times)."""
    got = np.asarray(got, dtype=np.float32)
    want = np.asarray(want, dtype=np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = float(np.abs(want).max())
    diff = np.abs(got - want)
    assert np.isfinite(got).all(), what
    assert diff.max() <= 3e-2 * scale, (what, float(diff.max()), scale)
    assert diff.mean() <= 2e-3 * scale, (what, float(diff.mean()), scale)


# ---- the bf16 prediction path end to end ------------------------------------

# Two bf16 chains that round at the same points but sum in another order
# drift apart: a sum lands on the other side of a rounding point now and
# then, and the next layers carry the flip on, so over the 15 layers of depth
# 2 their difference grows to the size of their rounding error itself.  So the
# port's bf16 predictor is held within this factor of the JAX bf16 chain's own
# deviation from its fp32 chain, on the same inputs (``hold_bf16_predictor``).
# Ratios to the JAX chain's bf16-vs-fp32 deviation, latents / predictions:
#
# * before the plain bf16 modules rounded where XLA rounds (the encoder's
#   graph-GRU step rounded after every PyTorch op), single-stage chain of
#   ``test_torch_fused.py``: port vs JAX bf16 mean 0.85 / 1.04; port vs JAX
#   fp32 max 1.24 / 1.42 — the bound was 1.5;
# * since (the encoder matches the flax cell bit for bit, see
#   ``test_torch_layer_fused.py::test_plain_bf16_modules_round_where_xla_rounds``):
#   single-stage chain, port vs JAX bf16 mean 0.857 / 1.271, port vs JAX fp32
#   max 1.000 / 1.161 and mean 1.022 / 1.125; layer-fused chain of
#   ``test_torch_layer_fused.py``: 0.836 / 0.819, max 0.948 / 0.952, mean
#   1.007 / 0.918.
#
# The worst, 1.271, passes 1.4 with 10% to spare on these inputs (seeds 8
# and 9); the bound depends on them: at seed 21 the predictions' max reads
# 1.540 (``test_torch_fused.py::test_bf16_predictor_spread_depends_on_the_inputs``,
# ROADMAP Queue C item 1).  The remaining excess over
# 1× is not a rounding point of the plain modules (that test finds none that
# differs); the predictor's denoiser is the fused kernel chain, whose plain
# versions match the Pallas kernels' rounding points but not their order of
# summation.
BF16_SPREAD = 1.4

SAMPLES_E2E, BATCH_E2E = 4, 2

# AMASS-MANO's small widths (tests/test_torch_mano_paths.py) and its bf16
# golden: the JAX fused chain's bf16 and fp32 runs at 51 nodes, written by
# scripts/mano_bf16_golden.py (interpret mode, ~2 min)
MANO_SMALL = dict(latent=32, hidden=16, arch={**ARCH, "attn_heads": 4, "attn_dim_head": 32})
MANO_GOLDEN = pathlib.Path(__file__).resolve().parent / "goldens" / "mano_bf16.npz"
MANO_GOLDEN_STEPS, MANO_GOLDEN_INPUT_SEED, MANO_GOLDEN_WEIGHT_SEED = 2, 52, 3


def model_pair(jsk, sk, width=WIDE, seed: int = 3) -> dict:
    """{dtype: models}: the JAX models and the port's with the same weights
    (from ``seed``) on the skeleton pair (jsk, sk) at ``width`` (latent,
    hidden, arch) with spread denoiser weights, for float32 (None) and
    bfloat16."""
    out = {}
    for dtype in (None, "bfloat16"):
        jae, ae_params, jengine, jden, den_params = jax_models(
            jsk, seed=seed, latent=width["latent"], hidden=width["hidden"], arch=width["arch"],
            compute_dtype=dtype, spread=True)
        ae, engine, den = port_models(sk, ae_params, den_params, latent=width["latent"],
                                      hidden=width["hidden"], arch=width["arch"],
                                      compute_dtype=dtype)
        out[dtype] = dict(jae=jae, ae_params=as_jax(ae_params), jengine=jengine, jden=jden,
                          den_params=as_jax(den_params), ae=ae, engine=engine, den=den,
                          latent=width["latent"])
    return out


def wide_model_pair():
    """(JAX skeleton, port skeleton, {dtype: models}): ``model_pair`` of the
    AMASS skeleton at the flagship's widths (``WIDE``)."""
    jsk, sk = skeletons()
    return jsk, sk, model_pair(jsk, sk)


def jax_fused_chain(jsk, m, obs, start, steps, compiled: bool = False):
    """The JAX package's fused prediction path composed by hand, as
    ``tests/test_fused_sampling.py`` composes it: past embedding, the fused
    core (the layer-fused one when ``SKELDIFF_LAYER_FUSED=1``) and
    ``posterior_step_pallas`` for each step, ``decode_rollout``, the
    metric-space transform; Pallas kernels with ``interpret=True``, op by op
    or, with ``compiled``, the core compiled with ``jax.jit`` (which moves
    bf16 rounding points, so only for float32, where it changes the order of
    the sums and is many times faster).
    Returns (latents [B,S,N,L], metric-space predictions [B,S,T,N,3])."""
    from skeletondiffusion_tpu.ops.pallas import denoiser_fused as jax_fused
    from skeletondiffusion_tpu.ops.pallas.gru_rollout import decode_rollout
    from skeletondiffusion_tpu.ops.pallas.posterior_step import posterior_step_pallas

    b, n, latent, s = obs.shape[0], obs.shape[2], start.shape[-1], SAMPLES_E2E
    jden, params = m["jden"], m["den_params"]
    z = m["jae"].apply(m["ae_params"], obs, method=JaxAutoEncoder.get_past_embedding)
    x_cond = jnp.repeat(z, s, axis=0)
    u_pad = pad_to(jden.apply(params, x_cond, method=jden.cond_embedding), 256)
    prepped = jax_fused.prep_fused_denoiser(jden, params)
    tables = m["jengine"].process.posterior_step_tables()
    img = pad_to(jnp.swapaxes(start, 0, 1), 128)

    def core(img, t):
        return jax_fused.fused_denoiser_core_nm(jden, params, img, t, u_pad, prepped=prepped,
                                                batch_tile=8, interpret=True)

    core = jax.jit(core) if compiled else core
    for t in range(TIMESTEPS - 1, -1, -1):
        mo = core(img, jnp.asarray(t, jnp.int32))
        noise = steps[:, TIMESTEPS - 1 - t] if t > 0 else jnp.zeros_like(start)
        img = posterior_step_pallas(mo, img, pad_to(jnp.swapaxes(noise, 0, 1), 128),
                                    tables[t], batch_tile=8, interpret=True)
    latents = jnp.swapaxes(img[:, :, :latent], 0, 1)
    pred = decode_rollout(m["ae_params"]["params"]["decoder"], jsk.nodes_type_id,
                          jnp.repeat(obs, s, axis=0)[:, -2:], latents, PRED_LEN, batch_tile=8,
                          interpret=True)
    return (np.asarray(latents).reshape(b, s, n, latent),
            np.asarray(jsk.transform_to_metric_space(pred.reshape(b, s, PRED_LEN, n, 3))))


def predictor_inputs(n: int, latent: int, seed: int) -> tuple:
    """(observations, start noise, step noise) of ``seed`` for BATCH_E2E
    observations × SAMPLES_E2E samples and TIMESTEPS steps, numpy."""
    rows = BATCH_E2E * SAMPLES_E2E
    rng = np.random.default_rng(seed)
    obs = 0.3 * rng.standard_normal((BATCH_E2E, OBS_LEN, n, 3), dtype=np.float32)
    start = rng.standard_normal((rows, n, latent), dtype=np.float32)
    steps = rng.standard_normal((rows, TIMESTEPS - 1, n, latent), dtype=np.float32)
    return obs, start, steps


def port_predictor_run(sk, models: dict, inputs: tuple, fused: bool) -> tuple:
    """The port's predictor of ``models`` (one dtype of ``model_pair``; the
    fused denoiser branch if ``fused``, as bf16 takes it) on the CPU with the
    injected noise of ``inputs`` (``predictor_inputs``): (latents,
    metric-space predictions), numpy."""
    from skeletondiffusion_tpu_torch.eval_pipeline import SkeletonDiffusionPredictor

    obs, start, steps = inputs
    pred = SkeletonDiffusionPredictor(sk, models["ae"], models["engine"],
                                      num_samples=SAMPLES_E2E, pred_length=PRED_LEN, device="cpu")
    assert (pred.diffusion.fused is not None) == fused
    got, got_lat = pred(None, torch.from_numpy(obs), start_noise=torch.from_numpy(start),
                        step_noise=torch.from_numpy(steps))
    got = sk.transform_to_metric_space(got).numpy()
    assert got.shape == (BATCH_E2E, SAMPLES_E2E, PRED_LEN, sk.num_nodes, 3)
    assert np.isfinite(got).all()
    return got_lat.numpy(), got


def predictor_runs(jsk, sk, m, seed: int, dtypes=("bfloat16",)) -> dict:
    """The JAX fused chain (``jax_fused_chain``) in fp32 and bf16 and the
    port's predictors of ``dtypes`` (the models of ``m``, on the CPU) with
    the same injected noise on the inputs of ``seed``, each taking the
    denoiser path the environment selects: {"jax": {dtype: (latents,
    predictions)}, "port": {dtype: (latents, predictions)}}, metric space."""
    inputs = predictor_inputs(jsk.num_nodes, m[None]["latent"], seed)
    runs = {"jax": {d: jax_fused_chain(jsk, m[d], *map(jnp.asarray, inputs), compiled=d is None)
                    for d in (None, "bfloat16")}, "port": {}}
    for d in dtypes:
        runs["port"][d] = port_predictor_run(sk, m[d], inputs, fused=d == "bfloat16")
    return runs


def bf16_predictor_ratios(jsk, sk, m, seed: int, runs=None) -> dict:
    """The port's bf16 predictor with injected noise against the JAX fused
    chain (``predictor_runs``, or ``runs`` made by it) on the inputs of
    ``seed``: for the latents and the predictions, each deviation over the
    JAX chain's own bf16-vs-fp32 deviation (``vs_jax_bf16_mean``: port bf16
    against JAX bf16; ``vs_fp32_max`` and ``vs_fp32_mean``: port bf16 against
    JAX fp32)."""
    runs = runs or predictor_runs(jsk, sk, m, seed)
    chain, (got_lat, got) = runs["jax"], runs["port"]["bfloat16"]
    ratios = {}
    for what, mine, i in (("latents", got_lat, 0), ("predictions", got, 1)):
        ref, fp32 = chain["bfloat16"][i], chain[None][i]
        vs_jax_bf16, jax_err, port_err = (np.abs(mine - ref), np.abs(ref - fp32),
                                          np.abs(mine - fp32))
        ratios[what] = dict(vs_jax_bf16_mean=vs_jax_bf16.mean() / jax_err.mean(),
                            vs_fp32_max=port_err.max() / jax_err.max(),
                            vs_fp32_mean=port_err.mean() / jax_err.mean())
        print(f"{what}: port bf16 vs JAX bf16 max |Δ| {vs_jax_bf16.max():.3e} mean "
              f"{vs_jax_bf16.mean():.3e}; JAX bf16 vs JAX fp32 max {jax_err.max():.3e} mean "
              f"{jax_err.mean():.3e}; port bf16 vs JAX fp32 max {port_err.max():.3e} mean "
              f"{port_err.mean():.3e}; ratios "
              + ", ".join(f"{k} {v:.3f}" for k, v in ratios[what].items()))
    return ratios


def hold_bf16_predictor(jsk, sk, m, seed: int, runs=None) -> dict:
    """``bf16_predictor_ratios`` held: the port's bf16 path is as close to
    fp32 as the JAX package's is, and no farther from the JAX bf16 path than
    the bf16 rounding noise, each within ``BF16_SPREAD``.  Returns the
    ratios."""
    ratios = bf16_predictor_ratios(jsk, sk, m, seed, runs)
    for what, r in ratios.items():
        for name in ("vs_fp32_max", "vs_fp32_mean", "vs_jax_bf16_mean"):
            assert r[name] <= BF16_SPREAD, (what, name, r[name])
    return ratios


def load_script(name: str):
    """Import ``scripts/<name>.py`` as a module, leaving the environment as
    it was (the JAX lab script sets cache variables when it is imported)."""
    path = pathlib.Path(__file__).resolve().parents[1] / "scripts" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    with mock.patch.dict(os.environ):
        spec.loader.exec_module(module)
    return module


# ---- kernel tests: inputs at the flagship's widths, 21 nodes -------------

KERNEL_NODES = 21
DTYPES = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}


class KernelInputs:
    """Random inputs made with numpy from a seed, rounded to the dtype under
    test, handed to the port as torch tensors and to JAX as arrays."""

    def __init__(self, dtype: str, seed: int, nodes: int = KERNEL_NODES):
        self.rng = np.random.default_rng(seed)
        self.tdt, self.jdt = DTYPES[dtype]
        self.nodes = nodes

    def _make(self, a: np.ndarray):
        t = torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(self.tdt)
        return t, jnp.asarray(t.float().numpy(), self.jdt)

    def act(self, *shape, scale=0.5):
        return self._make(scale * self.rng.standard_normal(shape))

    def bank(self, fi, fo):
        return self._make(self.rng.standard_normal((self.nodes, fi, fo)) / np.sqrt(fi))

    def bias(self, fo):
        return self._make(0.1 * self.rng.standard_normal((self.nodes, fo)))

    def influence(self):
        g = np.eye(self.nodes) + 0.2 * self.rng.random((self.nodes, self.nodes))
        return self._make(l1_normalize_rows(torch.from_numpy(g)).numpy())

    def film(self, f):
        return self._make(0.3 * self.rng.standard_normal(2 * f))


def pad_to(a, *sizes):
    """Zero-pad the trailing axes of a JAX array to ``sizes`` (the Pallas
    kernels' 128-lane feature widths)."""
    lead = a.ndim - len(sizes)
    return jnp.pad(a, [(0, 0)] * lead + [(0, s - n) for s, n in zip(sizes, a.shape[lead:])])


def check_kernel(got: torch.Tensor, want, dtype: str, what: str = ""):
    """A kernel's plain version against its Pallas kernel: float32 at the JAX
    tests' atol 2e-5, rtol 1e-4 (sums in another order); bf16 by
    ``assert_bf16_close``."""
    got = got.float().numpy()
    want = np.asarray(jnp.asarray(want, jnp.float32))
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=2e-5, rtol=1e-4, err_msg=what)
    else:
        assert_bf16_close(got, want, what)
