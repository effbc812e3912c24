"""The port's modules against the flax modules, with the flax weights
carried across by the weight bridge: the encoder's past embedding, the
Denoiser forward (against flax's x_cond and hoisted u_cond paths, with
per-row and shared time) and the bridge's strictness.

Tolerance 1e-5 absolute: float32 on both sides; the values are O(1) and the
sums differ only in order."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skeletondiffusion_tpu.models import AutoEncoder as JaxAutoEncoder
from skeletondiffusion_tpu.models.denoiser import Denoiser as JaxDenoiser
from skeletondiffusion_tpu_torch.weights import flatten_params, load_denoiser_params

from torch_parity import LATENT, OBS_LEN, TIMESTEPS, as_jax, jax_models, port_models, skeletons


@pytest.fixture(scope="module")
def pair():
    jsk, sk = skeletons()
    jae, ae_params, jengine, jden, den_params = jax_models(jsk, seed=3)
    ae, engine, den = port_models(sk, ae_params, den_params)
    return dict(jsk=jsk, sk=sk, jae=jae, ae_params=ae_params, jden=jden,
                den_params=den_params, ae=ae, den=den, jengine=jengine)


def test_past_embedding_matches_flax(pair):
    rng = np.random.default_rng(0)
    obs = 0.3 * rng.standard_normal((5, OBS_LEN, 21, 3), dtype=np.float32)
    want = pair["jae"].apply(as_jax(pair["ae_params"]), jnp.asarray(obs),
                             method=JaxAutoEncoder.get_past_embedding)
    got = pair["ae"].get_past_embedding(torch.from_numpy(obs))
    assert got.shape == want.shape == (5, 21, LATENT)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


@pytest.mark.parametrize("shared_time", [False, True])
def test_denoiser_forward_matches_flax(pair, shared_time):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((6, 21, LATENT), dtype=np.float32)
    x_cond = np.tanh(rng.standard_normal((6, 21, LATENT), dtype=np.float32))
    t = np.int32(2) if shared_time else rng.integers(0, TIMESTEPS, 6).astype(np.int32)
    want = pair["jden"].apply(as_jax(pair["den_params"]), jnp.asarray(x), jnp.asarray(t),
                              jnp.asarray(x_cond))
    den = pair["den"]
    with torch.no_grad():
        u_cond = den.cond_embedding(torch.from_numpy(x_cond))
        got = den(torch.from_numpy(x).transpose(0, 1), torch.as_tensor(t), u_cond).transpose(0, 1)
    assert got.shape == want.shape == (6, 21, LATENT)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


def test_denoiser_hoisted_condition_matches_flax(pair):
    """The sampler's path: cond_embedding once, then the node-major forward
    with u_cond, as the JAX engine's model_apply_ucond runs it."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((4, 21, LATENT), dtype=np.float32)
    x_cond = np.tanh(rng.standard_normal((4, 21, LATENT), dtype=np.float32))
    params = as_jax(pair["den_params"])
    u = pair["jden"].apply(params, jnp.asarray(x_cond), method=JaxDenoiser.cond_embedding)
    want = pair["jden"].apply(params, jnp.asarray(x), jnp.asarray(1, jnp.int32), u_cond=u)
    den = pair["den"]
    with torch.no_grad():
        u_port = den.cond_embedding(torch.from_numpy(x_cond))
        got = den(torch.from_numpy(x).transpose(0, 1), 1, u_port).transpose(0, 1)
    np.testing.assert_allclose(u_port.numpy(), np.asarray(u), rtol=0, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


def test_weight_bridge_is_strict(pair):
    params = pair["den_params"]
    names = set(flatten_params(params))
    assert names == set(pair["den"].state_dict())
    missing = {k: v for k, v in params["params"].items() if k != "final_glin"}
    with pytest.raises(RuntimeError, match="final_glin"):
        load_denoiser_params(pair["den"], {"params": missing})
    extra = {**params["params"], "unused": {"weight": np.zeros(3, np.float32)}}
    with pytest.raises(RuntimeError, match="unused"):
        load_denoiser_params(pair["den"], {"params": extra})
    wrong = {**params["params"], "final_glin": {**params["params"]["final_glin"],
                                                "bias": np.zeros((1, 1), np.float32)}}
    with pytest.raises(RuntimeError, match="final_glin.bias"):
        load_denoiser_params(pair["den"], {"params": wrong})
