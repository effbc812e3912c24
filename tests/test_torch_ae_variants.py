"""The AutoEncoder's model variants of the port against the flax modules:
the graph-LSTM cell and a two-layer sequence module, ``DynamicGraphLinear``
(by ``g`` and by ``t``) and ``gmm``, each AutoEncoder variant (LSTM encoder
and decoder, a two-layer GRU encoder, the identity latent activation), one
stage-1 training step of the LSTM AutoEncoder against the JAX trainer's, the
predictor with an LSTM decoder end to end with injected noise, and the
decode route (an LSTM decoder never reaches the rollout kernel).

The flax weights are carried into the port by the weight bridge.  fp32:
1e-5 a module, 1e-4 end to end and for the loss; bf16: the port's deviation
from the jitted flax module in bf16 within ``BF16_SPREAD`` of the flax
module's own bf16-vs-fp32 deviation (max and mean).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skeletondiffusion_tpu.models import AutoEncoder as JaxAutoEncoder
from skeletondiffusion_tpu.ops import graph_gru as jgru
from skeletondiffusion_tpu.ops import graph_linear as jglin
from skeletondiffusion_tpu_torch.cli.common import build_autoencoder
from skeletondiffusion_tpu_torch.eval_pipeline import SkeletonDiffusionPredictor
from skeletondiffusion_tpu_torch.models import AutoEncoder
from skeletondiffusion_tpu_torch.ops import graph_gru, graph_linear
from skeletondiffusion_tpu_torch.ops.kernels import gru_rollout
from skeletondiffusion_tpu_torch.train.trainer_autoencoder import AutoEncoderTrainer
from skeletondiffusion_tpu_torch.utils.torch_port import load_reference_autoencoder
from skeletondiffusion_tpu_torch.weights import flatten_params, load_autoencoder_params

from torch_parity import (
    BF16_SPREAD,
    HIDDEN,
    LATENT,
    OBS_LEN,
    PRED_LEN,
    TIMESTEPS,
    as_jax,
    jax_models,
    perturb_influence,
    port_models,
    skeletons,
)

N, B, H, F_IN = 21, 3, 8, 5
TORCH_DTYPES = {None: None, "bfloat16": torch.bfloat16}

VARIANTS = {
    "lstm": dict(recurrent_arch_enc="StaticGraphLSTM", recurrent_arch_decoder="StaticGraphLSTM"),
    "gru_two_layers": dict(enc_num_layers=2),
    "lstm_two_layers": dict(recurrent_arch_enc="StaticGraphLSTM", enc_num_layers=2),
    "z_identity": dict(z_activation="identity"),
}


def numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def spread_params(tree, rng):
    """Every recurrent and graph-linear bank moved off its (tied) init by
    N(0, 1/fan_in): distinct banks per node type, O(1) gates."""
    out = {}
    for key, value in tree.items():
        if isinstance(value, dict):
            out[key] = spread_params(value, rng)
        elif key.startswith("weight") or key.startswith("bias"):
            fan_in = value.shape[-2] if value.ndim > 2 else value.shape[-1]
            out[key] = (np.asarray(value) + rng.standard_normal(value.shape).astype(np.float32)
                        / np.sqrt(fan_in))
        else:
            out[key] = np.asarray(value)
    return out


def hold_spread(got, want_bf16, want_fp32, what: str):
    """The port's bf16 result within BF16_SPREAD of the flax module's own
    bf16-vs-fp32 deviation, max and mean."""
    got, wb, wf = (np.asarray(a, dtype=np.float32) for a in (got, want_bf16, want_fp32))
    assert got.shape == wb.shape and np.isfinite(got).all(), what
    d, ref = np.abs(got - wb), np.abs(wb - wf)
    assert ref.max() > 0, what
    assert d.max() <= BF16_SPREAD * ref.max(), (what, float(d.max()), float(ref.max()))
    assert d.mean() <= BF16_SPREAD * ref.mean(), (what, float(d.mean()), float(ref.mean()))


def check(got, want, what: str, atol: float = 1e-5):
    np.testing.assert_allclose(np.asarray(got, dtype=np.float32), np.asarray(want), rtol=0,
                               atol=atol, err_msg=what)


@pytest.fixture(scope="module")
def sk_pair():
    return skeletons()


# ---- the recurrent modules ----------------------------------------------------


def lstm_cell_pair(sk, dtype, seed=0):
    rng = np.random.default_rng(seed)
    cell = jgru.StaticGraphLSTMCell(input_size=F_IN, hidden_size=H, num_nodes=N,
                                    node_types=sk.nodes_type_id, learn_influence=True,
                                    learn_additive_graph_influence=True, node_major=True,
                                    compute_dtype=dtype)
    carry = (jnp.zeros((N, B, H)), jnp.zeros((N, B, H)), jnp.eye(N))
    params = cell.init(jax.random.key(seed), carry, jnp.zeros((N, B, F_IN)))
    params = spread_params(perturb_influence(numpy_tree(params)["params"], rng), rng)
    port = graph_gru.StaticGraphLSTMCell(F_IN, H, N, torch.Generator().manual_seed(1),
                                         sk.nodes_type_id, learn_additive_graph_influence=True,
                                         compute_dtype=TORCH_DTYPES[dtype])
    port.load_state_dict(flatten_params(params), strict=True)
    return cell, params, port


@pytest.mark.parametrize("dtype", [None, "bfloat16"])
def test_lstm_cell_matches_flax(sk_pair, dtype):
    """Five steps of the graph-LSTM cell (carries and influence carried on)."""
    jsk, sk = sk_pair
    rng = np.random.default_rng(4)
    x = rng.standard_normal((N, B, F_IN), dtype=np.float32)
    h0 = 0.5 * rng.standard_normal((N, B, H), dtype=np.float32)
    c0 = 0.5 * rng.standard_normal((N, B, H), dtype=np.float32)
    g0 = np.eye(N, dtype=np.float32) + 0.1 * rng.random((N, N), dtype=np.float32)
    runs = {}
    for d in (None, dtype) if dtype else (None,):
        cell, params, port = lstm_cell_pair(jsk, d)
        step = jax.jit(lambda p, c, xx, cell=cell: cell.apply({"params": p}, c, xx))
        carry = (jnp.asarray(h0), jnp.asarray(c0), jnp.asarray(g0))
        state = (torch.from_numpy(h0), torch.from_numpy(c0), torch.from_numpy(g0))
        for _ in range(5):
            carry, _ = step(as_jax(params), carry, jnp.asarray(x))
            state = port(port.input_gates(torch.from_numpy(x)), *state)
        runs[d] = ([np.asarray(a) for a in carry], [s.detach().numpy() for s in state])
    for i, name in enumerate(("h", "c", "G")):
        if dtype is None:
            check(runs[None][1][i], runs[None][0][i], f"LSTM cell {name}")
        elif name != "G":  # G stays float32
            hold_spread(runs[dtype][1][i], runs[dtype][0][i], runs[None][0][i],
                        f"bf16 LSTM cell {name}")
            assert runs[dtype][1][i].dtype == np.float32, name


@pytest.mark.parametrize("arch,dtype", [("StaticGraphLSTM", None), ("StaticGraphLSTM", "bfloat16"),
                                        ("StaticGraphGRU", None), ("StaticGraphGRU", "bfloat16")])
def test_two_layer_sequence_matches_flax(sk_pair, arch, dtype):
    """A two-layer graph-RNN over 6 frames from given initial carries: the
    last layer's hidden state after the last frame and after frame 3."""
    jsk, sk = sk_pair
    rng = np.random.default_rng(5)
    T = 6
    x = rng.standard_normal((T, N, B, F_IN), dtype=np.float32)
    h0 = 0.5 * rng.standard_normal((N, B, H), dtype=np.float32)
    c0 = 0.5 * rng.standard_normal((N, B, H), dtype=np.float32)
    is_lstm = arch == "StaticGraphLSTM"
    jcls = jgru.StaticGraphLSTM if is_lstm else jgru.StaticGraphGRU
    states = ([(jnp.asarray(h0), jnp.asarray(c0), None)] * 2 if is_lstm
              else [(jnp.asarray(h0), None)] * 2)
    params = None
    runs = {}
    for d in (None, dtype) if dtype else (None,):
        rnn = jcls(input_size=F_IN, hidden_size=H, num_nodes=N, num_layers=2,
                   node_types=jsk.nodes_type_id, learn_influence=True, node_major=True,
                   compute_dtype=d)
        if params is None:  # one set of weights for both dtypes
            params = numpy_tree(rnn.init(jax.random.key(2), jnp.asarray(x), states))["params"]
            params = spread_params(perturb_influence(params, rng), rng)
        y, _ = jax.jit(lambda p, xx, s, rnn=rnn: rnn.apply({"params": p}, xx, s))(
            as_jax(params), jnp.asarray(x), states)
        pcls = graph_gru.StaticGraphLSTM if is_lstm else graph_gru.StaticGraphGRU
        port = pcls(F_IN, H, N, torch.Generator().manual_seed(1), sk.nodes_type_id, num_layers=2,
                    compute_dtype=TORCH_DTYPES[d])
        port.load_state_dict(flatten_params(params), strict=True)
        carries = [torch.from_numpy(h0)] + ([torch.from_numpy(c0)] if is_lstm else [])
        with torch.no_grad():
            got = [port(torch.from_numpy(x), *carries, last_index=i).numpy() for i in (None, 3)]
        runs[d] = ([np.asarray(y[-1]), np.asarray(y[3])], got)
    for i, at in enumerate(("last frame", "frame 3")):
        if dtype is None:
            check(runs[None][1][i], runs[None][0][i], f"{arch} two layers, {at}")
        else:
            hold_spread(runs[dtype][1][i], runs[dtype][0][i], runs[None][0][i],
                        f"bf16 {arch} two layers, {at}")


# ---- DynamicGraphLinear and gmm ---------------------------------------------------


@pytest.mark.parametrize("by", ["g", "t"])
def test_dynamic_graph_linear_matches_flax(by):
    rng = np.random.default_rng(6)
    max_nodes, n = 12, 7
    x = rng.standard_normal((B, n, F_IN), dtype=np.float32)
    t = rng.permutation(max_nodes)[:n]
    g = rng.random((n, n), dtype=np.float32)
    mod = jglin.DynamicGraphLinear(in_features=F_IN, out_features=H, max_nodes=max_nodes)
    params = numpy_tree(mod.init(jax.random.key(0), jnp.asarray(x), g=jnp.asarray(g)))["params"]
    params["G"] = params["G"] + rng.random(params["G"].shape, dtype=np.float32)
    port = graph_linear.DynamicGraphLinear(F_IN, H, max_nodes, torch.Generator().manual_seed(0))
    port.load_state_dict(flatten_params(params), strict=True)
    kw = {"g": g} if by == "g" else {"t": t}
    want = mod.apply({"params": as_jax(params)}, jnp.asarray(x),
                     **{k: jnp.asarray(v) for k, v in kw.items()})
    got = port(torch.from_numpy(x), **{k: torch.from_numpy(v) for k, v in kw.items()})
    assert got.shape == (B, n, H)
    check(got.detach().numpy(), want, f"DynamicGraphLinear by {by}")
    with pytest.raises(ValueError, match="Either Graph Influence Matrix"):
        port(torch.from_numpy(x))


def test_gmm_matches_flax():
    rng = np.random.default_rng(7)
    x = rng.standard_normal((B, N, F_IN), dtype=np.float32)
    w = rng.standard_normal((N, F_IN, H), dtype=np.float32)
    check(graph_linear.gmm(torch.from_numpy(x), torch.from_numpy(w)).numpy(),
          jglin.gmm(jnp.asarray(x), jnp.asarray(w)), "gmm")


# ---- the AutoEncoder variants --------------------------------------------------


def ae_pair(jsk, sk, variant: dict, dtype=None, seed=3):
    """The flax AutoEncoder of ``variant`` and the port's with the same
    weights (influences moved off their init, banks spread)."""
    rng = np.random.default_rng(seed)
    jae = JaxAutoEncoder(num_nodes=jsk.num_nodes, encoder_hidden_size=HIDDEN,
                         decoder_hidden_size=HIDDEN, latent_size=LATENT,
                         node_types=jsk.nodes_type_id, compute_dtype=dtype, **variant)
    params = jae.init(jax.random.key(seed), jnp.zeros((1, PRED_LEN, N, 3)),
                      jnp.zeros((1, OBS_LEN, N, 3)), ph=PRED_LEN,
                      method=JaxAutoEncoder.autoencode)
    params = {"params": spread_params(perturb_influence(numpy_tree(params)["params"], rng), rng)}
    ae = AutoEncoder(sk.num_nodes, HIDDEN, HIDDEN, LATENT, torch.Generator().manual_seed(9),
                     node_types=sk.nodes_type_id, compute_dtype=TORCH_DTYPES[dtype], **variant)
    load_autoencoder_params(ae, params)
    return jae, params, ae


def ae_outputs(jae, params, ae, obs, fut, ph):
    """(flax, port) × (past embedding, the encoder at ph − 1, the plain
    decode of ph frames)."""
    jp = as_jax(params)
    apply = jax.jit(jae.apply, static_argnames=("method", "ph"))
    j = [apply(jp, jnp.asarray(obs), method=JaxAutoEncoder.get_past_embedding),
         apply(jp, jnp.asarray(fut), last_index=ph - 1, method=JaxAutoEncoder.encode)]
    z = j[1]
    j.append(apply(jp, jnp.asarray(obs), z, z, ph=ph, method=JaxAutoEncoder.decode))
    with torch.no_grad():
        p = [ae.get_past_embedding(torch.from_numpy(obs)),
             ae.encode(torch.from_numpy(fut), last_index=ph - 1)]
        p.append(ae.decode(torch.from_numpy(obs), torch.from_numpy(np.asarray(z)), ph))
    return [np.asarray(a) for a in j], [a.float().numpy() for a in p]


@pytest.fixture(scope="module")
def variant_runs(sk_pair):
    """(flax, port) outputs of ``ae_outputs`` for (variant, dtype), each
    computed once."""
    jsk, sk = sk_pair
    rng = np.random.default_rng(11)
    obs = 0.3 * rng.standard_normal((B, OBS_LEN, N, 3), dtype=np.float32)
    fut = 0.3 * rng.standard_normal((B, PRED_LEN, N, 3), dtype=np.float32)
    cache = {}

    def runs(name, dtype):
        if (name, dtype) not in cache:
            cache[name, dtype] = ae_outputs(*ae_pair(jsk, sk, VARIANTS[name], dtype), obs, fut,
                                            PRED_LEN - 3)
        return cache[name, dtype]

    return runs


@pytest.mark.parametrize("name", list(VARIANTS))
@pytest.mark.parametrize("dtype", [None, "bfloat16"])
def test_autoencoder_variant_matches_flax(variant_runs, name, dtype):
    runs = {d: variant_runs(name, d) for d in ((None, dtype) if dtype else (None,))}
    for i, what in enumerate(("past embedding", "encode at ph - 1", "decode")):
        if dtype is None:
            check(runs[None][1][i], runs[None][0][i], f"{name}: {what}")
        else:
            hold_spread(runs[dtype][1][i], runs[dtype][0][i], runs[None][0][i],
                        f"{name} bf16: {what}")


def test_cli_builds_every_variant_and_the_reference_loader_reads_it(sk_pair):
    """``build_autoencoder`` takes every variant's keys (the guard is gone);
    the reference-named loader carries a two-layer LSTM encoder and an LSTM
    decoder across (no ``bias_ih`` for the LSTM cells)."""
    _, sk = sk_pair
    for variant in VARIANTS.values():
        arch = dict(encoder_hidden_size=HIDDEN, decoder_hidden_size=HIDDEN, arch="AutoEncoder")
        arch.update({k: v for k, v in variant.items() if k != "z_activation"})
        cfg = dict(autoenc_arch=arch, latent_size=LATENT,
                   z_activation=variant.get("z_activation", "tanh"))
        ae = build_autoencoder(cfg, sk, torch.Generator().manual_seed(0))
        assert ae.z_activation == cfg["z_activation"]
        assert ae.encoder.rnn.num_layers == arch.get("enc_num_layers", 1)
    variant = dict(recurrent_arch_enc="StaticGraphLSTM", recurrent_arch_decoder="StaticGraphLSTM",
                   enc_num_layers=2)
    src = AutoEncoder(sk.num_nodes, HIDDEN, HIDDEN, LATENT, torch.Generator().manual_seed(1),
                      node_types=sk.nodes_type_id, **variant)
    # the reference's naming: banks [types, gates·H, in], G on the layers,
    # an unused bias_ih on the LSTM cells
    sd = {}
    for prefix, mod in (("encoder.initial_hidden1", src.encoder.initial_hidden1),
                        ("encoder.initial_hidden_c", src.encoder.initial_hidden_c),
                        ("encoder.fc", src.encoder.fc),
                        ("decoder.initial_hidden_h", src.decoder.initial_hidden_h),
                        ("decoder.initial_hidden_c", src.decoder.initial_hidden_c),
                        ("decoder.fc", src.decoder.rollout.fc)):
        sd[f"{prefix}.weight"] = mod.weight.detach().numpy().swapaxes(-1, -2)
        sd[f"{prefix}.bias"] = mod.bias.detach().numpy()
        sd[f"{prefix}.G"] = mod.G.detach().numpy()
    cells = [(f"encoder.rnn.layers.{i}", getattr(src.encoder.rnn, f"cell{i}"),
              getattr(src.encoder.rnn, f"G{i}")) for i in range(2)]
    cells.append(("decoder.rnn.layers.0", src.decoder.rollout.cell, src.decoder.G0))
    for prefix, cell, g in cells:
        for name in ("weight_ih", "weight_hh"):
            sd[f"{prefix}.{name}"] = getattr(cell, name).detach().numpy().swapaxes(-1, -2)
        sd[f"{prefix}.bias_hh"] = cell.bias_hh.detach().numpy()
        sd[f"{prefix}.bias_ih"] = np.zeros_like(sd[f"{prefix}.bias_hh"])
        sd[f"{prefix}.G"] = g.detach().numpy()
        if cell.G_add is not None:
            sd[f"{prefix}.G_add"] = cell.G_add.detach().numpy()
    dst = AutoEncoder(sk.num_nodes, HIDDEN, HIDDEN, LATENT, torch.Generator().manual_seed(2),
                      node_types=sk.nodes_type_id, **variant)
    load_reference_autoencoder(dst, sd)
    for (name, a), (_, b) in zip(src.state_dict().items(), dst.state_dict().items()):
        assert torch.equal(a, b), name


# ---- training and prediction -------------------------------------------------------


def test_lstm_stage1_step_matches_the_jax_trainer(sk_pair):
    """One fp32 stage-1 step of the LSTM AutoEncoder: the port's loss
    (truncated encode and decode) and gradient norm against the JAX
    trainer's jitted step (full-horizon decode, the loss masked to ph)."""
    from skeletondiffusion_tpu.train.trainer_autoencoder import AutoEncoderTrainer as JaxTrainer

    jsk, sk = sk_pair
    jae, params, ae = ae_pair(jsk, sk, VARIANTS["lstm"])
    rng = np.random.default_rng(12)
    x = 0.3 * rng.standard_normal((B, OBS_LEN, N, 3), dtype=np.float32)
    y = 0.3 * rng.standard_normal((B, PRED_LEN, N, 3), dtype=np.float32)
    lr, ph = 5e-3, 7
    jtr = JaxTrainer(model=jae, lr=lr, iter_per_epoch=1, prediction_horizon_train=PRED_LEN,
                     prediction_horizon_eval=PRED_LEN)
    state = jtr.init(jax.random.key(0), jnp.asarray(x), jnp.asarray(y))
    jparams = as_jax(params)
    state = state._replace(params=jparams, opt_state=jtr.tx.init(jparams))
    _, jloss, jgnorm = jtr._jit_step(state, jax.random.key(0), jnp.asarray(x), jnp.asarray(y),
                                     jnp.asarray(ph, jnp.int32), jnp.asarray(lr, jnp.float32))
    tr = AutoEncoderTrainer(ae, lr=lr, iter_per_epoch=1, prediction_horizon_train=PRED_LEN,
                            prediction_horizon_eval=PRED_LEN)
    loss = tr.loss(torch.from_numpy(x), torch.from_numpy(y), ph)
    gnorm = tr.optimizer_step(loss)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=0, atol=1e-4)
    np.testing.assert_allclose(float(gnorm), float(jgnorm), rtol=1e-3)
    # validation decodes the LSTM decoder with its step loop, not the kernel
    with torch.no_grad():
        pred, *_ = tr.validation_step((torch.from_numpy(x), torch.from_numpy(y)))
    assert pred.shape == (B, PRED_LEN, N, 3) and bool(torch.isfinite(pred).all())


@pytest.fixture(scope="module")
def lstm_predictor_pair(sk_pair):
    """The JAX models with an LSTM AutoEncoder and the port's, same weights."""
    jsk, sk = sk_pair
    _, gru_params, jengine, _, den_params = jax_models(jsk, seed=3)
    _, engine, _ = port_models(sk, gru_params, den_params)
    jae, ae_params, ae = ae_pair(jsk, sk, VARIANTS["lstm"])
    return dict(jsk=jsk, sk=sk, jae=jae, ae_params=ae_params, jengine=jengine,
                den_params=den_params, ae=ae, engine=engine)


def test_lstm_predictor_matches_jax(lstm_predictor_pair):
    """The predictor with an LSTM decoder against the JAX predictor, end to
    end with injected noise: the plain decode by default, no K1 launch."""
    from skeletondiffusion_tpu.eval_pipeline import (
        SkeletonDiffusionPredictor as JaxPredictor,
    )

    m = lstm_predictor_pair
    S = 3
    rng = np.random.default_rng(13)
    obs = 0.3 * rng.standard_normal((B, OBS_LEN, N, 3), dtype=np.float32)
    start = rng.standard_normal((B * S, N, LATENT), dtype=np.float32)
    steps = rng.standard_normal((B * S, TIMESTEPS - 1, N, LATENT), dtype=np.float32)
    jpred = JaxPredictor(m["jsk"], m["jae"], as_jax(m["ae_params"]), m["jengine"],
                         as_jax(m["den_params"]), num_samples=S, pred_length=PRED_LEN)
    assert not jpred.use_fused_decode
    want, want_lat = jpred(jax.random.key(0), jnp.asarray(obs), start_noise=jnp.asarray(start),
                           step_noise=jnp.asarray(steps))
    pred = SkeletonDiffusionPredictor(m["sk"], m["ae"], m["engine"], num_samples=S,
                                      pred_length=PRED_LEN, device="cpu")
    assert not pred.use_fused_decode
    launches = gru_rollout.launches
    got, got_lat = pred(None, torch.from_numpy(obs), start_noise=torch.from_numpy(start),
                        step_noise=torch.from_numpy(steps))
    assert gru_rollout.launches == launches
    check(got_lat.numpy(), want_lat, "latents", atol=1e-4)
    check(got.numpy(), want, "predictions", atol=1e-4)


def test_fused_decode_refuses_an_lstm_decoder(lstm_predictor_pair):
    """``use_fused_decode=True`` with an LSTM decoder raises, and so do the
    decoder's kernel decode (``Decoder.forward``) and ``decode_rollout``; it
    is not made plain."""
    m = lstm_predictor_pair
    with pytest.raises(ValueError, match="LSTM"):
        SkeletonDiffusionPredictor(m["sk"], m["ae"], m["engine"], num_samples=2,
                                   pred_length=PRED_LEN, use_fused_decode=True, device="cpu")
    x = torch.zeros((2, OBS_LEN, N, 3))
    z = torch.zeros((2, N, LATENT))
    with torch.no_grad(), pytest.raises(ValueError, match="LSTM"):
        m["ae"].decoder(x, z, 4)
    with torch.no_grad(), pytest.raises(ValueError, match="LSTM"):
        gru_rollout.decode_rollout(m["ae"].decoder, x[:, -2:], z, 4)
    # a GRU decoder keeps K1 by default
    sk = m["sk"]
    gru = AutoEncoder(sk.num_nodes, HIDDEN, HIDDEN, LATENT, torch.Generator().manual_seed(0),
                      node_types=sk.nodes_type_id)
    assert gru.decodes_on_kernel and not m["ae"].decodes_on_kernel
