"""B8 and L1 at every skeleton's node count on the CPU (16 for H36M, 17 for
FreeMan, 51 for AMASS-MANO; 21 in ``test_torch_decode_bf16.py``), against
the JAX package's Pallas kernels in interpret mode, and their plans.

* B8's plain version (``gru_rollout_merged_plain``) against
  ``gru_rollout_pallas(compute_dtype="bfloat16")`` and the port's
  ``decode_rollout(compute_dtype=torch.bfloat16)`` against the JAX
  ``decode_rollout`` on a flax AutoEncoder of the skeleton carried through
  the weight bridge: the bf16 criteria (``assert_bf16_close``) and a mean
  deviation within ``MEAN_SHARE`` of the Pallas merged kernel's own from its
  fp32 kernel, as ``test_torch_decode_bf16.py`` holds them at 21 nodes.
* L1's plain version against ``scripts/attn_core_lab.py::core_fm`` in
  interpret mode: fp32 at atol 2e-5, bf16 by the bf16 criteria.
* The plans of both kernels fit every count and refuse more than 51 nodes.

Size: one batch tile of 128 rows (the Pallas kernels' grid is one step),
hidden 16, 8 steps; L1 2 heads × 32.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skeletondiffusion_tpu.models import AutoEncoder as JaxAutoEncoder
from skeletondiffusion_tpu.ops.pallas.gru_rollout import decode_rollout as jax_decode_rollout
from skeletondiffusion_tpu.ops.pallas.gru_rollout import gru_rollout_pallas
from skeletondiffusion_tpu_torch.models import AutoEncoder
from skeletondiffusion_tpu_torch.ops.graph_linear import l1_normalize_rows
from skeletondiffusion_tpu_torch.ops.kernels import attention_core_fm as fm_mod
from skeletondiffusion_tpu_torch.ops.kernels import build, node_mix_sm90
from skeletondiffusion_tpu_torch.ops.kernels import gru_rollout as rollout_mod
from skeletondiffusion_tpu_torch.weights import load_autoencoder_params

from test_torch_decode_bf16 import _hold_merged
from torch_parity import assert_bf16_close, load_script, perturb_influence, skeletons_of

# (dataset, joints) of each count: the hip dropped
COUNTS = {16: ("h36m", 17), 17: ("freeman", 18), 51: ("amass-mano", 52)}
ROWS, PH, HIDDEN, LATENT = 128, 8, 16, 16
counts = pytest.mark.parametrize("nodes", sorted(COUNTS))


def _skeletons(nodes: int):
    dataset, joints = COUNTS[nodes]
    jsk, sk = skeletons_of(dataset, joints, pred=PH)
    assert sk.num_nodes == jsk.num_nodes == nodes
    return jsk, sk


def _rollout_inputs(rng, node_types, n, b=ROWS, h=HIDDEN, f=3):
    types = np.asarray(node_types)
    n_types = int(types.max()) + 1
    bank = lambda *s: (0.3 * rng.standard_normal((n_types, *s), dtype=np.float32))[types]  # noqa
    norm = lambda g: l1_normalize_rows(torch.from_numpy(g)).numpy()  # noqa: E731
    return dict(
        cx=rng.standard_normal((n, b, 3 * h), dtype=np.float32),
        h0=0.5 * rng.standard_normal((n, b, h), dtype=np.float32),
        w_hh=bank(h, 3 * h), b_hh=bank(3 * h),
        g0=norm(np.eye(n, dtype=np.float32) + 0.2 * rng.random((n, n), dtype=np.float32)),
        g_add=0.05 * (rng.random((n, n), dtype=np.float32) - 0.5),
        w_fc=bank(h, f), b_fc=bank(f),
        g_fc=norm(np.eye(n, dtype=np.float32) + 0.2 * rng.random((n, n), dtype=np.float32)),
    )


@counts
def test_merged_rollout_plain_matches_pallas(nodes):
    _, sk = _skeletons(nodes)
    inp = _rollout_inputs(np.random.default_rng(nodes), sk.nodes_type_id, nodes)
    jin = {k: jnp.asarray(v) for k, v in inp.items()}
    want = gru_rollout_pallas(**jin, ph=PH, batch_tile=ROWS, compute_dtype="bfloat16",
                              interpret=True)
    want_f32 = gru_rollout_pallas(**jin, ph=PH, batch_tile=ROWS, interpret=True)
    got = rollout_mod.gru_rollout(**{k: torch.from_numpy(v) for k, v in inp.items()}, ph=PH,
                                  compute_dtype=torch.bfloat16)
    assert got.shape == want.shape == (PH, nodes, ROWS, 3) and got.dtype == torch.float32
    _hold_merged(got.numpy(), want, want_f32, f"rollout at {nodes} nodes")


@counts
def test_bf16_decode_rollout_matches_jax(nodes):
    """A flax AutoEncoder of the skeleton (influences moved off their init)
    and the port's with its weights: the port's bf16 decode against the JAX
    bf16 decode, within MEAN_SHARE of the JAX decodes' own bf16-vs-fp32
    deviation; the fp32 decodes at 1e-5."""
    jsk, sk = _skeletons(nodes)
    jae = JaxAutoEncoder(num_nodes=nodes, encoder_hidden_size=HIDDEN, decoder_hidden_size=HIDDEN,
                         latent_size=LATENT, node_types=jsk.nodes_type_id)
    params = jae.init(jax.random.key(nodes), jnp.zeros((1, PH, nodes, 3)),
                      jnp.zeros((1, 4, nodes, 3)), ph=PH, method=JaxAutoEncoder.autoencode)
    params = perturb_influence(jax.device_get(params), np.random.default_rng(nodes))
    ae = AutoEncoder(nodes, HIDDEN, HIDDEN, LATENT, torch.Generator().manual_seed(0),
                     node_types=sk.nodes_type_id)
    load_autoencoder_params(ae, params)
    rng = np.random.default_rng(nodes + 1)
    x_last2 = 0.2 * rng.standard_normal((ROWS, 2, nodes, 3), dtype=np.float32)
    z = rng.standard_normal((ROWS, nodes, LATENT), dtype=np.float32)
    dec = jax.tree_util.tree_map(jnp.asarray, params)["params"]["decoder"]
    want = {dt: np.asarray(jax_decode_rollout(dec, jsk.nodes_type_id, jnp.asarray(x_last2),
                                              jnp.asarray(z), PH, batch_tile=ROWS,
                                              compute_dtype=dt, interpret=True))
            for dt in (None, "bfloat16")}
    with torch.no_grad():
        got = {dt: rollout_mod.decode_rollout(ae.decoder, torch.from_numpy(x_last2),
                                              torch.from_numpy(z), PH, compute_dtype=dt).numpy()
               for dt in (None, torch.bfloat16)}
    assert got[torch.bfloat16].shape == (ROWS, PH, nodes, 3)
    np.testing.assert_allclose(got[None], want[None], rtol=0, atol=1e-5)
    _hold_merged(got[torch.bfloat16], want["bfloat16"], want[None], f"decode at {nodes} nodes")


@pytest.fixture(scope="module")
def lab():
    return load_script("attn_core_lab")


@counts
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_core_fm_plain_matches_pallas(lab, nodes, dtype):
    heads, dh = 2, 32
    x = 0.5 * np.random.default_rng(nodes).standard_normal((nodes, 3 * heads * dh, ROWS),
                                                           dtype=np.float32)
    jx = jnp.asarray(x).astype(dtype)
    want = np.asarray(lab.core_fm(jx, heads=heads, dim_head=dh, interpret=True), np.float32)
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(getattr(torch, dtype))
    got = fm_mod.attention_core_fm(tx, heads=heads, dim_head=dh)
    assert got.shape == (nodes, heads * dh, ROWS) and got.dtype == tx.dtype
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-5)
    else:
        assert_bf16_close(got.float().numpy(), want, f"core_fm at {nodes} nodes")


# ---- the plans -----------------------------------------------------------------

# B8: (rows, slice, stages, cluster, shared memory) up to 21 nodes the
# 21-node design's tiles over ⌈N/8⌉ node tiles, past it the second design's
# 4 rows, no ring; L1: (columns, stages, shared memory) in bf16 and fp32
PLANS = {
    16: ((8, 16, 2, 2, 168320), (16, 3, 217472), (8, 3, 215424)),
    17: ((8, 16, 2, 2, 201968), (16, 3, 231168), (8, 3, 228992)),
    21: ((8, 16, 2, 2, 232112), (16, 2, 220928), (8, 2, 218240)),
    51: ((4, 0, 0, 2, 219504), (8, 1, 190336), (4, 1, 187008)),
}


@pytest.mark.parametrize("nodes", sorted(PLANS))
def test_plans_fit_every_count(nodes):
    b8, fm16, fm32 = PLANS[nodes]
    assert tuple(rollout_mod.rollout_bf16_plan(nodes, 96, 3)) == b8
    assert tuple(fm_mod.fm_plan(torch.bfloat16, 8, 32, nodes)) == fm16
    assert tuple(fm_mod.fm_plan(torch.float32, 8, 32, nodes)) == fm32
    assert max(b8[-1], fm16[-1], fm32[-1]) <= node_mix_sm90.MAX_SMEM
    # past 21 nodes B8's state: h fp32 [N][4][96], the step's hw3 bf16
    # [N][4][288], G_t and bf16(G_t) rows of 52, the head's outputs
    if build.wide(nodes):
        assert b8[-1] == 4 * nodes * 4 * 96 + 2 * nodes * 4 * 288 + 8 * nodes * 52 + 4 * nodes * 12


def test_plans_refuse_more_than_51_nodes():
    for plan in (lambda: rollout_mod.rollout_bf16_plan(52, 96, 3),
                 lambda: fm_mod.fm_plan(torch.bfloat16, 8, 32, 52)):
        with pytest.raises(ValueError, match="takes 2 to 51 nodes, got 52 .*Queue B item 9"):
            plan()
