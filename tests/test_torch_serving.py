"""The port's serving export (``skeletondiffusion_tpu_torch/serving.py``) on
the CPU: the artifact of torch_parity's small AMASS model (21 nodes, latent
and hidden 16, depth 1, 4 steps), loaded back, held against the JAX
package's ``SkeletonDiffusionPredictor._predict`` with injected noise (fp32
at 1e-4; the bf16 chain within ``BF16_SPREAD`` of the JAX predictor's own
bf16-vs-fp32 deviation), bit for bit against the live port predictor for
one generator seed, its programs' kernel ops, the bucket routing and
refusals of the JAX ``ServingModel``, and a load in a fresh process that
imports no model class."""
import json
import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skeletondiffusion_tpu.eval_pipeline import SkeletonDiffusionPredictor as JaxPredictor
from skeletondiffusion_tpu_torch import serving
from skeletondiffusion_tpu_torch.eval_pipeline import SkeletonDiffusionPredictor
from skeletondiffusion_tpu_torch.parallel import DataMesh
from torch_parity import (BF16_SPREAD, OBS_LEN, PRED_LEN, TIMESTEPS, as_jax, jax_models,
                          port_models, skeletons)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
S = 3
BUCKETS = {None: [4], "bfloat16": [2, 4]}
CHAIN_OPS = {"graph_linear_fused", "resnet_block", "rms_qkv", "attention_core", "outproj_res",
             "final_block_in", "final_block_out", "posterior_step", "gru_rollout"}
LAYER_OPS = {"stem_block", "rms_qkv_core", "outproj_block", "final_block_in", "final_block_out",
             "posterior_step", "gru_rollout"}


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """{dtype: dict(jax predictor, live port predictor, artifact dir, loaded
    ServingModel)} for fp32 (None) and bf16, the same weights (seed 0,
    spread denoiser weights)."""
    jsk, sk = skeletons()
    out = {}
    for dtype in (None, "bfloat16"):
        jae, ae_params, jengine, _, den_params = jax_models(jsk, compute_dtype=dtype,
                                                            spread=True)
        ae, engine, _ = port_models(sk, ae_params, den_params, compute_dtype=dtype)
        live = SkeletonDiffusionPredictor(sk, ae, engine, num_samples=S, pred_length=PRED_LEN,
                                          device="cpu")
        art = str(tmp_path_factory.mktemp(f"artifact_{dtype}"))
        serving.export_predictor(live, art, BUCKETS[dtype])
        out[dtype] = dict(jax=JaxPredictor(jsk, jae, as_jax(ae_params), jengine,
                                           as_jax(den_params), num_samples=S,
                                           pred_length=PRED_LEN),
                          live=live, dir=art, model=serving.ServingModel(art, device="cpu"),
                          sk=sk)
    return out


def _inputs(batch: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    obs = 0.3 * rng.standard_normal((batch, OBS_LEN, 21, 3), dtype=np.float32)
    start = rng.standard_normal((batch * S, 21, 16), dtype=np.float32)
    steps = rng.standard_normal((batch * S, TIMESTEPS - 1, 21, 16), dtype=np.float32)
    return obs, start, steps


def _served_and_jax(served, dtype, inputs):
    obs, start, steps = inputs
    m = served[dtype]
    got = m["model"](None, torch.from_numpy(obs), start_noise=torch.from_numpy(start),
                     step_noise=torch.from_numpy(steps)).numpy()
    want, _ = m["jax"](jax.random.key(0), jnp.asarray(obs), start_noise=jnp.asarray(start),
                       step_noise=jnp.asarray(steps))
    return got, np.asarray(want)


def test_manifest_records_the_path(served):
    for dtype, path in ((None, "fp32"), ("bfloat16", "bf16 chain")):
        m = served[dtype]["model"].manifest
        assert m["path"] == path and m["device"] == "cpu" and m["nodes"] == 21
        assert m["batch_sizes"] == BUCKETS[dtype] and m["num_samples"] == S
        assert m["obs_tail_shape"] == [OBS_LEN, 21, 3] and m["noise_draws"] == TIMESTEPS - 1
        assert m["fused_denoiser"] == (dtype == "bfloat16") and m["fused_decode"]
        assert m["weights_baked_in_program"] and m["mesh"] is None and not m["layer_fused"]


def test_fp32_artifact_holds_the_jax_predictor(served):
    got, want = _served_and_jax(served, None, _inputs(4))
    assert got.shape == (4, S, PRED_LEN, 21, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_bf16_artifact_within_the_jax_predictors_spread(served):
    """The served bf16 chain is as close to the JAX fp32 predictor as the JAX
    bf16 predictor is, and no farther from the JAX bf16 predictor than the
    bf16 rounding noise (``torch_parity.hold_bf16_predictor``'s ratios)."""
    inputs = _inputs(4, seed=1)
    got, jax_bf16 = _served_and_jax(served, "bfloat16", inputs)
    _, jax_fp32 = _served_and_jax(served, None, inputs)
    jax_err = np.abs(jax_bf16 - jax_fp32)
    port_err = np.abs(got - jax_fp32)
    assert port_err.max() / jax_err.max() <= BF16_SPREAD
    assert port_err.mean() / jax_err.mean() <= BF16_SPREAD
    assert np.abs(got - jax_bf16).mean() / jax_err.mean() <= BF16_SPREAD


@pytest.mark.parametrize("dtype", [None, "bfloat16"], ids=["fp32", "bf16"])
def test_artifact_equals_the_live_predictor_for_a_generator_state(served, dtype):
    """The noise is drawn in the live sampler's order: one seed gives the
    live predictor's samples bit for bit, another seed other samples."""
    m = served[dtype]
    obs = torch.from_numpy(_inputs(4, seed=2)[0])
    got = m["model"](torch.Generator().manual_seed(5), obs)
    want, _ = m["live"](torch.Generator().manual_seed(5), obs)
    assert torch.equal(got, want)
    other = m["model"](torch.Generator().manual_seed(6), obs)
    assert not torch.allclose(other, got)


def _kernel_ops(artifact: str, bucket: int) -> dict:
    program = torch.export.load(os.path.join(artifact, serving.program_file(bucket)))
    ops = {}
    for node in program.graph.nodes:
        name = str(node.target)
        if name.startswith("skd."):
            key = name.split(".")[1]
            ops[key] = ops.get(key, 0) + 1
    return ops


def test_programs_call_the_kernel_ops(served, tmp_path, monkeypatch):
    """Each kernel of the path is one ``skd::`` node a launch: K2 a step and
    K1 once; the bf16 chain's B4, B1, B3a, B2, B3b, B5a and B5b, or with
    SKELDIFF_LAYER_FUSED=1 at export B9a–c."""
    assert _kernel_ops(served[None]["dir"], 4) == {"posterior_step": TIMESTEPS, "gru_rollout": 1}
    chain = _kernel_ops(served["bfloat16"]["dir"], 2)
    assert set(chain) == CHAIN_OPS
    # depth 1: two blocks and one attention layer a step
    assert chain["resnet_block"] == 2 * TIMESTEPS and chain["attention_core"] == TIMESTEPS
    monkeypatch.setenv("SKELDIFF_LAYER_FUSED", "1")
    serving.export_predictor(served["bfloat16"]["live"], str(tmp_path), 2)
    assert json.load(open(tmp_path / serving.MANIFEST_FILE))["path"] == "bf16 layer-fused"
    layer = _kernel_ops(str(tmp_path), 2)
    assert set(layer) == LAYER_OPS and layer["stem_block"] == TIMESTEPS


def test_requests_route_to_the_smallest_bucket_and_drop_the_pad_rows(served):
    """A request of 3 runs the bucket of 4 with the last observation (and
    its noise) repeated, and returns 3 rows: the bucket's first 3."""
    model = served["bfloat16"]["model"]
    obs, start, steps = (torch.from_numpy(a) for a in _inputs(4, seed=3))
    noise = dict(start_noise=start, step_noise=steps)
    padded = torch.cat([obs[:3], obs[2:3]])
    pad = {k: torch.cat([v[:3 * S], v[3 * S - 1:3 * S].expand(S, *v.shape[1:])])
           for k, v in noise.items()}
    got = model(None, obs[:3], start_noise=start[:3 * S], step_noise=steps[:3 * S])
    assert torch.equal(got, model(None, padded, **pad)[:3])
    with pytest.raises(ValueError, match="start_noise of shape"):
        model(None, obs[:3], start_noise=start, step_noise=steps)
    for batch in (1, 2):  # the bucket of 2
        out = model(torch.Generator().manual_seed(0), obs[:batch])
        assert out.shape == (batch, S, PRED_LEN, 21, 3) and torch.isfinite(out).all()


@pytest.mark.parametrize("shape, match", [
    ((2, OBS_LEN, 20, 3), "obs tail"),
    ((0, OBS_LEN, 21, 3), "empty request"),
    ((5, OBS_LEN, 21, 3), "exceeds largest exported bucket 4"),
], ids=["tail", "empty", "oversize"])
def test_bad_requests_raise_value_error(served, shape, match):
    with pytest.raises(ValueError, match=match):
        served["bfloat16"]["model"](torch.Generator(), torch.zeros(shape))


def test_artifact_refuses_another_device_node_count_or_data_axis(served, tmp_path):
    art = served[None]["dir"]
    with pytest.raises(ValueError, match="exported for 21 nodes, not 16"):
        serving.ServingModel(art, device="cpu", nodes=16)
    with pytest.raises(ValueError, match="data axis"):
        serving.ServingModel(art, device="cpu", mesh=DataMesh(2, 0, torch.device("cpu")))
    copy = tmp_path / "copy"
    shutil.copytree(art, copy)
    manifest = json.load(open(copy / serving.MANIFEST_FILE))
    json.dump({**manifest, "device": "cuda"}, open(copy / serving.MANIFEST_FILE, "w"))
    with pytest.raises(ValueError, match="exported for cuda, not cpu"):
        serving.ServingModel(str(copy), device="cpu")


def test_a_data_axis_serves_each_ranks_rows(served, tmp_path):
    """Exported over a data axis of two, each bucket is a program of half
    its rows; each rank draws the whole request's noise from the same
    generator state, serves its rows (the pad rows dropped), and the ranks'
    rows together are the live prediction (BLAS at another row count: 1e-6)."""
    live = served["bfloat16"]["live"]
    art = str(tmp_path / "axis")
    serving.export_predictor(live, art, [4], mesh=DataMesh(2, 0, torch.device("cpu")))
    assert json.load(open(tmp_path / "axis" / serving.MANIFEST_FILE))["mesh"] == {"data": 2}
    obs = torch.from_numpy(_inputs(3, seed=5)[0])
    rows = [serving.ServingModel(art, device="cpu", mesh=DataMesh(2, r, torch.device("cpu")))(
        torch.Generator().manual_seed(7), obs) for r in range(2)]
    assert [r.shape[0] for r in rows] == [2, 1]
    want, _ = live(torch.Generator().manual_seed(7), obs)
    torch.testing.assert_close(torch.cat(rows), want, rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="does not split over the data axis of 2"):
        serving.export_predictor(live, art, [3], mesh=DataMesh(2, 0, torch.device("cpu")))


LOAD = """
import sys, torch
from skeletondiffusion_tpu_torch.serving import ServingModel
model = ServingModel(sys.argv[1], device="cpu")
obs = torch.load(sys.argv[2])
torch.save(model(torch.Generator().manual_seed(5), obs), sys.argv[3])
absent = [m for m in ("models", "diffusion", "eval_pipeline")
          if f"skeletondiffusion_tpu_torch.{m}" in sys.modules]
assert not absent, absent
assert not any(m.split(".")[0] in ("jax", "skeletondiffusion_tpu") for m in sys.modules)
print("served")
"""


def test_a_fresh_process_serves_without_the_model_classes(served, tmp_path):
    m = served["bfloat16"]
    obs = torch.from_numpy(_inputs(4, seed=4)[0])
    torch.save(obs, tmp_path / "obs.pt")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", LOAD, m["dir"], str(tmp_path / "obs.pt"),
                          str(tmp_path / "pred.pt")], cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("served")
    want, _ = m["live"](torch.Generator().manual_seed(5), obs)
    assert torch.equal(torch.load(tmp_path / "pred.pt"), want)
