"""The port's entry points on the CPU, at the size of ``tests/test_cli_end2end.py``
(observe 6, predict 12, a few iterations), held against the JAX CLIs.

* The eval CLI with ZeroVelocity: the JAX CLI's and the port's results on
  the same synthetic tree, and both results YAMLs read back.
* ``prepare_model``: a port experiment folder (``config.yaml`` and the
  port's checkpoints of flax weights carried through ``weights.py``) gives a
  predictor that meets the JAX ``SkeletonDiffusionPredictor`` of the same
  weights, with injected noise at 5e-5 (fp32); in bf16 it equals, bit for
  bit, the predictor of the modules that ``test_torch_fused.py`` holds
  against the JAX fused chain within ``BF16_SPREAD``.
* The training CLIs: their experiment folders, a run of 2 epochs resumed to
  3 against 3 straight (bit for bit: the state dicts, the optimizer, the
  EMA), the stage-2 config against JAX ``load_and_merge_autoenc_cfg``, and
  the eval CLI on the trained experiment against ``compute_metrics`` on its
  ``prepare_model``.
* ``InferenceSession`` against the JAX one on the carried weights.
* ``create_diffusion``: every key of ``DIFFUSION_CFG_KEYS`` is honoured with
  the JAX meaning or raises; ``remat_denoiser`` gives bit-identical
  gradients.
"""
import functools
import inspect
import json
import math
import os
import pathlib
import zipfile
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from skeletondiffusion_tpu.cli.common import build_skeleton as jax_build_skeleton
from skeletondiffusion_tpu.diffusion.manager import create_diffusion as jax_create_diffusion
from skeletondiffusion_tpu.eval_pipeline import (
    SkeletonDiffusionPredictor as JaxSkeletonDiffusionPredictor,
)
from skeletondiffusion_tpu.utils.config import flatten_config as jax_flatten
from skeletondiffusion_tpu.utils.config import load_and_merge_autoenc_cfg as jax_merge
from skeletondiffusion_tpu.utils.config import load_config as jax_load_config
from skeletondiffusion_tpu_torch.cli import eval as eval_cli
from skeletondiffusion_tpu_torch.cli import train_autoencoder, train_diffusion
from skeletondiffusion_tpu_torch.cli.common import DIFFUSION_CFG_KEYS, build_skeleton
from skeletondiffusion_tpu_torch.data import make_synthetic_amass
from skeletondiffusion_tpu_torch.diffusion.manager import create_diffusion
from skeletondiffusion_tpu_torch.eval_pipeline import compute_metrics
from skeletondiffusion_tpu_torch.inference import InferenceSession
from skeletondiffusion_tpu_torch.skeleton import create_skeleton
from skeletondiffusion_tpu_torch.train.checkpoint import CheckpointManager, load_host_state
from skeletondiffusion_tpu_torch.utils import yaml_lite
from skeletondiffusion_tpu_torch.utils.config import (
    flatten_config,
    load_and_merge_autoenc_cfg,
    load_config,
    save_config,
)
from skeletondiffusion_tpu_torch.weights import flatten_params
from torch_parity import WIDE, as_jax, jax_models, port_models, wide_model_pair

REPO = pathlib.Path(__file__).resolve().parents[1]
CONFIGS = REPO / "configs"
TASK = ["task.history_sec=0.1", "task.prediction_horizon_sec=0.2"]  # obs 6, pred 12 at 60 fps
OBS, PRED = 6, 12
LOADERS = ["dataset.data_loader_valid.datasets=[ACCAD]",
           "dataset.data_loader_train_eval.datasets=[CMU]",
           "dataset.data_loader_train.datasets=[ACCAD, CMU]",
           "dataset.data_loader_train.stride=4", "dataset.data_loader_train.augmentation=2"]
AE_ARGS = ["dataset=amass", "model.batch_size=4", "model.num_iter_perepoch=3",
           "model.latent_size=8", "model.autoenc_arch.encoder_hidden_size=8",
           "model.autoenc_arch.decoder_hidden_size=8", "model.curriculum_it=1",
           "model.save_frequency=2", "model.if_run_validation=True", "model.eval_frequency=1",
           "model.num_iteration_eval=1", "model.batch_size_eval=4",
           "model.lr_scheduler_kwargs.warmup_duration=1", "model.log_every_iters=1"]
DIFF_ARGS = ["model.batch_size=4", "model.num_iter_perepoch=3",
             "model.train_pick_best_sample_among_k=2", "model.diffusion_timesteps=4",
             "model.diffusion_arch.depth=1", "model.diffusion_arch.attn_heads=2",
             "model.diffusion_arch.attn_dim_head=4", "model.if_run_validation=True",
             "model.eval_frequency=1", "model.num_iteration_eval=1", "model.batch_size_eval=4",
             "model.num_prob_samples=3", "model.step_start_ema=1", "model.ema_update_every=1",
             "model.lr_scheduler_kwargs.warmup_duration=1", "model.log_every_iters=1"]
ZERO_VELOCITY = ["dataset=amass", "method_specs=zerovelocity_alg_baseline",
                 "stats_mode=probabilistic", "batch_size=8", "num_samples=3",
                 "device_mesh.n_devices=1", *TASK]


def config_dir(tree: str):
    """The CLIs read their tree from SKELDIFF_CONFIG_DIR, as the JAX ones do."""
    return mock.patch.dict(os.environ, {"SKELDIFF_CONFIG_DIR": str(CONFIGS / tree)})


def run(main, tree: str, args):
    with config_dir(tree):
        return main(args)


def assert_same(a, b, path="$"):
    """Equal values of equal types; tensors bit for bit."""
    if isinstance(a, torch.Tensor):
        assert isinstance(b, torch.Tensor) and a.dtype == b.dtype and a.shape == b.shape, path
        assert torch.equal(a, b), (path, (a.double() - b.double()).abs().max())
        return
    assert type(a) is type(b), (path, a, b)
    if isinstance(a, dict):
        assert list(a) == list(b), (path, list(a), list(b))
        for k in a:
            assert_same(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{path}[{i}]")
    elif isinstance(a, float) and math.isnan(a):
        assert math.isnan(b), path
    else:
        assert a == b, (path, a, b)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli_tree")
    return make_synthetic_amass(str(root), obs_length=OBS, pred_length=PRED, clip_len=60,
                                seed=3)


@pytest.fixture(scope="module")
def experiments(tree, tmp_path_factory):
    """Both stages trained by the port's CLIs: 3 epochs straight, and 2
    epochs resumed to 3, each stage 2 on the straight AutoEncoder."""
    out = tmp_path_factory.mktemp("cli_runs")
    common = [f"dataset_main_path={tree}", "device=cpu", "device_mesh.n_devices=1", *TASK,
              *LOADERS]
    exp = {}

    def ae(name, epochs, resume=False):
        return run(train_autoencoder.main, "config_train_autoencoder",
                   common + AE_ARGS + [f"output_log_path={out / name}",
                                       f"model.num_epochs={epochs}",
                                       f"if_resume_training={resume}"])

    exp["ae"] = ae("ae", 3)
    ae("ae_resumed", 2)
    exp["ae_resumed"] = ae("ae_resumed", 3, resume=True)

    def diff(name, epochs, resume=False):
        return run(train_diffusion.main, "config_train_diffusion",
                   common + DIFF_ARGS + [f"output_log_path={out / name}",
                                         f"model.pretrained_autoencoder_path={exp['ae']}/checkpoints",
                                         f"model.num_epochs={epochs}",
                                         f"if_resume_training={resume}"])

    exp["diff"] = diff("diff", 3)
    diff("diff_resumed", 2)
    exp["diff_resumed"] = diff("diff_resumed", 3, resume=True)
    exp["common"] = common
    return exp


# ---- the training CLIs --------------------------------------------------------------


@pytest.mark.parametrize("stage", ["ae", "diff"])
def test_training_cli_writes_its_experiment_folder(experiments, stage):
    exp = pathlib.Path(experiments[stage])
    for name in ("config.yaml", "metrics.jsonl", "host_state.json", "code_snapshot.zip",
                 "checkpoints/index.json"):
        assert (exp / name).exists(), name
    index = json.loads((exp / "checkpoints" / "index.json").read_text())
    scored = [e for e in index if e["score"] is not None]
    assert {e["step"] for e in scored} == {1, 2, 3}  # validation every epoch
    assert any(e["name"] == "latest_3" for e in index)
    prefixes = {json.loads(line)["prefix"] for line in (exp / "metrics.jsonl").open()}
    assert {"train", "train_iter", "norms", "hist", "valid", "train_eval"} <= prefixes
    norms = [json.loads(line) for line in (exp / "metrics.jsonl").open()
             if json.loads(line)["prefix"] == "norms"]
    assert norms and all("grad_global_norm" in r and "param_global_norm" in r for r in norms)
    host = load_host_state(str(exp))
    assert host["epoch"] == 3 and host["global_step"] == 9 and "lr_scheduler" in host
    with zipfile.ZipFile(exp / "code_snapshot.zip") as zf:
        names = zf.namelist()
    assert "chip_smoke.py" in names
    assert any(n.startswith("skeletondiffusion_tpu_torch/cli/") for n in names)
    assert not any(n.startswith("skeletondiffusion_tpu/") for n in names)


@pytest.mark.parametrize("stage", ["ae", "diff"])
def test_resumed_training_equals_uninterrupted(experiments, stage):
    straight = CheckpointManager(os.path.join(experiments[stage], "checkpoints"))
    resumed = CheckpointManager(os.path.join(experiments[f"{stage}_resumed"], "checkpoints"))
    a, b = straight.restore(), resumed.restore()
    assert a["step"] == b["step"] == 9
    assert_same(a, b)
    if stage == "diff":
        assert a["ema"]["step"] == 9 and a["optimizer"]["state"]
    assert_same(load_host_state(experiments[stage]), load_host_state(experiments[f"{stage}_resumed"]))
    assert [e["score"] for e in straight._index] == [e["score"] for e in resumed._index]


def test_stage2_config_equals_jax_merge(experiments):
    ae_cfg = os.path.join(experiments["ae"], "config.yaml")
    args = experiments["common"] + DIFF_ARGS + [
        f"output_log_path={pathlib.Path(experiments['diff'])}",
        f"model.pretrained_autoencoder_path={experiments['ae']}/checkpoints",
        "model.num_epochs=3", "if_resume_training=False"]
    tree_dir = str(CONFIGS / "config_train_diffusion")
    want = jax_merge(jax_flatten(jax_load_config(tree_dir, args)), ae_cfg)
    written = yaml_lite.read(os.path.join(experiments["diff"], "config.yaml"))
    assert_same(written, want)
    assert_same(load_and_merge_autoenc_cfg(flatten_config(load_config(tree_dir, args)), ae_cfg),
                want)
    with open(os.path.join(experiments["diff"], "config.yaml")) as f:
        assert_same(yaml.safe_load(f), want)
    assert written["latent_size"] == 8 and written["compute_dtype"] == "bfloat16"


def test_eval_cli_on_the_trained_experiment(experiments, tmp_path):
    """The eval CLI over the test split against compute_metrics on
    prepare_model's predictor with the same seed, and its results YAML in
    the JAX CLI's folder layout."""
    args = [f"dataset_main_path={experiments['common'][0].split('=', 1)[1]}", "device=cpu",
            "device_mesh.n_devices=1", "dataset=amass", f"checkpoint_path={experiments['diff']}",
            "stats_mode=probabilistic", "batch_size=8", "num_samples=3", *TASK]
    results = run(eval_cli.main, "config_eval", args)
    assert len(results) == 12 and all(np.isfinite(v) for v in results.values())
    path = os.path.join(experiments["diff"], "eval_amass_8", "test", "cpu-cpu_seed0",
                        "results_probabilistic.yaml")
    assert_same(yaml_lite.read(path), {k: float(v) for k, v in results.items()})
    cfg = eval_cli.merge_experiment_cfg(flatten_config(load_config(str(CONFIGS / "config_eval"),
                                                                   args)))
    assert cfg["compute_dtype"] == "bfloat16" and cfg["latent_size"] == 8
    skeleton = build_skeleton(cfg)
    predictor = eval_cli.prepare_model(cfg, skeleton, torch.device("cpu"))
    assert predictor.diffusion.fused is not None  # bf16: the fused kernel chain
    from skeletondiffusion_tpu_torch.cli.common import build_dataset

    dataset = build_dataset(cfg, skeleton, "test", "data_loader_test", if_compute_cmd=True)
    direct = compute_metrics(predictor, dataset, skeleton, batch_size=8, num_samples=3,
                             stats_mode="probabilistic", seed=0, if_compute_cmd=True,
                             if_compute_apde=True,
                             mmapd_gt_path=os.path.join(cfg["annotations_folder"], "mmapd_GT.csv"))
    for k, v in direct.items():
        assert abs(results[k] - v) <= 1e-5 * max(1.0, abs(v)), (k, results[k], v)


# ---- the eval CLI against the JAX one -------------------------------------------------


def test_eval_cli_zero_velocity_equals_jax(tree, tmp_path):
    from skeletondiffusion_tpu.cli.eval import main as jax_eval

    common = ZERO_VELOCITY + [f"dataset_main_path={tree}"]
    want = run(jax_eval, "config_eval", common + [f"results_path={tmp_path / 'jax.yaml'}"])
    got = run(eval_cli.main, "config_eval",
              common + ["device=cpu", f"results_path={tmp_path / 'port.yaml'}"])
    assert list(got) == list(want) and len(got) == 12
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5, atol=1e-6,
                                   err_msg=k)
    assert got["APD"] == 0.0  # every sample is the last observed frame
    port_file = (tmp_path / "port.yaml").read_text()
    jax_file = (tmp_path / "jax.yaml").read_text()
    assert_same(yaml.safe_load(port_file), yaml_lite.load(port_file))
    assert_same(yaml_lite.load(port_file), {k: float(v) for k, v in got.items()})
    assert_same(yaml_lite.load(jax_file), yaml.safe_load(jax_file))
    for k, v in yaml_lite.load(jax_file).items():
        np.testing.assert_allclose(yaml_lite.load(port_file)[k], v, rtol=1e-5, atol=1e-6)


# ---- prepare_model and InferenceSession on carried weights ----------------------------


def write_experiment(root: pathlib.Path, tree: str, ae, den, overrides) -> str:
    """A stage-1 and a stage-2 experiment folder as the port's training
    CLIs write them, holding ``ae``'s and ``den``'s weights (the stage-2
    checkpoint holds them as the live and as the EMA weights); returns the
    stage-2 folder."""
    common = [f"dataset_main_path={tree}", "device=cpu", "device_mesh.n_devices=1", *TASK,
              *overrides]
    ae_cfg = flatten_config(load_config(str(CONFIGS / "config_train_autoencoder"), common))
    save_config(ae_cfg, str(root / "ae" / "config.yaml"))
    CheckpointManager(str(root / "ae" / "checkpoints")).save({"model": ae.state_dict()}, step=1,
                                                             score=0.0)
    diff = flatten_config(load_config(str(CONFIGS / "config_train_diffusion"), common + [
        f"model.pretrained_autoencoder_path={root / 'ae' / 'checkpoints'}"]))
    cfg = load_and_merge_autoenc_cfg(diff, str(root / "ae" / "config.yaml"))
    save_config(cfg, str(root / "diff" / "config.yaml"))
    sd = den.state_dict()
    CheckpointManager(str(root / "diff" / "checkpoints")).save(
        {"denoiser": sd, "ema": {"module": sd, "step": 0}}, step=1, score=0.0)
    return str(root / "diff")


def carried_overrides(latent, hidden, arch, compute_dtype):
    return [f"model.latent_size={latent}", f"model.autoenc_arch.encoder_hidden_size={hidden}",
            f"model.autoenc_arch.decoder_hidden_size={hidden}", "model.diffusion_timesteps=4",
            f"model.diffusion_arch.depth={arch['depth']}",
            f"model.diffusion_arch.attn_heads={arch['attn_heads']}",
            f"model.diffusion_arch.attn_dim_head={arch['attn_dim_head']}",
            f"compute_dtype={compute_dtype or 'null'}", "task.pose_box_size=1.5"]


def eval_cfg(exp: str, tree: str, extra=()):
    args = [f"dataset_main_path={tree}", "device=cpu", "device_mesh.n_devices=1",
            "dataset=amass", f"checkpoint_path={exp}", "num_samples=4", *TASK, *extra]
    return eval_cli.merge_experiment_cfg(
        flatten_config(load_config(str(CONFIGS / "config_eval"), args)))


@pytest.fixture(scope="module")
def carried_fp32(tree, tmp_path_factory):
    """The JAX models of ``torch_parity`` (latent and hidden 16, depth 1),
    their weights in a port experiment folder, and the JAX predictor."""
    from torch_parity import ARCH, HIDDEN, LATENT, skeletons

    jsk, sk = skeletons()
    jae, ae_params, jengine, _, den_params = jax_models(jsk)
    ae, _, den = port_models(sk, ae_params, den_params)
    root = tmp_path_factory.mktemp("carried_fp32")
    exp = write_experiment(root, tree, ae, den, carried_overrides(LATENT, HIDDEN, ARCH, None))
    cfg = eval_cfg(exp, tree, ["compute_dtype=null"])
    jskeleton = jax_build_skeleton(cfg)
    jpred = JaxSkeletonDiffusionPredictor(jskeleton, jae, as_jax(ae_params), jengine,
                                          as_jax(den_params), num_samples=4,
                                          pred_length=cfg["pred_length"])
    return dict(exp=exp, cfg=cfg, jpred=jpred, jskeleton=jskeleton, latent=LATENT)


def injected(rows, n, latent, seed=0):
    rng = np.random.default_rng(seed)
    obs = 0.3 * rng.standard_normal((rows, OBS, n + 1, 3), dtype=np.float32)
    start = rng.standard_normal((rows * 4, n, latent), dtype=np.float32)
    steps = rng.standard_normal((rows * 4, 3, n, latent), dtype=np.float32)
    return obs, start, steps


def test_prepare_model_meets_jax_predictor_fp32(carried_fp32):
    cfg = carried_fp32["cfg"]
    skeleton = build_skeleton(cfg)
    pred = eval_cli.prepare_model(cfg, skeleton, torch.device("cpu"))
    assert pred.diffusion.fused is None and pred.pred_length == PRED
    obs_raw, start, steps = injected(2, skeleton.num_nodes, carried_fp32["latent"])
    obs = skeleton.tranform_to_input_space(torch.from_numpy(obs_raw))
    got, got_lat = pred(None, obs, start_noise=torch.from_numpy(start),
                        step_noise=torch.from_numpy(steps))
    want, want_lat = carried_fp32["jpred"](jax.random.key(0), jnp.asarray(obs.numpy()),
                                           start_noise=jnp.asarray(start),
                                           step_noise=jnp.asarray(steps))
    np.testing.assert_allclose(got_lat.numpy(), np.asarray(want_lat), atol=5e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-5)


def test_prepare_model_meets_jax_predictor_bf16(tree, tmp_path):
    """At the flagship's widths (the JAX fused chain's shape limits): the bf16
    predictor that prepare_model builds from the experiment folder equals, bit
    for bit, the one built from the modules whose weights the folder holds.
    Those modules are the ones ``tests/test_torch_fused.py`` holds against the
    JAX fused chain (``torch_parity.hold_bf16_predictor``), so this predictor
    meets JAX as they do."""
    from skeletondiffusion_tpu_torch.eval_pipeline import SkeletonDiffusionPredictor

    _, sk, m = wide_model_pair()
    bf16 = m["bfloat16"]
    exp = write_experiment(tmp_path, tree, bf16["ae"], bf16["den"],
                           carried_overrides(WIDE["latent"], WIDE["hidden"], WIDE["arch"],
                                             "bfloat16"))
    cfg = eval_cfg(exp, tree)
    assert cfg["compute_dtype"] == "bfloat16"
    pred = eval_cli.prepare_model(cfg, build_skeleton(cfg), torch.device("cpu"))
    assert pred.diffusion.fused is not None
    assert pred.autoencoder.encoder.rnn.cell0.compute_dtype == torch.bfloat16
    direct = SkeletonDiffusionPredictor(sk, bf16["ae"], bf16["engine"], num_samples=4,
                                        pred_length=PRED, device="cpu")
    obs_raw, start, steps = injected(2, sk.num_nodes, WIDE["latent"], seed=21)
    obs = sk.tranform_to_input_space(torch.from_numpy(obs_raw))
    noise = dict(start_noise=torch.from_numpy(start), step_noise=torch.from_numpy(steps))
    assert_same(pred(None, obs, **noise), direct(None, obs, **noise))


def test_inference_session_equals_jax(carried_fp32, tree):
    from skeletondiffusion_tpu import inference as jax_inference

    overrides = [f"dataset_main_path={tree}", "compute_dtype=null", *TASK]
    session = InferenceSession(carried_fp32["exp"], "amass", num_samples=4,
                               config_dir=str(CONFIGS / "config_eval"), overrides=overrides,
                               device="cpu")
    with mock.patch.object(jax_inference, "prepare_model",
                           lambda cfg, skeleton: carried_fp32["jpred"]):
        jsession = jax_inference.InferenceSession(carried_fp32["exp"], "amass", num_samples=4,
                                                  config_dir=str(CONFIGS / "config_eval"),
                                                  overrides=overrides)
    assert session.cfg["checkpoint_path"] == jsession.cfg["checkpoint_path"]
    assert session.skeleton.pose_box_size == jsession.skeleton.pose_box_size == 1.5
    obs_raw, start, steps = injected(1, session.skeleton.num_nodes, carried_fp32["latent"])
    session.predictor = functools.partial(session.predictor, start_noise=torch.from_numpy(start),
                                          step_noise=torch.from_numpy(steps))
    jsession.predictor = functools.partial(jsession.predictor, start_noise=jnp.asarray(start),
                                           step_noise=jnp.asarray(steps))
    got = session.predict(obs_raw[0])
    want = jsession.predict(obs_raw[0], rng=jax.random.key(0))
    assert got.shape == want.shape == (4, PRED, session.skeleton.num_nodes, 3)
    np.testing.assert_allclose(got, want, atol=5e-5)
    target = np.repeat(obs_raw[0, -1:], PRED, axis=0)
    ours, theirs = session.rank(got, target, n_diverse=2), jsession.rank(want, target, n_diverse=2)
    np.testing.assert_array_equal(ours[2], theirs[2])
    np.testing.assert_allclose(ours[0], theirs[0], atol=5e-5)


# ---- create_diffusion: every key honoured or refused -----------------------------------

BASE = dict(diffusion_type="NonisotropicGaussianDiffusion", diffusion_conditioning=True,
            diffusion_timesteps=4, latent_size=8,
            diffusion_arch={"depth": 1, "attn_heads": 2, "attn_dim_head": 4,
                            "learn_influence": True})
REACH = {"covariance_matrix_type": "reachability"}
ISO = {"diffusion_type": "IsotropicGaussianDiffusion"}
SMALL_ARCH = {"depth": 1, "attn_heads": 2, "attn_dim_head": 4, "learn_influence": True}
# (key, value, extra base keys): honoured with the JAX meaning.  The entries
# after remat_denoiser were refusals before the port had the diffusion
# variants (ROADMAP Queue A item 4a).
HONOURED = [
    ("diffusion_type", "NonisotropicGaussianDiffusion", {}),
    ("covariance_matrix_type", "reachability", {}),
    ("reachability_matrix_degree_factor", 0.25, REACH),
    ("reachability_matrix_stop_at", "hips", REACH),
    ("if_sigma_n_scale", False, {}),
    ("sigma_n_scale", "frob", {}),
    ("if_run_as_isotropic", True, {"diffusion_covariance_type": "isotropic"}),
    ("diffusion_conditioning", True, {}),
    ("diffusion_timesteps", 6, {}),
    ("diffusion_objective", "pred_x0", {}),
    ("beta_schedule", "linear", {"diffusion_timesteps": 50}),  # 4 steps: betas above 1
    ("beta_schedule_factor", 2.0, {"beta_schedule": "exp"}),
    ("diffusion_covariance_type", "anisotropic", {}),
    ("gamma_scheduler", "mono_decrease", {}),
    ("loss_reduction_type", "mse", {}),
    ("diffusion_activation", "identity", {}),
    ("diffusion_arch", {"depth": 2, "attn_heads": 4, "attn_dim_head": 2,
                        "learn_influence": False}, {}),
    ("sampling_timesteps", 4, {}),
    ("compute_dtype", "bfloat16", {}),
    ("remat_denoiser", True, {}),
    ("diffusion_type", "IsotropicGaussianDiffusion", {}),
    ("diffusion_conditioning", False, {}),
    ("diffusion_objective", "pred_noise", {}),
    ("diffusion_activation", "tanh", {}),
    ("diffusion_arch", {**SMALL_ARCH, "self_condition": True}, {}),
    ("diffusion_arch", {**SMALL_ARCH, "use_attention": False}, {}),
    ("sampling_timesteps", 2, ISO),
    ("ddim_sampling_eta", 1.0, {**ISO, "sampling_timesteps": 2}),
    ("diffusion_loss_type", "l1", ISO),
    ("diffusion_objective", "pred_v", ISO),
]
# accepted and without effect, as in the JAX nonisotropic branch
NO_OPS = [("diffusion_loss_type", "snr"), ("diffusion_loss_type", "l1"),
          ("ddim_sampling_eta", 1.0)]
# refused, as the JAX package refuses them
RAISES = [
    ("covariance_matrix_type", "identity", NotImplementedError),
    ("sampling_timesteps", 2, NotImplementedError),  # DDIM on the nonisotropic process
    ("sampling_timesteps", 5, ValueError),
    ("sigma_n_scale", "trace", NotImplementedError),
    ("loss_reduction_type", "huber", NotImplementedError),
    ("diffusion_objective", "pred_v", NotImplementedError),
    ("diffusion_activation", "relu", ValueError),
    ("diffusion_type", "LatentDiffusion", NotImplementedError),
    ("diffusion_arch", {"depth": 1, "norm_type": "layer"}, NotImplementedError),
]


def honoured_ids():
    """A key's first case is named by the key, a later one by key=value."""
    seen, ids = set(), []
    for key, value, _ in HONOURED:
        ids.append(key if key not in seen else f"{key}={value}")
        seen.add(key)
    return ids


def test_create_diffusion_takes_every_cfg_key_by_name():
    params = inspect.signature(create_diffusion).parameters
    assert not any(p.kind == p.VAR_KEYWORD for p in params.values())
    assert set(DIFFUSION_CFG_KEYS) <= set(params)
    covered = {k for k, _, _ in HONOURED} | {k for k, _ in NO_OPS} | {k for k, _, _ in RAISES}
    assert covered == set(DIFFUSION_CFG_KEYS)
    assert {k for k, _, _ in HONOURED} | {k for k, _ in NO_OPS} == set(DIFFUSION_CFG_KEYS)


def port_build(**kwargs):
    from torch_parity import skeletons

    _, sk = skeletons()
    return create_diffusion(sk, torch.Generator().manual_seed(0), device="cpu",
                            **{**BASE, **kwargs})


def fingerprint_inputs():
    rng = np.random.default_rng(5)
    return [rng.standard_normal((3, 21, 8), dtype=np.float32) for _ in range(3)]


def port_fingerprint(engine):
    """One posterior step from each of t = 0, 1, 2 on the engine's step
    tables (the plain version of the sampler's kernel), the loss weights and
    the loss on fixed inputs, as numpy arrays."""
    from skeletondiffusion_tpu_torch.ops.kernels.posterior_step import posterior_step_plain

    x0, xt, noise = (torch.from_numpy(a).transpose(0, 1) for a in fingerprint_inputs())
    steps = [posterior_step_plain(x0, xt, noise, engine.step_tables[t]).transpose(0, 1)
             for t in range(3)]
    out, target, _ = map(torch.from_numpy, fingerprint_inputs())
    return [np.asarray(torch.stack(steps), dtype=np.float64),
            np.asarray(engine.process.loss_weight, dtype=np.float64),
            np.asarray(engine.process.loss_terms(out, target, torch.tensor([0, 1, 2])),
                       dtype=np.float64)]


def jax_fingerprint(process):
    """``port_fingerprint`` of a JAX process: the step as the JAX engine
    takes it (clip, q_posterior, combine_mean_var_noise, no noise at t=0)."""
    x0, xt, noise = map(jnp.asarray, fingerprint_inputs())
    steps = []
    for t in range(3):
        mean, _, log_var = process.q_posterior(jnp.clip(x0, -1, 1), xt, jnp.asarray(t))
        steps.append(process.combine_mean_var_noise(mean, log_var, noise if t else 0 * noise))
    out, target, _ = map(jnp.asarray, fingerprint_inputs())
    return [np.asarray(jnp.stack(steps), dtype=np.float64),
            np.asarray(process.loss_weight, dtype=np.float64),
            np.asarray(process.loss_terms(out, target, jnp.asarray([0, 1, 2])),
                       dtype=np.float64)]


@pytest.mark.parametrize("key,value,extra", HONOURED, ids=honoured_ids())
def test_create_diffusion_honours_key_as_jax(key, value, extra):
    from torch_parity import skeletons

    jsk, _ = skeletons()
    engine, den = port_build(**extra, **{key: value})
    jax_kwargs = {**BASE, **extra, key: value}
    jengine, jden = jax_create_diffusion(jsk, **jax_kwargs)
    for got, ref in zip(port_fingerprint(engine), jax_fingerprint(jengine.process)):
        assert np.isfinite(got).all(), key
        np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-6, err_msg=key)  # float32 sums
    n, latent = jsk.num_nodes, BASE["latent_size"]
    cond = jnp.zeros((1, n, latent)) if jax_kwargs["diffusion_conditioning"] else None
    jparams = jden.init(jax.random.key(0), jnp.zeros((1, n, latent)), jnp.zeros((1,), jnp.int32),
                        cond)
    assert {k: tuple(v.shape) for k, v in flatten_params(jax.device_get(jparams)).items()} == \
        {k: tuple(v.shape) for k, v in den.state_dict().items()}, key
    assert den.compute_dtype == (torch.bfloat16 if jden.compute_dtype == "bfloat16" else None)
    assert (den.cond_dim, den.self_condition, den.use_attention) == (
        jden.cond_dim, jden.self_condition, jden.use_attention)
    assert engine.remat == bool(jax_kwargs.get("remat_denoiser", False))
    assert (engine.num_timesteps, engine.objective, engine.activation, engine.condition,
            engine.sampling_timesteps, engine.is_ddim_sampling) == (
        jengine.num_timesteps, jengine.objective, jengine.activation, jengine.condition,
        jengine.sampling_timesteps, jengine.is_ddim_sampling)
    assert engine.ddim_sampling_eta == jengine.ddim_sampling_eta
    assert type(engine.process).__name__ == type(jengine.process).__name__


@pytest.mark.parametrize("key,value", NO_OPS, ids=[f"{k}={v}" for k, v in NO_OPS])
def test_create_diffusion_no_op_key(key, value):
    default_engine, default_den = port_build()
    engine, den = port_build(**{key: value})
    for got, want in zip(port_fingerprint(engine), port_fingerprint(default_engine)):
        np.testing.assert_array_equal(got, want)
    assert_same(den.state_dict(), default_den.state_dict())


@pytest.mark.parametrize("key,value,error", RAISES, ids=[f"{k}={v}" for k, v, _ in RAISES])
def test_create_diffusion_refuses_key(key, value, error):
    with pytest.raises(error):
        port_build(**{key: value})


def test_ddim_on_the_nonisotropic_process_raises_as_jax():
    """DDIM is the isotropic process's sampler (JAX `engine.py:308` asserts it
    when sampling; the port refuses the engine at once)."""
    with pytest.raises(NotImplementedError, match="isotropic process"):
        port_build(sampling_timesteps=2)
    jengine, _ = jax_create_diffusion(skeletons_jax(), **{**BASE, "sampling_timesteps": 2})
    with pytest.raises(AssertionError, match="isotropic"):
        jengine.ddim_sample(None, jax.random.key(0), (1, 21, 8),
                            x_cond=jnp.zeros((1, 21, 8)))


def skeletons_jax():
    from torch_parity import skeletons

    return skeletons()[0]


def test_remat_denoiser_gives_bit_identical_gradients():
    rng = np.random.default_rng(9)
    z, z_past = (torch.from_numpy(rng.standard_normal((3, 21, 8), dtype=np.float32))
                 for _ in range(2))
    t = torch.tensor([0, 2, 3])
    noise = torch.from_numpy(rng.standard_normal((6, 21, 8), dtype=np.float32))
    grads = []
    for remat in (False, True):
        engine, den = port_build(remat_denoiser=remat)
        loss, weights, _ = engine.loss(z, x_cond=z_past, n_train_samples=2, t=t, noise=noise)
        (loss * weights.repeat_interleave(2)).mean().backward()
        grads.append({k: p.grad.clone() for k, p in den.named_parameters()})
    assert_same(grads[0], grads[1])
    with mock.patch("skeletondiffusion_tpu_torch.diffusion.engine.checkpoint",
                    side_effect=AssertionError("checkpoint")) as ckpt:
        engine, _ = port_build(remat_denoiser=True)
        with pytest.raises(AssertionError, match="checkpoint"):
            engine.loss(z, x_cond=z_past, t=t, noise=noise[:3])
        with torch.no_grad():  # the sampler's forward keeps no activations to save
            engine.loss(z, x_cond=z_past, t=t, noise=noise[:3])
        assert ckpt.call_count == 1


# ---- device, refusals, launchers, debug, storer ---------------------------------------


def test_setup_device_defaults_to_the_card_and_refuses_more_than_one():
    """One process is one device: a data axis of two needs two processes
    (torchrun), and so does a 2-D mesh, whose model axis
    (``device_mesh.model_parallel``) must divide its ranks."""
    from skeletondiffusion_tpu_torch.cli.common import setup_device, setup_mesh

    for n in (None, 1):
        cfg = {"device": "cpu", "device_mesh": {"n_devices": n}}
        assert setup_mesh(cfg) is None and setup_device(cfg).type == "cpu"
    with pytest.raises(ValueError, match="needs 2 processes"):
        setup_mesh({"device": "cpu", "device_mesh": {"n_devices": 2}})
    with pytest.raises(ValueError, match="model_parallel=2 does not divide a mesh of 1"):
        setup_mesh({"device": "cpu", "device_mesh": {"n_devices": 1, "model_parallel": 2}})
    with pytest.raises(ValueError, match="needs 4 processes"):
        setup_mesh({"device": "cpu", "device_mesh": {"n_devices": 4, "model_parallel": 2}})
    if not torch.cuda.is_available():
        for cfg in ({}, {"device": "cuda"}):  # the default is the card
            with pytest.raises(RuntimeError, match="cuda"):
                setup_device(cfg)


def test_build_dataset_refuses_what_the_port_lacks(tree):
    from skeletondiffusion_tpu_torch.cli.common import build_dataset

    cfg = flatten_config(load_config(str(CONFIGS / "config_train_autoencoder"),
                                     [f"dataset_main_path={tree}", *TASK, *LOADERS]))
    sk = build_skeleton(cfg)
    # every dataset class of the JAX package reads since the skeletons' slice
    with pytest.raises(NotImplementedError, match="the port reads"):
        build_dataset({**cfg, "dataset_type": "MANODataset"}, sk, "train", "data_loader_train")
    loader = {**cfg["data_loader_train"], "normalize_data": True}
    with pytest.raises(ValueError, match="normalize_data"):
        build_dataset({**cfg, "data_loader_train": loader}, sk, "train", "data_loader_train")


def test_fid_classifier_reads_the_reference_weights_and_h36m_is_refused(tmp_path):
    """The FID hook reads ``h36m_classifier.pth`` (the reference's
    ``{"model": state_dict}``) into the port's classifier, for the H36M test
    split only.  ``build_skeleton`` builds the H36M skeleton since the
    skeletons' slice and AMASS-MANO's 51 nodes since its own; a joint count
    the SMPL-H body does not have is refused."""
    from skeletondiffusion_tpu_torch.metrics.fid import ClassifierForFID, port_classifier

    g = np.load(REPO / "tests" / "goldens" / "fid_classifier.npz")
    sd = {k: g[k] for k in g.files if k not in ("motion", "feats", "logits")}
    torch.save({"model": {k: torch.from_numpy(v) for k, v in sd.items()}},
               tmp_path / "h36m_classifier.pth")
    cfg = {"if_compute_fid": True, "dataset_name": "h36m", "precomputed_folder": str(tmp_path)}
    clf = eval_cli.fid_classifier(cfg, "test")
    want = ClassifierForFID()
    want.load_state_dict(port_classifier(sd))
    assert_same(clf.state_dict(), want.state_dict())
    assert eval_cli.fid_classifier(cfg, "valid") is None
    assert eval_cli.fid_classifier({**cfg, "dataset_name": "amass"}, "test") is None
    assert eval_cli.fid_classifier({**cfg, "precomputed_folder": str(tmp_path / "no")},
                                   "test") is None
    amass = flatten_config(load_config(str(CONFIGS / "config_eval"), ["dataset=amass", *TASK]))
    h36m = flatten_config(load_config(str(CONFIGS / "config_eval"), ["dataset=h36m", *TASK]))
    assert build_skeleton(h36m).num_nodes == 16
    assert build_skeleton({**amass, "dataset_name": "amass-mano", "num_joints": 52}).num_nodes == 51
    with pytest.raises(ValueError, match="22 joints, or 52"):
        build_skeleton({**amass, "dataset_name": "amass-mano", "num_joints": 53})


def test_eval_launcher_runs_as_a_module(tree, tmp_path):
    """``python -m skeletondiffusion_tpu_torch.cli.eval`` with
    SKELDIFF_CONFIG_DIR, as a user runs it."""
    import subprocess
    import sys

    env = {**os.environ, "PYTHONPATH": str(REPO),
           "SKELDIFF_CONFIG_DIR": str(CONFIGS / "config_eval")}
    out = subprocess.run(
        [sys.executable, "-m", "skeletondiffusion_tpu_torch.cli.eval", *ZERO_VELOCITY,
         f"dataset_main_path={tree}", "device=cpu", f"results_path={tmp_path / 'r.yaml'}"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert " ADE |" in out.stdout
    assert yaml_lite.read(str(tmp_path / "r.yaml"))["APD"] == 0.0


def test_configure_debug_checks_the_loss_and_profile_trace_stops(tmp_path):
    from skeletondiffusion_tpu_torch.utils.debug import configure_debug, profile_trace

    try:
        check = configure_debug(if_debug_nans=True)
        assert torch.is_anomaly_enabled() and torch.is_anomaly_check_nan_enabled()
        check(torch.tensor(1.0))
        with pytest.raises(FloatingPointError):
            check(torch.tensor(float("nan")))
    finally:
        configure_debug()
    assert not torch.is_anomaly_enabled()
    configure_debug()(torch.tensor(float("nan")))  # no check without if_debug_nans
    with pytest.raises(ValueError, match="inside"):
        with profile_trace(str(tmp_path / "trace")):
            torch.ones(3).sum()
            raise ValueError("inside")
    assert any(p.name.endswith(".pt.trace.json") for p in (tmp_path / "trace").iterdir())
    with profile_trace(None):  # off: a no-op
        pass


def test_result_storer_reads_what_jax_writes_and_back(tmp_path):
    from skeletondiffusion_tpu.utils.store import ResultStorer as JaxResultStorer
    from skeletondiffusion_tpu_torch.utils.store import ResultStorer

    rng = np.random.default_rng(1)
    shards = [dict(pred=rng.standard_normal((2, 3, 4, 21, 3), dtype=np.float32),
                   obs=rng.standard_normal((2, 6, 21, 3), dtype=np.float32),
                   target=rng.standard_normal((2, 4, 21, 3), dtype=np.float32)) for _ in range(2)]
    config = {"seed": 0, "lr": "1e-3", "datasets": ["DFaust", "GRAB"], "eps": 1e-05}
    for writer, reader, name in ((ResultStorer, JaxResultStorer.load, "port"),
                                 (JaxResultStorer, ResultStorer.load, "jax")):
        store = writer(str(tmp_path / name), store_gt=True)
        for i, shard in enumerate(shards):
            store.append(**shard, metadata={"batch": i, "flag": "yes"})
        store.finalize(config)
        arrays, cfg = reader(str(tmp_path / name))
        assert cfg == config and type(cfg["lr"]) is str, name
        for k in ("pred", "obs", "target"):
            np.testing.assert_array_equal(arrays[k], np.concatenate([s[k] for s in shards]))
        meta = tmp_path / name / "shard_00001.yaml"
        assert yaml_lite.read(str(meta)) == yaml.safe_load(meta.read_text()) == \
            {"batch": 1, "flag": "yes"}
