"""The port's entry points with ``dataset=amass-mano`` on the CPU: the port of
the JAX package's ``test_amass_mano_two_stage_training_and_eval``
(``tests/test_cli_end2end.py``: both training CLIs and the eval CLI on a
52-joint synthetic tree at the same tiny widths), with the stage-2 config
equal to the JAX merge of the same arguments and the eval CLI's results
equal to ``compute_metrics`` on its ``prepare_model`` (1e-5 relative); and
the eval CLI of the ZeroVelocity baseline against the JAX eval CLI on the
same tree (rtol 1e-5, atol 1e-6)."""
import math
import os
import pathlib
from unittest import mock

import numpy as np
import pytest
import torch

from skeletondiffusion_tpu.utils.config import flatten_config as jax_flatten
from skeletondiffusion_tpu.utils.config import load_and_merge_autoenc_cfg as jax_merge
from skeletondiffusion_tpu.utils.config import load_config as jax_load_config
from skeletondiffusion_tpu_torch.cli import eval as eval_cli
from skeletondiffusion_tpu_torch.cli import train_autoencoder, train_diffusion
from skeletondiffusion_tpu_torch.cli.common import build_dataset, build_skeleton
from skeletondiffusion_tpu_torch.data import make_synthetic_amass
from skeletondiffusion_tpu_torch.eval_pipeline import compute_metrics
from skeletondiffusion_tpu_torch.utils import yaml_lite
from skeletondiffusion_tpu_torch.utils.config import flatten_config, load_config

REPO = pathlib.Path(__file__).resolve().parents[1]
CONFIGS = REPO / "configs"
TASK = ["task.history_sec=0.1", "task.prediction_horizon_sec=0.25"]  # obs 6, pred 15 at 60 fps
COMMON = [*TASK, "device=cpu", "device_mesh.n_devices=1",
          "dataset.data_loader_train.datasets=[ACCAD, CMU]",
          "dataset.data_loader_train.stride=8", "dataset.data_loader_train.augmentation=2"]


def run(main, tree: str, args):
    with mock.patch.dict(os.environ, {"SKELDIFF_CONFIG_DIR": str(CONFIGS / tree)}):
        return main(args)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """The JAX test's tree: 52-joint clips in ``AMASS-MANO/`` (ACCAD and CMU
    train, DFaust test), from the port's generator with the same seed."""
    return make_synthetic_amass(str(tmp_path_factory.mktemp("mano")), num_joints=52,
                                dataset_name="amass-mano", dataset_dir="AMASS-MANO",
                                train_datasets=("ACCAD", "CMU"), test_datasets=("DFaust",),
                                segment_stride=12, seed=5)


def test_amass_mano_two_stage_training_and_eval(tree, tmp_path):
    common = [f"dataset_main_path={tree}", *COMMON]
    ae_dir = run(train_autoencoder.main, "config_train_autoencoder", common + [
        "dataset=amass-mano", f"output_log_path={tmp_path}/out_ae", "model.num_epochs=1",
        "model.batch_size=4", "model.num_iter_perepoch=2", "model.latent_size=8",
        "model.autoenc_arch.encoder_hidden_size=8", "model.autoenc_arch.decoder_hidden_size=8",
        "model.curriculum_it=1", "model.save_frequency=1", "model.if_run_validation=False"])
    diff_args = common + [
        f"output_log_path={tmp_path}/out_diff",
        f"model.pretrained_autoencoder_path={ae_dir}/checkpoints",
        "model.num_epochs=1", "model.batch_size=4", "model.num_iter_perepoch=2",
        "model.train_pick_best_sample_among_k=2", "model.diffusion_timesteps=4",
        "model.diffusion_arch.depth=1", "model.diffusion_arch.attn_heads=2",
        "model.diffusion_arch.attn_dim_head=4", "model.save_frequency=1"]
    diff_dir = run(train_diffusion.main, "config_train_diffusion", diff_args)
    written = yaml_lite.read(os.path.join(diff_dir, "config.yaml"))
    want_cfg = jax_merge(jax_flatten(jax_load_config(str(CONFIGS / "config_train_diffusion"),
                                                     diff_args)),
                         os.path.join(ae_dir, "config.yaml"))
    assert written == want_cfg
    assert (written["dataset_name"], written["num_joints"]) == ("amass-mano", 52)
    args = ["dataset=amass-mano", f"dataset_main_path={tree}", *TASK, "device=cpu",
            "device_mesh.n_devices=1", f"checkpoint_path={diff_dir}", "stats_mode=deterministic",
            "batch_size=8", "num_samples=2", f"results_path={tmp_path}/results.yaml"]
    results = run(eval_cli.main, "config_eval", args)
    for key in ("ADE", "FDE", "APD"):
        assert key in results and np.isfinite(results[key]), (key, results)
    cfg = eval_cli.merge_experiment_cfg(flatten_config(load_config(str(CONFIGS / "config_eval"),
                                                                   args)))
    skeleton = build_skeleton(cfg)
    assert skeleton.num_nodes == 51
    predictor = eval_cli.prepare_model(cfg, skeleton, torch.device("cpu"))
    cmd, apde = bool(cfg.get("if_compute_cmd")), bool(cfg.get("if_compute_apde"))
    dataset = build_dataset(cfg, skeleton, "test", "data_loader_test", if_compute_cmd=cmd)
    direct = compute_metrics(predictor, dataset, skeleton, batch_size=8, num_samples=2,
                             stats_mode="deterministic", seed=cfg.get("seed", 0), silent=True,
                             pred_length=cfg["pred_length"], if_compute_cmd=cmd,
                             if_compute_apde=apde,
                             mmapd_gt_path=os.path.join(cfg["annotations_folder"], "mmapd_GT.csv"))
    assert list(direct) == list(results)
    for k, v in direct.items():
        assert abs(results[k] - v) <= 1e-5 * max(1.0, abs(v)), (k, results[k], v)
        assert math.isfinite(v)


def test_amass_mano_zero_velocity_eval_cli_equals_jax(tree, tmp_path):
    from skeletondiffusion_tpu.cli.eval import main as jax_eval

    common = ["dataset=amass-mano", "method_specs=zerovelocity_alg_baseline",
              "stats_mode=probabilistic", "batch_size=8", "num_samples=3",
              "device_mesh.n_devices=1", *TASK, f"dataset_main_path={tree}"]
    want = run(jax_eval, "config_eval", common + [f"results_path={tmp_path / 'jax.yaml'}"])
    got = run(eval_cli.main, "config_eval",
              common + ["device=cpu", f"results_path={tmp_path / 'port.yaml'}"])
    assert list(got) == list(want) and len(got) == 12
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5, atol=1e-6,
                                   err_msg=k)
    assert got["APD"] == 0.0  # every sample is the last observed frame
