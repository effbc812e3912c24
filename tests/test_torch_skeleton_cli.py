"""The port's entry points on the new skeletons, on the CPU: both training
CLIs and the eval CLI with ``dataset=h36m`` and ``dataset=freeman`` (the
configs' task lengths, observe 0.5 s and predict 2 s at 50 and 30 fps: 25 /
100 and 15 / 60 frames, the validation segments of the shipped CSVs), and
the 3DPW zero-shot evaluation (``dataset=3dpw``) of a model trained with
``dataset=amass``, each on a small tree of the shipped annotations at tiny
widths.  Each experiment's folder, config and losses are checked, and each
eval CLI's results against ``compute_metrics`` on its ``prepare_model``
with the same seed."""
import json
import math
import os
import pathlib
from unittest import mock

import numpy as np
import pytest

from skeletondiffusion_tpu_torch.cli import eval as eval_cli
from skeletondiffusion_tpu_torch.cli import train_autoencoder, train_diffusion
from skeletondiffusion_tpu_torch.cli.common import build_dataset, build_skeleton
from skeletondiffusion_tpu_torch.data import make_synthetic_amass
from skeletondiffusion_tpu_torch.data.synthetic import make_synthetic_skeleton_tree
from skeletondiffusion_tpu_torch.eval_pipeline import compute_metrics
from skeletondiffusion_tpu_torch.utils import yaml_lite
from skeletondiffusion_tpu_torch.utils.config import flatten_config, load_config

REPO = pathlib.Path(__file__).resolve().parents[1]
CONFIGS = REPO / "configs"
ANNOTATIONS = REPO / "datasets" / "annotations"
AE_ARGS = ["model.batch_size=4", "model.num_iter_perepoch=2", "model.num_epochs=1",
           "model.latent_size=8", "model.autoenc_arch.encoder_hidden_size=8",
           "model.autoenc_arch.decoder_hidden_size=8", "model.curriculum_it=1",
           "model.if_run_validation=True", "model.eval_frequency=1",
           "model.num_iteration_eval=1", "model.batch_size_eval=4", "device=cpu",
           "device_mesh.n_devices=1"]
DIFF_ARGS = ["model.batch_size=4", "model.num_iter_perepoch=2", "model.num_epochs=1",
             "model.train_pick_best_sample_among_k=2", "model.diffusion_timesteps=2",
             "model.diffusion_arch.depth=1", "model.diffusion_arch.attn_heads=2",
             "model.diffusion_arch.attn_dim_head=4", "model.if_run_validation=True",
             "model.eval_frequency=1", "model.num_iteration_eval=1", "model.batch_size_eval=4",
             "model.num_prob_samples=2", "device=cpu", "device_mesh.n_devices=1"]
EVAL_ARGS = ["stats_mode=probabilistic", "batch_size=4", "num_samples=3", "device=cpu",
             "device_mesh.n_devices=1"]


def run(main, tree: str, args):
    with mock.patch.dict(os.environ, {"SKELDIFF_CONFIG_DIR": str(CONFIGS / tree)}):
        return main(args)


def check_experiment(exp: str, nodes: int):
    cfg = yaml_lite.read(os.path.join(exp, "config.yaml"))
    assert build_skeleton(cfg).num_nodes == nodes
    with open(os.path.join(exp, "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    losses = [r["loss"] for r in records if r["prefix"] == "train"]
    assert len(losses) == 1 and all(math.isfinite(v) for v in losses), losses
    assert any(r["prefix"] == "valid" for r in records)
    return cfg


def train_and_evaluate(tmp_path, data_root: str, dataset: str, nodes: int, eval_dataset=None,
                       loaders=(), eval_extra=()):
    """Stage 1 and stage 2 through the training CLIs (``loaders``: overrides
    of both), then the eval CLI on ``eval_dataset`` (default: the training
    dataset) against ``compute_metrics`` on its ``prepare_model``; returns
    the results and the eval's skeleton."""
    common = [f"dataset={dataset}", f"dataset_main_path={data_root}", *loaders]
    ae_dir = run(train_autoencoder.main, "config_train_autoencoder",
                 common + AE_ARGS + [f"output_log_path={tmp_path / 'ae'}"])
    check_experiment(ae_dir, nodes)
    diff_dir = run(train_diffusion.main, "config_train_diffusion",
                   [f"dataset_main_path={data_root}", *loaders, *DIFF_ARGS,
                    f"output_log_path={tmp_path / 'diffusion'}",
                    f"model.pretrained_autoencoder_path={ae_dir}/checkpoints"])
    cfg = check_experiment(diff_dir, nodes)
    assert cfg["dataset_name"] == dataset
    args = [f"dataset={eval_dataset or dataset}", f"dataset_main_path={data_root}",
            f"checkpoint_path={diff_dir}", *EVAL_ARGS, *eval_extra]
    got = run(eval_cli.main, "config_eval", args + [f"results_path={tmp_path / 'r.yaml'}"])
    assert got and all(math.isfinite(float(v)) for v in got.values()), got
    assert yaml_lite.read(str(tmp_path / "r.yaml")) == {k: float(v) for k, v in got.items()}
    ecfg = eval_cli.merge_experiment_cfg(flatten_config(load_config(str(CONFIGS / "config_eval"),
                                                                      args)))
    skeleton = build_skeleton(ecfg)
    dataset_ = build_dataset(ecfg, skeleton, "test", "data_loader_test",
                             if_compute_cmd=bool(ecfg.get("if_compute_cmd")))
    predictor = eval_cli.prepare_model(ecfg, skeleton, eval_cli.setup_device(ecfg))
    want = compute_metrics(predictor, dataset_, skeleton, batch_size=4, num_samples=3,
                           if_compute_cmd=bool(ecfg.get("if_compute_cmd")),
                           if_compute_apde=bool(ecfg.get("if_compute_apde")),
                           mmapd_gt_path=os.path.join(ecfg["annotations_folder"], "mmapd_GT.csv"),
                           silent=True, pred_length=ecfg["pred_length"],
                           seed=ecfg.get("seed", 0))
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), want[k], rtol=1e-5, atol=1e-6, err_msg=k)
    return got, skeleton


@pytest.mark.parametrize("dataset, folder, joints, lengths", [
    ("h36m", "Human36M", 17, (25, 100)),
    ("freeman", "FreeMan", 18, (15, 60)),
])
def test_training_and_eval_clis_on_the_skeleton(tmp_path, dataset, folder, joints, lengths):
    root = make_synthetic_skeleton_tree(
        str(tmp_path / "tree"), dataset, str(ANNOTATIONS / folder / "hmp"),
        obs_length=lengths[0], pred_length=lengths[1], max_segments=6, max_sequences=3,
        train_frames=sum(lengths) + 40, train_actions=2, seed=3)
    got, skeleton = train_and_evaluate(tmp_path, root, dataset, joints - 1)
    assert skeleton.num_nodes == joints - 1 and "CMD" in got


def test_3dpw_zero_shot_eval_of_an_amass_model(tmp_path):
    """Train on a synthetic AMASS tree (observe 30, predict 120 at 60 fps),
    evaluate on 3DPW's zero-shot test segments (24-joint clips cut to the
    AMASS body's 22)."""
    root = make_synthetic_amass(str(tmp_path / "tree"), obs_length=30, pred_length=120,
                                train_datasets=("ACCAD", "CMU"), test_datasets=("DFaust",),
                                files_per_dataset=2, clip_len=200, seed=4)
    make_synthetic_skeleton_tree(str(tmp_path / "tree"), "3dpw", str(ANNOTATIONS / "3DPW" / "hmp"),
                                 obs_length=30, pred_length=120, max_segments=6, seed=4)
    loaders = ["dataset.data_loader_train.datasets=[ACCAD, CMU]",
               "dataset.data_loader_train_eval.datasets=[CMU]",
               "dataset.data_loader_valid.datasets=[ACCAD]", "dataset.data_loader_train.stride=5"]
    csv = os.path.join(root, "annotations", "3DPW", "hmp", "segments_test_zero_shot.csv")
    got, skeleton = train_and_evaluate(
        tmp_path, root, "amass", 21, eval_dataset="3dpw", loaders=loaders,
        eval_extra=[f"dataset.data_loader_test.segments_path={csv}"])
    assert skeleton.num_joints == 22 and "CMD" in got and "APDE" not in got


@pytest.mark.parametrize("dataset, lengths, iters", [
    ("h36m", (25, 100), 485), ("freeman", (15, 60), 580), ("3dpw", (30, 120), None)])
def test_configs_give_each_dataset_its_task_lengths(dataset, lengths, iters):
    """Observe 0.5 s and predict 2 s at the dataset's fps, and stage 1's
    iterations an epoch (485 for H36M), as the JAX config reader gives
    them."""
    from skeletondiffusion_tpu.utils.config import flatten_config as jax_flatten
    from skeletondiffusion_tpu.utils.config import load_config as jax_load_config

    trees = ["config_eval"] + ([] if iters is None else ["config_train_autoencoder"])
    for tree in trees:
        args = [f"dataset={dataset}"]
        cfg = flatten_config(load_config(str(CONFIGS / tree), args))
        want = jax_flatten(jax_load_config(str(CONFIGS / tree), args))
        assert (cfg["obs_length"], cfg["pred_length"]) == lengths
        assert (want["obs_length"], want["pred_length"]) == lengths
        if tree == "config_train_autoencoder":
            assert cfg["num_iter_perepoch"] == want["num_iter_perepoch"] == iters
