"""The PyTorch twins of the JAX package's four examples on the CPU
(``examples/torch_*.py``, ``--device cpu``): the quickstart end to end (its
synthetic tree, both training CLIs at the JAX quickstart's widths and
schedule, the eval CLI, the serving export and a served call), then the
inference, serving and visualize examples on the quickstart's experiment;
and each of them refuses to run on CUDA where there is none."""
import importlib.util
import math
import os
import pathlib

import numpy as np
import pytest
import torch

EXAMPLES = pathlib.Path(__file__).resolve().parents[1] / "examples"
TASK = ["task.history_sec=0.1", "task.prediction_horizon_sec=0.25"]


def example(name: str):
    spec = importlib.util.spec_from_file_location(name, EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def quickstart(tmp_path_factory):
    out = tmp_path_factory.mktemp("quickstart")
    return example("torch_quickstart_synthetic").main(["--out", str(out), "--device", "cpu"])


def test_quickstart_runs_the_whole_pipeline(quickstart):
    results, served = quickstart["results"], quickstart["served"]
    assert {"ADE", "FDE", "APD", "MMADE", "CMD"} <= set(results)
    assert all(math.isfinite(v) for v in results.values())
    assert tuple(served.shape) == (2, 4, 15, 21, 3) and bool(torch.isfinite(served).all())
    predictor = quickstart["predictor"]
    # the JAX quickstart's widths: hidden and latent 16, 2 heads × 4, bf16
    den = predictor.diffusion.denoiser
    assert (den.dim, den.attn_heads, den.attn_dim_head) == (16, 2, 4)
    assert den.compute_dtype == torch.bfloat16
    assert predictor.autoencoder.decoder.rollout.cell.hidden_banks()[0].shape[-2] == 16
    # on the CPU the chain's plain versions take every width
    assert predictor.use_fused_denoiser and predictor.fused_denoiser_refusal is None
    for d in ("autoencoder", "diffusion"):
        assert os.path.isfile(os.path.join(quickstart[d], "config.yaml"))
    assert os.path.isfile(os.path.join(quickstart["artifact"], "manifest.json"))


def test_inference_example_predicts_and_ranks(quickstart, tmp_path):
    gif = tmp_path / "inference.gif"
    pred, idx = example("torch_inference_example").main(
        ["--checkpoint", quickstart["diffusion"], "--num-samples", "6", "--device", "cpu",
         "--out", str(gif)])
    # the eval tree's task (observe 30, predict 120) on the shipped observation
    assert pred.shape == (6, 120, 21, 3) and np.isfinite(pred).all()
    assert len(set(idx.tolist())) == 5 and set(idx.tolist()) <= set(range(6))
    assert gif.stat().st_size > 0


def test_serving_example_exports_then_serves(quickstart, tmp_path):
    serving_example = example("torch_serving_example")
    art = str(tmp_path / "artifact")
    assert serving_example.main(["export", "--checkpoint", quickstart["diffusion"],
                                 "--artifact", art, "--batch-size", "2", "--num-samples", "3",
                                 "--device", "cpu"]) is None
    pred = serving_example.main(["serve", "--artifact", art, "--device", "cpu"])
    assert tuple(pred.shape) == (2, 3, 120, 21, 3) and bool(torch.isfinite(pred).all())


def test_visualize_example_renders_a_test_segment(quickstart, tmp_path):
    out = example("torch_visualize_example").main(
        ["--checkpoint", quickstart["diffusion"], "--dataset_main_path", quickstart["dataset"],
         "--num-samples", "6", "--n-diverse", "2", "--out", str(tmp_path / "grid.gif"),
         "--device", "cpu", *[a for o in TASK for a in ("--override", o)]])
    assert os.path.getsize(out) > 0


@pytest.mark.parametrize("name, argv", [
    ("torch_quickstart_synthetic", []),
    ("torch_inference_example", ["--checkpoint", "unused"]),
    ("torch_serving_example", ["serve", "--artifact", "unused"]),
    ("torch_visualize_example", ["--checkpoint", "unused", "--dataset_main_path", "unused"]),
])
def test_examples_ask_for_cuda_by_default(name, argv, tmp_path, monkeypatch):
    """Without ``--device cpu`` each example asks for CUDA, which raises here
    before it reads or writes anything."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    extra = ["--out", str(tmp_path / "q")] if name == "torch_quickstart_synthetic" else []
    with pytest.raises(RuntimeError, match="cuda"):
        example(name).main(argv + extra)
    assert not (tmp_path / "q").exists()
