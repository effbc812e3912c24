"""The port's data axis (``skeletondiffusion_tpu_torch/parallel``) on the
CPU: two gloo ranks spawned on free localhost ports (``dryrun.run_ranks``,
each call under its own timeout).  A two-rank ``compute_metrics`` equals the
single-process one; a two-rank stage-2 step on ``train_objective.npz``'s
weights, batch and injected t and noise equals the single-process step on
the whole batch and holds the JAX trainer's step at
``tests/test_torch_train.py``'s bounds; the model axis is refused; and the
multichip dry run runs."""
import json
import os

import numpy as np
import pytest
import torch

from skeletondiffusion_tpu_torch.data import make_synthetic_amass
from skeletondiffusion_tpu_torch.parallel import (DataMesh, all_reduce_mean, create_mesh,
                                                  shard_batch)
from skeletondiffusion_tpu_torch.parallel.dryrun import (dryrun_multichip, eval_metrics,
                                                         run_ranks, stage2_step, tiny_spec)
from skeletondiffusion_tpu_torch.weights import flatten_params
from test_torch_train import ARCH, jax_stage2_steps, port_pair, skeleton_kw

GOLD = os.path.join(os.path.dirname(__file__), "goldens", "train_objective.npz")
RANKS_TIMEOUT_S = 240.0


def test_rows_of_a_rank_and_the_refusals():
    mesh = DataMesh(2, 1, torch.device("cpu"))
    assert mesh.rows(6) == (3, 6)
    x = torch.arange(12.0).reshape(6, 2)
    got = shard_batch(mesh, {"x": x, "pair": (x, None), "n": 3})
    assert torch.equal(got["x"], x[3:]) and got["pair"][1] is None and got["n"] == 3
    with pytest.raises(ValueError, match="does not split over the data axis of 2"):
        mesh.rows(5)
    # the 2-D mesh: the model axis must divide the ranks, which must be the processes
    with pytest.raises(ValueError, match="model_parallel=2 does not divide a mesh of 1 devices"):
        create_mesh(1, model_parallel=2, device="cpu")
    with pytest.raises(ValueError, match="needs 4 processes"):
        create_mesh(4, model_parallel=2, device="cpu")
    with pytest.raises(ValueError, match="needs 2 processes"):
        create_mesh(2, device="cpu")
    one = create_mesh(device="cpu")
    t = torch.ones(3)
    all_reduce_mean(one, [t])  # one rank: nothing to combine
    assert one.size == 1 and torch.equal(t, torch.ones(3))


def test_two_rank_eval_equals_the_single_process_eval(tmp_path):
    """Probabilistic table, CMD and APDE over the synthetic DFaust split in
    batches of 4 (the last one padded): each rank samples its 2 rows with
    the whole batch's noise, the per-item values are gathered."""
    root = make_synthetic_amass(str(tmp_path), seed=2, files_per_dataset=3, clip_len=75)
    pre, ann = f"{root}/processed/AMASS/hmp/", f"{root}/annotations/AMASS/hmp/"
    spec = tiny_spec(seed=4)
    spec["skeleton"].update(pred_length=15, pose_box_size=1.1)
    spec["samples"] = 3
    dataset_kw = dict(datasets=["DFaust"], split="test", precomputed_folder=pre,
                      segments_path=ann + "segments_test.csv", obs_length=6, pred_length=15,
                      if_consider_hip=False, if_load_mmgt=True, if_compute_cmd=True,
                      silent=True)
    metrics_kw = dict(batch_size=4, stats_mode="probabilistic", if_compute_cmd=True,
                      if_compute_apde=True, mmapd_gt_path=ann + "mmapd_GT.csv", seed=3)
    ranks = run_ranks(eval_metrics, 2, spec, dataset_kw, metrics_kw, device="cpu",
                      timeout_s=RANKS_TIMEOUT_S, threads=1)
    one = eval_metrics(None, spec, dataset_kw, metrics_kw)
    assert set(one) >= {"APD", "ADE", "FDE", "MMADE", "MMFDE", "CMD", "APDE"}
    for results in ranks:
        assert results.keys() == one.keys()
        for k, v in one.items():
            assert abs(results[k] - v) <= 1e-6 * max(1.0, abs(v)), (k, results[k], v)


@pytest.fixture(scope="module")
def golden_step():
    """``train_objective.npz``'s models as a rank spec, its batch and the
    first step's injected t and noise, and the flax trees of its weights."""
    from skeletondiffusion_tpu.utils.torch_port import port_autoencoder, port_denoiser

    golden = np.load(GOLD, allow_pickle=False)
    cfg = json.loads(str(golden["config_json"]))

    def sd(prefix):
        return {k[len(prefix):]: golden[k] for k in golden.files if k.startswith(prefix)}

    flax_trees = {"ae": {"params": port_autoencoder(sd("ae."))},
                  "den": {"params": port_denoiser(sd("den."), depth=2)}}
    _, ae, engine = port_pair(golden, cfg, flax_trees)
    spec = {"seed": 0, "latent": cfg["latent"], "hidden": cfg["hidden"],
            "timesteps": cfg["t_diff"], "arch": dict(ARCH), "skeleton": skeleton_kw(cfg),
            "ae_state": ae.state_dict(), "den_state": engine.denoiser.state_dict(),
            "cov": (golden["cov_Sigma_N"], golden["cov_Lambda_N"], golden["cov_U"]),
            "trainer": dict(lr=1e-3, weight_decay=0.01,
                            train_pick_best_sample_among_k=cfg["k"],
                            similarity_space="input_space")}
    return dict(golden=golden, cfg=cfg, flax_trees=flax_trees, spec=spec,
                batch=(torch.from_numpy(golden["x"]), torch.from_numpy(golden["y"]),
                       torch.from_numpy(golden["opt_t_steps"][0]),
                       torch.from_numpy(golden["opt_noise_steps"][0])))


def test_two_rank_stage2_step_equals_one_process_and_the_jax_trainer(golden_step):
    g = golden_step
    lr = g["spec"]["trainer"]["lr"]
    ranks = run_ranks(stage2_step, 2, g["spec"], *g["batch"], device="cpu",
                      timeout_s=RANKS_TIMEOUT_S, threads=1)
    one = stage2_step(None, g["spec"], *g["batch"])
    for r in ranks:
        for key in ("loss", "grad_norm"):
            assert abs(r[key] - one[key]) <= 1e-6 * max(1.0, abs(one[key])), (key, r, one)
        # the two half-batch gradients are summed in another order, and Adam's
        # first step g/(|g| + ε) turns a gradient near ε into a step anywhere
        # within ±lr: the parameters agree to lr/1000
        for k, v in r["params"].items():
            torch.testing.assert_close(v, one["params"][k], rtol=0, atol=1e-3 * lr)
    golden = g["golden"]
    jl, jg, _, jparams = jax_stage2_steps(golden, g["cfg"], g["flax_trees"],
                                          golden["opt_t_steps"][:1],
                                          golden["opt_noise_steps"][:1], lr)
    np.testing.assert_allclose(ranks[0]["loss"], jl[0], rtol=5e-4)
    np.testing.assert_allclose(ranks[0]["grad_norm"], jg[0], rtol=1e-3)
    want = flatten_params(jparams)
    assert want.keys() == ranks[0]["params"].keys()
    for name, v in want.items():
        np.testing.assert_allclose(ranks[0]["params"][name].numpy(), v.numpy(), atol=3 * lr,
                                   rtol=0, err_msg=name)


def test_dryrun_multichip_runs_two_ranks():
    out = dryrun_multichip(2)
    assert len(out["ranks"]) == 2
    assert out["ranks"][0]["loss"] == pytest.approx(out["one_process"]["loss"], rel=1e-5)
