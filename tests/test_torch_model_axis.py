"""The port's model axis (``parallel/mesh.py``: ``shard_params_model_axis``,
``model_columns``, ``model_whole``, ``clip_grad_norm_``) on the CPU.

* The split: on the same denoiser parameters, the port's
  ``shard_params_model_axis`` splits exactly the weights the JAX package's
  ``shard_params_model_axis`` puts on the 'model' axis (its device placement
  recorded instead of made: one CPU device cannot hold a mesh of two), at
  ``min_size`` 2¹⁶ (the default), 1 024 (the dry run's) and 16 (the JAX
  test's).
* A 2 × 2 mesh of four gloo ranks (one spawn, ``dryrun_multichip(4)``):
  the ranks' coordinates, the split weights' shapes, and a stage-2 step with
  the banks split over the model axis equal to the one-process step on the
  whole batch, loss within 2e-5 relative and parameters within 2e-5 (the
  bounds of the JAX package's ``tests/test_parallel.py``).
* What stays on the data axis refuses a model axis, naming what it lacks.
"""
import types
from unittest import mock

import jax
import pytest
import torch

from skeletondiffusion_tpu.parallel import mesh as jax_mesh
from skeletondiffusion_tpu_torch.eval_pipeline import compute_metrics
from skeletondiffusion_tpu_torch.ops.kernels.denoiser_fused import prep_fused_denoiser
from skeletondiffusion_tpu_torch.parallel import (DataMesh, model_columns, model_whole,
                                                  shard_params_model_axis,
                                                  splits_on_model_axis)
from skeletondiffusion_tpu_torch.parallel.dryrun import dryrun_multichip
from skeletondiffusion_tpu_torch.serving import export_predictor
from skeletondiffusion_tpu_torch.train.ema import ema_init

from torch_parity import ARCH, jax_models, port_models, skeletons


def _jax_split(den_params, model: int, min_size: int) -> set:
    """The names of the weights the JAX rule puts on the 'model' axis."""
    fake_mesh = types.SimpleNamespace(shape={"model": model})
    with mock.patch.object(jax_mesh, "NamedSharding", lambda mesh, spec: spec), \
            mock.patch.object(jax_mesh.jax, "device_put", lambda x, spec: spec):
        specs = jax_mesh.shard_params_model_axis(fake_mesh, den_params, min_size=min_size)
    flat = jax.tree_util.tree_flatten_with_path(
        specs["params"], is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    return {".".join(k.key for k in path) for path, spec in flat
            if len(spec) and spec[-1] == "model"}


@pytest.mark.parametrize("min_size", [2**16, 1024, 16])
def test_the_split_follows_the_jax_rule(min_size):
    jsk, sk = skeletons()
    arch = {**ARCH, "depth": 2}
    _, ae_params, _, _, den_params = jax_models(jsk, arch=arch)
    _, _, den = port_models(sk, ae_params, den_params, arch=arch)
    whole = {k: tuple(p.shape) for k, p in den.named_parameters()}
    mesh = DataMesh(1, 0, torch.device("cpu"), model=2, model_rank=1)
    split = shard_params_model_axis(mesh, den, min_size=min_size)
    want = _jax_split(den_params, 2, min_size)
    assert set(split) == want and (want or min_size == 2**16)
    for name, p in den.named_parameters():
        assert split.get(name, whole[name]) == whole[name]
        shape = whole[name][:-1] + (whole[name][-1] // 2,) if name in split else whole[name]
        assert tuple(p.shape) == shape, name
        assert splits_on_model_axis(whole[name], 2, min_size) == (name in split)
    # a split layer computes with its slice only through the model axis's
    # collectives: its module records the slice for model_columns/model_whole,
    # and the EMA's copy (a deep copy) holds the same slices and records
    lin = den.init_lin
    assert ("init_lin.weight" in split) == (getattr(lin, "_model_shards", {}).get("weight")
                                           is not None)
    ema = ema_init(den).module
    for (name, p), (_, e) in zip(den.named_parameters(), ema.named_parameters()):
        assert e.shape == p.shape and torch.equal(e, p), name
    assert ema.init_lin.__dict__.get("_model_shards") == lin.__dict__.get("_model_shards")


def test_two_by_two_mesh_step_equals_the_one_process_step():
    out = dryrun_multichip(4)
    one = out["one_process"]
    ranks = out["ranks"]
    # rank r is data index r // 2 and model index r % 2 of a 2 × 2 mesh; the
    # first rank alone writes
    assert [r["mesh"] for r in ranks] == [(2, r // 2, 2, r % 2) for r in range(4)]
    assert [DataMesh(*m[:2], torch.device("cpu"), *m[2:]).first
            for m in (r["mesh"] for r in ranks)] == [True, False, False, False]
    for r in ranks:
        assert abs(r["loss"] - one["loss"]) <= 2e-5 * abs(one["loss"])
        assert abs(r["grad_norm"] - one["grad_norm"]) <= 2e-5 * abs(one["grad_norm"])
        assert r["param_max_diff"] <= 2e-5
        assert r["split"] == ranks[0]["split"] and r["split"]
        for name, (whole, local) in r["split"].items():
            assert splits_on_model_axis(whole, 2, 1024), name
            assert local == whole[:-1] + (whole[-1] // 2,), name


def test_what_stays_on_the_data_axis_refuses_a_model_axis():
    mesh = DataMesh(1, 0, torch.device("cpu"), model=2, model_rank=0)
    for call, what in ((lambda: compute_metrics(None, None, None, mesh=mesh), "compute_metrics"),
                       (lambda: export_predictor(None, "/nonexistent", 4, mesh=mesh),
                        "export_predictor")):
        with pytest.raises(NotImplementedError, match=f"{what} on a mesh with a model axis"):
            call()
    jsk, sk = skeletons()
    _, ae_params, _, _, den_params = jax_models(jsk)
    _, _, den = port_models(sk, ae_params, den_params)
    shard_params_model_axis(mesh, den, min_size=16)
    with pytest.raises(NotImplementedError, match="fused denoiser kernels.*model axis"):
        prep_fused_denoiser(den)
    # without a slice the helpers are the plain product and the parameter
    lin = port_models(sk, ae_params, den_params)[2].init_lin
    x = torch.randn(3, 4)
    assert model_whole(lin, "bias") is lin.bias
    assert torch.equal(model_columns(lin, "weight", x, lambda a: 2 * a), 2 * x)
