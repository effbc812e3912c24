"""The port against the reference's own outputs, with the reference's own
weight names.

``utils/torch_port.py`` loads a reference ``state_dict`` (as stored in
``tests/goldens/denoiser_fwd.npz`` and ``autoencoder_fwd.npz``: the
reference modules at their ``torch.manual_seed(0)`` init, full width) into
the port's ``Denoiser`` and ``AutoEncoder``; their forwards meet the stored
outputs at the JAX test's tolerances (``tests/test_network_parity.py``).
The AMASS-22 tables meet ``skeleton_tables.npz``, ``cov_amass.npz`` and
``schedules.npz`` where ``tests/test_skeleton_goldens.py`` and
``tests/test_diffusion_goldens.py`` hold the JAX package to them.  CPU
only: the goldens stay off the card.
"""
import json
import os

import numpy as np
import pytest
import torch

from skeletondiffusion_tpu_torch.diffusion.covariance import get_cov_from_corr
from skeletondiffusion_tpu_torch.diffusion.schedules import (
    cosine_beta_schedule,
    exp_beta_schedule,
    linear_beta_schedule,
)
from skeletondiffusion_tpu_torch.models import AutoEncoder, Denoiser
from skeletondiffusion_tpu_torch.models.autoencoder import autoencoder_loss
from skeletondiffusion_tpu_torch.skeleton import create_skeleton
from skeletondiffusion_tpu_torch.utils.torch_port import (
    load_reference_autoencoder,
    load_reference_denoiser,
)

GOLD = os.path.join(os.path.dirname(__file__), "goldens")
INPUTS = ("x", "t", "cond", "out", "past", "fut", "z_past", "z", "dec", "loss_none")


def golden(name):
    return np.load(os.path.join(GOLD, name), allow_pickle=False)


def reference_state_dict(g):
    return {k: g[k] for k in g.files if k not in INPUTS}


@pytest.fixture(scope="module")
def skeleton():
    return create_skeleton(dataset_name="amass", motion_repr_type="SkeletonRescalePose",
                           num_joints=22, pose_box_size=1.5, obs_length=30, pred_length=120,
                           if_consider_hip=False)


def test_denoiser_from_reference_names_meets_golden(skeleton):
    g = golden("denoiser_fwd.npz")
    assert g["init_lin.weight"].shape == (13, 192, 192)
    den = Denoiser(96, 96, skeleton.num_nodes, torch.Generator().manual_seed(1), cond_dim=96,
                   depth=4, node_types=skeleton.nodes_type_id, learn_influence=True,
                   attn_dim_head=32, attn_heads=8)
    load_reference_denoiser(den, reference_state_dict(g))
    x, t, cond = (torch.from_numpy(g[k]) for k in ("x", "t", "cond"))
    with torch.no_grad():
        out = den(x.transpose(0, 1), t, den.cond_embedding(cond)).transpose(0, 1)
    np.testing.assert_allclose(out.numpy(), g["out"], atol=2e-4)


def test_autoencoder_from_reference_names_meets_golden(skeleton):
    g = golden("autoencoder_fwd.npz")
    ae = AutoEncoder(skeleton.num_nodes, 96, 96, 96, torch.Generator().manual_seed(1),
                     node_types=skeleton.nodes_type_id)
    load_reference_autoencoder(ae, reference_state_dict(g))
    past, fut = torch.from_numpy(g["past"]), torch.from_numpy(g["fut"])
    ph = fut.shape[1]
    with torch.no_grad():
        out, z_past, z = ae.autoencode(fut, past, ph=ph)
        dec = ae.decode(past, z, ph)
    np.testing.assert_allclose(z.numpy(), g["z"], atol=1e-4)
    np.testing.assert_allclose(z_past.numpy(), g["z_past"], atol=1e-4)
    np.testing.assert_allclose(out.numpy(), g["out"], atol=1e-3)
    np.testing.assert_allclose(dec.numpy(), g["dec"], atol=1e-3)
    loss = autoencoder_loss(out, fut, loss_type="l1", reduction="none")
    np.testing.assert_allclose(loss.numpy(), g["loss_none"], atol=1e-3)


def test_reference_loader_is_strict(skeleton):
    """A name the module lacks, or one it leaves unloaded, raises."""
    g = golden("autoencoder_fwd.npz")
    sd = reference_state_dict(g)
    ae = AutoEncoder(skeleton.num_nodes, 96, 96, 96, torch.Generator().manual_seed(1),
                     node_types=skeleton.nodes_type_id)
    with pytest.raises(KeyError):
        load_reference_autoencoder(ae, {k: v for k, v in sd.items() if k != "decoder.fc.weight"})
    with pytest.raises(RuntimeError, match="decoder.rollout.fc.bias"):
        load_reference_autoencoder(ae, {k: v for k, v in sd.items() if k != "decoder.fc.bias"})
    small = AutoEncoder(skeleton.num_nodes, 16, 16, 16, torch.Generator().manual_seed(1),
                        node_types=skeleton.nodes_type_id)
    with pytest.raises(RuntimeError):
        load_reference_autoencoder(small, sd)


def test_amass22_tables_meet_golden(skeleton):
    g = golden("skeleton_tables.npz")
    assert skeleton.num_nodes == int(g["amass22_num_nodes"])
    np.testing.assert_array_equal(np.asarray(skeleton.adj_matrix), g["amass22_adj"])
    np.testing.assert_allclose(np.asarray(skeleton.reachability_matrix(factor=0.5, stop_at="hips"),
                                          dtype=np.float64), g["amass22_reach"], atol=0, rtol=0)
    np.testing.assert_array_equal(np.asarray(skeleton.nodes_type_id, dtype=np.int64),
                                  g["amass22_node_types"])
    np.testing.assert_array_equal(np.asarray(skeleton.get_limbseq(), dtype=np.int64),
                                  g["amass22_limbseq"])
    np.testing.assert_array_equal(np.asarray(skeleton.limbseq, dtype=np.int64),
                                  g["amass22_metric_limbseq"])
    np.testing.assert_array_equal(np.asarray(skeleton.left_right_limb, dtype=bool),
                                  g["amass22_left_right"])
    assert ([list(r) for r in skeleton.limb_angles_idx]
            == json.loads(str(g["amass22_limb_angles_idx"])))


def test_amass22_covariance_meets_golden(skeleton):
    g = golden("cov_amass.npz")
    np.testing.assert_allclose(skeleton.adj_matrix, g["corr"], atol=0)
    Sigma_N, Lambda_N, U = get_cov_from_corr(skeleton.adj_matrix)
    np.testing.assert_allclose(Sigma_N, g["Sigma_N"], atol=1e-5)
    np.testing.assert_allclose(Lambda_N, g["Lambda_N"], atol=1e-5)
    signs = np.sign(np.sum(U * g["U"], axis=0))  # eigenvectors up to their sign
    np.testing.assert_allclose(U * signs, g["U"], atol=1e-4)


def test_beta_schedules_meet_golden():
    g = golden("schedules.npz")
    np.testing.assert_allclose(cosine_beta_schedule(10), g["cosine_T10"], atol=1e-12)
    np.testing.assert_allclose(linear_beta_schedule(10), g["linear_T10"], atol=1e-12)
    np.testing.assert_allclose(cosine_beta_schedule(50), g["cosine_T50"], atol=1e-12)
    # the reference's exp schedule has T + 1 entries; the first T are used
    np.testing.assert_allclose(exp_beta_schedule(10, 3.0), g["exp_T10"][:10], atol=1e-12)
