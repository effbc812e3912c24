"""Small models on the card: K1 at every hidden width the Pallas rollout
takes, and the bf16 denoiser routed by width.

- K1's plain version against ``gru_rollout_pallas`` in interpret mode at
  hidden 16, 32, 64 and 128 (the Pallas kernel pads every width to its
  128-lane blocks);
- ``rollout_plan`` at every multiple of 16 from 16 to 128 and every node
  count the skeletons have, the flagship's plan pinned as it was; the plan's
  bytes piece by piece as ``layout`` in ``csrc/gru_rollout.cu`` places them;
  the refusals name ROADMAP Queue B item 9;
- the bank packed into ring stages at slices of 16 (no chunk swap) and 32;
- the wrapper asks for the library built at the tensors' hidden width, and
  ``build`` builds the rollout's source alone at a width other than 96 with
  ``-DSKD_HIDDEN``;
- the route: ``denoiser_fused.chain_refusal`` on the card takes a denoiser
  exactly where every plan of the chain does (``chain_plans``), and a
  predictor decides it once, at construction.

The kernels run only on the card: ``chip_smoke.py``'s ``small`` phase holds
K1 at these widths against its plain version.
"""
import os
import pathlib
import stat

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skeletondiffusion_tpu.ops.pallas.gru_rollout import gru_rollout_pallas
from skeletondiffusion_tpu_torch.models.denoiser import Denoiser
from skeletondiffusion_tpu_torch.ops.graph_linear import l1_normalize_rows
from skeletondiffusion_tpu_torch.ops.kernels import build, denoiser_fused
from skeletondiffusion_tpu_torch.ops.kernels import gru_rollout as rollout
from skeletondiffusion_tpu_torch.ops.kernels import node_mix_sm90 as engine

WIDTHS = tuple(range(16, 129, 16))
COUNTS = (16, 17, 21, 51)
F = 3


def _inputs(rng, n, b, h):
    def r(*s, sc=0.3):
        return sc * rng.standard_normal(s, dtype=np.float32)

    def g():
        return np.asarray(l1_normalize_rows(torch.eye(n) + 0.2 * torch.from_numpy(
            rng.random((n, n), dtype=np.float32))))

    return dict(cx=r(n, b, 3 * h), h0=r(n, b, h, sc=0.5), w_hh=r(n, h, 3 * h, sc=h ** -0.5),
                b_hh=r(n, 3 * h, sc=0.1), g0=g(), g_add=0.05 * g(), w_fc=r(n, h, F, sc=h ** -0.5),
                b_fc=r(n, F, sc=0.1), g_fc=g())


@pytest.mark.parametrize("h", [16, 32, 64, 128])
def test_plain_rollout_matches_the_pallas_kernel_at_every_width(h):
    """The fp32 wrapper (its plain version on the CPU) against the Pallas
    kernel in interpret mode, 21 nodes, 8 rows, 10 steps."""
    inp = _inputs(np.random.default_rng(h), 21, 8, h)
    want = gru_rollout_pallas(**{k: jnp.asarray(v) for k, v in inp.items()}, ph=10,
                              batch_tile=8, interpret=True)
    got = rollout.gru_rollout(**{k: torch.from_numpy(v) for k, v in inp.items()}, ph=10)
    assert got.shape == want.shape == (10, 21, 8, F)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


def _layout_bytes(n, h, stages):
    """One block's shared memory, piece by piece as ``layout`` in
    ``csrc/gru_rollout.cu`` places it at n nodes and hidden width h."""
    rows, k_rows = (2, 2) if n > 21 else (8, 4)
    s = 32 if h in (32, 64, 96) else 16          # the slice
    split = 256 // (rows * s)                    # mix threads a position
    g_row = -(-max(n, split * -(-n // split)) // 4) * 4
    ring = stages * 4 * k_rows * n * 3 * s       # bank rows × nodes × r|z|n columns
    hb = 4 * n * (rows * (h + 4) + 4)            # h, rows and planes one bank quad on
    p = 4 * n * 4 * rows * s                     # r, z, n_h, n_x areas of a slice
    return 128 + ring + hb + p + 4 * 3 * n * g_row


@pytest.mark.parametrize("n", COUNTS)
@pytest.mark.parametrize("h", WIDTHS)
def test_rollout_plan_at_every_width_and_count(n, h):
    plan = rollout.rollout_plan(n, h)
    assert plan.smem_bytes == _layout_bytes(n, h, plan.stages) <= engine.MAX_SMEM
    assert plan.stages == rollout.ROLLOUT_MAX_STAGES or (
        _layout_bytes(n, h, plan.stages + 1) > engine.MAX_SMEM)
    assert plan.slice == rollout.rollout_slice(h) and h % plan.slice == 0
    assert plan.rows * plan.cluster == (8 if n > 21 else 32)
    # a stage holds W_fc's nodes of a stage whole, each block's part of it
    # whole 16-byte chunks
    stage = 4 * (2 if n > 21 else 4) * n * 3 * plan.slice
    assert stage % (16 * plan.cluster) == 0 and (4 * h * F) % (16 * plan.cluster) == 0
    assert 4 * h * F <= stage


def test_the_flagship_plans_are_as_they_were():
    assert tuple(rollout.rollout_plan(21, 96)) == (8, 32, 2, 4, 224240)
    assert tuple(rollout.rollout_plan(51, 96)) == (2, 32, 2, 4, 204128)
    assert rollout.rollout_g_row(21, 96) == 24 and rollout.rollout_g_row(51, 96) == 52
    assert rollout.chunk_swap(96) == 4


@pytest.mark.parametrize("h, f", [(8, 3), (40, 3), (144, 3), (96, 4)])
def test_rollout_plan_refuses_what_the_kernel_is_not_built_for(h, f):
    with pytest.raises(ValueError, match="Queue B item 9" if f == 3 else "3 outputs"):
        rollout.rollout_plan(21, h, f)


@pytest.mark.parametrize("h", [16, 48, 128])
def test_each_stage_of_the_packed_bank_is_the_bank_rows_the_kernel_reads(h):
    """Stage ks of slice J holds bank rows 4·ks … 4·ks + 3, each the nodes'
    r, z and n columns of the slice (16 columns, chunks unswapped: a row is
    12 chunks, not whole groups of 8)."""
    n, s = 21, rollout.rollout_slice(h)
    assert s == 16 and rollout.chunk_swap(h) == 0
    w = torch.from_numpy(np.random.default_rng(h).standard_normal((n, h, 3 * h),
                                                                   dtype=np.float32))
    packed = rollout.pack_rollout_bank(w)
    assert packed.shape == (h // s, h * n * 3 * s) and packed.is_contiguous()
    cols = torch.arange(3 * s)
    for j in range(h // s):
        rows = packed[j].reshape(h, n, 3 * s)
        gate_col = (cols // s) * h + j * s + cols % s  # r | z | n
        for m in range(n):
            assert torch.equal(rows[:, m], w[m][:, gate_col])


def test_the_wrapper_asks_for_the_library_of_its_width(monkeypatch):
    calls = []

    def recording(library, symbol, n_pointers, n_ints, nodes=21, hidden=96):
        def entry(*args):
            calls.append((library, symbol, nodes, hidden, args[n_pointers:-1]))
            return 0
        return entry

    monkeypatch.setattr(build, "kernel_device", lambda **tensors: "cuda")
    monkeypatch.setattr(build, "c_entry", recording)
    monkeypatch.setattr(build, "stream_of", lambda t: 0)
    inp = {k: torch.from_numpy(v) for k, v in _inputs(np.random.default_rng(0), 21, 4, 16).items()}
    before = rollout.launches
    out = rollout.gru_rollout(**inp, ph=3)
    assert rollout.launches == before + 1 and out.shape == (3, 21, 4, F)
    (library, symbol, nodes, hidden, ints), = calls
    assert (library, symbol, nodes, hidden) == ("gru_rollout", "gru_rollout_f32", 21, 16)
    assert ints == (21, 4, 16, F, 3, *rollout.rollout_plan(21, 16))


FAKE_NVCC = """#!/bin/sh
echo "$@" | tr ' ' '\\n' > "$(dirname "$0")/args.$$"
while [ $# -gt 0 ]; do
  if [ "$1" = "-o" ]; then echo lib > "$2"; fi
  shift
done
"""


def test_build_builds_the_rollout_alone_at_another_width(tmp_path, monkeypatch):
    home = tmp_path / "cuda"
    (home / "bin").mkdir(parents=True)
    nvcc = home / "bin" / "nvcc"
    nvcc.write_text(FAKE_NVCC)
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("CUDA_HOME", str(home))
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for name in ("resnet_block", "gru_rollout", "gru_rollout_merged"):
        (csrc / f"{name}.cu").write_text(f"// {name}\n")
    monkeypatch.setattr(build, "CSRC_DIR", csrc)
    monkeypatch.setattr(build, "BUILD_ROOT", tmp_path / "build")
    build.build_all((21,), ((21, 16), (21, 96), (51, 128)))
    calls = sorted(p.read_text().split() for p in (home / "bin").glob("args.*"))
    flags = sorted((pathlib.Path(a[-1]).name, tuple(x for x in a if x.startswith("-DSKD")))
                   for a in calls)
    assert flags == sorted([(f"{s}.cu", ("-DSKD_NODES=21",)) for s in
                            ("resnet_block", "gru_rollout", "gru_rollout_merged")] +
                           [("gru_rollout.cu", ("-DSKD_NODES=21", "-DSKD_HIDDEN=16")),
                            ("gru_rollout.cu", ("-DSKD_NODES=51", "-DSKD_HIDDEN=128"))])
    assert build.build_dir(21, 16) != build.build_dir(21) == build.build_dir(21, 96)
    assert build.library_path("gru_rollout", 51, 128).is_file()
    for p in (home / "bin").glob("args.*"):
        os.remove(p)
    assert build.build_all((21,), ((21, 16),)) == 0.0


def test_library_refuses_a_width_before_building(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(build, "build_all", lambda *a: pytest.fail("built"))
    with pytest.raises(ValueError, match="got 40 .*Queue B item 9"):
        build.library("gru_rollout", 21, 40)


def _denoiser(dim, heads, dim_head, depth=1, n=21):
    return Denoiser(dim=dim, out_dim=dim, channels=n, generator=torch.Generator().manual_seed(0),
                    cond_dim=dim, depth=depth, attn_heads=heads, attn_dim_head=dim_head,
                    compute_dtype=torch.bfloat16)


CUDA = torch.device("cuda")


@pytest.mark.parametrize("n", [16, 21, 51])
@pytest.mark.parametrize("dim, heads, dim_head", [
    (96, 8, 32), (16, 2, 4), (32, 2, 32), (32, 4, 16), (48, 2, 32), (64, 1, 32), (128, 4, 32),
    (24, 2, 32), (160, 2, 32)])
def test_the_route_is_the_plans(n, dim, heads, dim_head):
    """On the card the chain takes a denoiser exactly where every kernel's
    plan takes its widths; a refusal is the first plan's message."""
    den = _denoiser(dim, heads, dim_head, n=n)
    refusal = denoiser_fused.chain_refusal(den, CUDA)
    try:
        plans = denoiser_fused.chain_plans(den)
    except ValueError as e:
        assert refusal == str(e)
    else:
        assert refusal is None and len(plans) == 10
        assert all(p.smem_bytes <= engine.MAX_SMEM for p in plans)
    # the flagship's widths, and those of the JAX quickstart
    if (dim, heads, dim_head) == (96, 8, 32):
        assert refusal is None
    if (dim, heads, dim_head) == (16, 2, 4):  # F 32 → 64, heads of 4 → 16 (zero-padded)
        assert refusal is None
    # on the CPU every kernel of the chain is its plain version
    assert denoiser_fused.chain_refusal(den, torch.device("cpu")) is None


def test_the_route_keeps_the_jax_conditions():
    den = _denoiser(96, 8, 32)
    den.compute_dtype = torch.float32
    assert "bf16" in denoiser_fused.chain_refusal(den, CUDA)
    den.compute_dtype, den.use_attention = torch.bfloat16, False
    assert "attention" in denoiser_fused.chain_refusal(den, CUDA)


def test_the_predictor_routes_once_at_construction(monkeypatch):
    """The predictor asks ``chain_refusal`` once, for its device, and keeps
    the answer: use_fused_denoiser and fused_denoiser_refusal."""
    from skeletondiffusion_tpu_torch import eval_pipeline
    from torch_parity import port_models, skeletons
    from torch_parity import jax_models

    jsk, sk = skeletons()
    _, ae_params, _, _, den_params = jax_models(jsk, compute_dtype="bfloat16")
    ae, engine_, _ = port_models(sk, ae_params, den_params, compute_dtype="bfloat16")
    asked = []
    reason = "graph_linear_fused: F=32 must be a positive multiple of 64 up to 256"

    def refusal(den, device):
        asked.append(device)
        return reason

    monkeypatch.setattr(eval_pipeline, "chain_refusal", refusal)
    p = eval_pipeline.SkeletonDiffusionPredictor(sk, ae, engine_, num_samples=2, pred_length=4,
                                                 device="cpu")
    assert asked == [torch.device("cpu")]
    assert not p.use_fused_denoiser and p.fused_denoiser_refusal == reason
    assert p.diffusion.fused is None
