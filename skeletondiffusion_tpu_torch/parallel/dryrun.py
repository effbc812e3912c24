"""The multichip dry run, the torch twin of the root ``__graft_entry__.py``:
``entry()`` gives one flagship denoiser step with example arguments, and
``dryrun_multichip(n)`` runs one stage-2 training step over a mesh of ``n``
ranks (gloo; on the CPU unless ``device`` says otherwise): a data axis, and
for an even n ≥ 4 a model axis of 2 with the weight banks split over it
(``shard_params_model_axis`` at ``min_size=1024``, as the JAX dry run), and
holds it against the same step in one process on the whole batch.

``run_ranks`` starts the ranks: ``n`` spawned processes joined over
``tcp://localhost:<free port>``, each calling ``fn(mesh, *args)`` on its
``parallel.DataMesh``; it returns their results in rank order and stops
every process it started.  ``stage2_step`` and ``eval_metrics`` are the
rank functions of the dry run, the tests and chip_smoke: models built from
a ``spec`` (a seed, widths and, optionally, state_dicts to load), so that
every rank holds the same weights without a broadcast.
"""
from __future__ import annotations

import multiprocessing
import os
import pickle
import queue
import socket
import time
import traceback
from typing import Any, Callable, Dict, List, Optional

import torch
import torch.distributed as dist

from .mesh import (DataMesh, create_mesh, gather_columns, maybe_initialize_distributed,
                   shard_batch, shard_params_model_axis)

ARCH = {"depth": 1, "attn_heads": 2, "attn_dim_head": 4, "use_attention": True,
        "learn_influence": True, "self_condition": False, "norm_type": "none"}


def tiny_spec(seed: int = 0) -> Dict[str, Any]:
    """The dry run's model: the AMASS skeleton (21 nodes, observe 6, predict
    10), latent and hidden 16, denoiser depth 1 × 2 heads × 4, 4 diffusion
    steps, k = 3 samples an item in input space."""
    return {"seed": seed, "latent": 16, "hidden": 16, "timesteps": 4, "arch": dict(ARCH),
            "skeleton": dict(dataset_name="amass", motion_repr_type="SkeletonRescalePose",
                             num_joints=22, pose_box_size=1.5, obs_length=6, pred_length=10,
                             if_consider_hip=False),
            "trainer": dict(lr=1e-3, weight_decay=0.01, train_pick_best_sample_among_k=3,
                            similarity_space="input_space")}


def build_models(spec: Dict[str, Any], device):
    """(skeleton, AutoEncoder, engine) of ``spec`` on ``device``: weights drawn
    from ``spec["seed"]``, then ``ae_state``/``den_state`` loaded where given;
    the process from ``cov`` (Σ_N, Λ_N, U) where given (an eigensystem is
    unique only up to column signs)."""
    from ..diffusion.engine import GaussianDiffusion
    from ..diffusion.manager import create_diffusion
    from ..diffusion.process import build_nonisotropic_process
    from ..models import AutoEncoder
    from ..skeleton import create_skeleton

    sk = create_skeleton(**spec["skeleton"])
    gen = torch.Generator().manual_seed(spec["seed"])
    dtype = spec.get("compute_dtype")
    ae = AutoEncoder(sk.num_nodes, spec["hidden"], spec["hidden"], spec["latent"], gen,
                     node_types=sk.nodes_type_id, compute_dtype=dtype)
    engine, den = create_diffusion(sk, gen, latent_size=spec["latent"],
                                   diffusion_timesteps=spec["timesteps"],
                                   diffusion_arch=dict(spec["arch"]), device=device,
                                   compute_dtype=dtype)
    if spec.get("ae_state") is not None:
        ae.load_state_dict(spec["ae_state"])
    if spec.get("den_state") is not None:
        den.load_state_dict(spec["den_state"])
    if spec.get("cov") is not None:
        process = build_nonisotropic_process(*spec["cov"], timesteps=spec["timesteps"],
                                             device=device)
        engine = GaussianDiffusion(process, den, channels=sk.num_nodes,
                                   latent_size=spec["latent"])
    return sk, ae.to(device), engine


def stage2_step(mesh: Optional[DataMesh], spec: Dict[str, Any], x: torch.Tensor,
                y: torch.Tensor, t: Optional[torch.Tensor] = None,
                noise: Optional[torch.Tensor] = None, seed: int = 0,
                device="cpu", model_min_size: int = 2**16) -> Dict[str, Any]:
    """One stage-2 step (``TrainerDiffusion.train_step``, no EMA) of
    ``spec``'s models on the whole batch x, y (input space), on this rank's
    rows of it: the timesteps and noise injected for the whole batch (t [B],
    noise [B·k,N,D]) or drawn from a generator seeded with ``seed``.  On a
    model axis the denoiser's weights that ``shard_params_model_axis``
    splits at ``model_min_size`` keep this rank's slice.  Returns the loss
    and gradient norm of the whole batch, the step's seconds (the train
    step alone, synchronised), the gradients the step took (clipped) and
    the denoiser's parameters after it, whole, on the CPU;
    the mesh's coordinates (data size and index, model size and index) and
    {name: (whole shape, slice shape)} of the split weights."""
    from ..train.trainer_diffusion import TrainerDiffusion

    device = mesh.device if mesh is not None else torch.device(device)
    sk, ae, engine = build_models(spec, device)
    tr = TrainerDiffusion(engine, ae, skeleton=sk, if_use_ema=False,
                          prediction_horizon_eval=spec["skeleton"]["pred_length"],
                          **spec["trainer"])
    x, y = x.to(device), y.to(device)
    t = None if t is None else t.to(device)
    noise = None if noise is None else noise.to(device)
    split = {}
    if mesh is not None and (mesh.size > 1 or mesh.model > 1):
        tr.mesh = mesh
        split = shard_params_model_axis(mesh, tr.denoiser, model_min_size)
        x, y, t = shard_batch(mesh, (x, y, t))
        if noise is not None:
            lo, hi = mesh.rows(noise.shape[0])
            noise = noise[lo:hi]
    gen = torch.Generator(device=device).manual_seed(seed)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    start = time.perf_counter()
    loss = tr.train_step((x, y), gen, t=t, noise=noise)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    step_s = time.perf_counter() - start

    def whole(t: torch.Tensor, shard) -> torch.Tensor:  # every rank gathers, in one order
        t = t.detach()
        return (t if shard is None else gather_columns(t, shard)).cpu()

    params = dict(tr.denoiser.named_parameters())
    shard_of = {k: getattr(p, "model_shard", None) for k, p in params.items()}
    return {"loss": float(loss), "grad_norm": float(tr.last_grad_norm), "step_s": step_s,
            "grads": {k: whole(p.grad, shard_of[k]) for k, p in params.items()
                      if p.grad is not None},
            "params": {k: whole(v, shard_of.get(k)) for k, v in tr.denoiser.state_dict().items()},
            "mesh": None if mesh is None else (mesh.size, mesh.rank, mesh.model,
                                               mesh.model_rank),
            "split": {k: (shape, tuple(params[k].shape)) for k, shape in split.items()}}


def eval_metrics(mesh: Optional[DataMesh], spec: Dict[str, Any], dataset_kw: Dict[str, Any],
                 metrics_kw: Dict[str, Any], device="cpu") -> Dict[str, float]:
    """``compute_metrics`` of ``spec``'s predictor (``spec["samples"]``
    samples, the skeleton's horizon) over ``AMASSDataset(**dataset_kw)``,
    over the data axis when there is one."""
    from ..data import AMASSDataset
    from ..eval_pipeline import SkeletonDiffusionPredictor, compute_metrics

    device = mesh.device if mesh is not None else torch.device(device)
    sk, ae, engine = build_models(spec, device)
    predictor = SkeletonDiffusionPredictor(sk, ae, engine, num_samples=spec["samples"],
                                           pred_length=spec["skeleton"]["pred_length"],
                                           device=device)
    dataset = AMASSDataset(skeleton=sk, **dataset_kw)
    return compute_metrics(predictor, dataset, sk, num_samples=spec["samples"], silent=True,
                           mesh=mesh if mesh is not None and mesh.size > 1 else None,
                           **metrics_kw)


def free_port() -> int:
    """A TCP port on localhost that nothing listens on now."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(fn: Callable, rank: int, world: int, port: int, device: str, threads: int,
               model_parallel: int, args: tuple, results) -> None:
    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port), RANK=str(rank),
                      LOCAL_RANK=str(rank), WORLD_SIZE=str(world))
    if threads:
        torch.set_num_threads(threads)
    try:
        maybe_initialize_distributed()
        # as bytes: a tensor put on the queue as it is would be shared by a file
        # descriptor that dies with this process
        value = pickle.dumps(fn(create_mesh(world, model_parallel, device=device), *args))
        results.put((rank, value, None))
    except Exception:  # the parent raises it with the rank's traceback
        results.put((rank, None, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(fn: Callable, world: int, *args, device: str = "cpu", timeout_s: float = 300.0,
              threads: int = 0, model_parallel: int = 1) -> List[Any]:
    """``fn(mesh, *args)`` in ``world`` spawned ranks of one gloo group on
    ``device`` (ranks share a card when there is one), on a mesh of
    ``model_parallel`` model ranks; their results in rank order.  ``fn`` and ``args`` are pickled (``fn`` by import path); a rank
    that raises, or no result within ``timeout_s``, raises here.  ``threads``
    caps each rank's CPU threads (0: torch's default)."""
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, rank, world, port, device, threads, model_parallel, args,
                               results))
             for rank in range(world)]
    for p in procs:
        p.start()
    out: Dict[int, Any] = {}
    deadline = time.monotonic() + timeout_s
    try:
        while len(out) < world:
            try:
                rank, value, error = results.get(timeout=max(0.1, deadline - time.monotonic()))
            except queue.Empty:
                raise TimeoutError(f"run_ranks: {world - len(out)} of {world} ranks gave no "
                                   f"result within {timeout_s} s") from None
            if error is not None:
                raise RuntimeError(f"rank {rank} of {world} failed:\n{error}")
            out[rank] = pickle.loads(value)
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join()
    return [out[r] for r in range(world)]


def entry(device="cuda"):
    """(fn, example_args): one denoiser evaluation with its posterior mean of
    the flagship (AMASS, 21 nodes, latent 96, depth 4 × 8 heads × 32, 10
    steps) at batch 8, on ``device``."""
    from ..diffusion.manager import create_diffusion
    from ..skeleton import create_skeleton

    sk = create_skeleton(dataset_name="amass", motion_repr_type="SkeletonRescalePose",
                         num_joints=22, pose_box_size=1.5, obs_length=30, pred_length=120,
                         if_consider_hip=False)
    engine, _ = create_diffusion(
        sk, torch.Generator().manual_seed(0), latent_size=96, diffusion_timesteps=10,
        diffusion_arch={"depth": 4, "attn_heads": 8, "attn_dim_head": 32,
                        "use_attention": True, "learn_influence": True,
                        "self_condition": False, "norm_type": "none"}, device=device)
    n, b = sk.num_nodes, 8
    x = torch.zeros((b, n, 96), device=engine.device)
    x_cond = torch.zeros((b, n, 96), device=engine.device)

    @torch.no_grad()
    def fn(x, t, x_cond):
        x0 = torch.clamp(engine.feed_model(x, t, x_cond), -1.0, 1.0)
        mean, _, _ = engine.process.q_posterior(x0, x, t)
        return mean

    return fn, (x, 5, x_cond)


def dryrun_multichip(n_devices: int, device: str = "cpu", seed: int = 0) -> Dict[str, Any]:
    """One stage-2 step of ``tiny_spec`` over ``n_devices`` ranks on a batch
    of 4·n_devices items, against the same step in one process on the whole
    batch: the loss, gradient norm and parameters within 1e-5 relative.  For
    an even n ≥ 4 the mesh has a model axis of 2 and the weights of at least
    1 024 elements are split over it (the JAX dry run's mesh and
    ``min_size``).  Returns both runs' loss and gradient norm, the ranks'
    mesh coordinates, the split weights' shapes and each rank's largest
    parameter difference from the one-process step."""
    spec = tiny_spec(seed)
    sk, b = spec["skeleton"], 4 * n_devices
    model = 2 if n_devices % 2 == 0 and n_devices >= 4 else 1
    gen = torch.Generator().manual_seed(seed + 1)
    x = 0.3 * torch.randn((b, sk["obs_length"], 21, 3), generator=gen)
    y = 0.3 * torch.randn((b, sk["pred_length"], 21, 3), generator=gen)
    ranks = run_ranks(stage2_step, n_devices, spec, x, y, None, None, seed, device, 1024,
                      device=device, threads=1 if device == "cpu" else 0, model_parallel=model)
    one = stage2_step(None, spec, x, y, seed=seed, device=device)
    for r in ranks:
        for key in ("loss", "grad_norm"):
            if abs(r[key] - one[key]) > 1e-5 * max(1.0, abs(one[key])):
                raise AssertionError(f"dryrun_multichip({n_devices}): {key} {r[key]} over the "
                                     f"ranks, {one[key]} in one process")
        for k, v in r["params"].items():
            if not torch.allclose(v, one["params"][k], rtol=1e-5, atol=1e-7):
                raise AssertionError(f"dryrun_multichip({n_devices}): {k} after the step "
                                     "differs from the one-process step")
    if model > 1 and not ranks[0]["split"]:
        raise AssertionError(f"dryrun_multichip({n_devices}): no weight split over the model axis")
    print(f"dryrun_multichip({n_devices}): data axis {n_devices // model} × model axis {model} "
          f"on {device} ({len(ranks[0]['split'])} weights split), stage-2 loss "
          f"{ranks[0]['loss']:.6f} (one process {one['loss']:.6f}), grad norm "
          f"{ranks[0]['grad_norm']:.6f} OK")
    return {"ranks": [{**{k: r[k] for k in ("loss", "grad_norm", "mesh", "split")},
                       "param_max_diff": max(float((v - one["params"][k]).abs().max())
                                             for k, v in r["params"].items())} for r in ranks],
            "one_process": {k: one[k] for k in ("loss", "grad_norm")}}
