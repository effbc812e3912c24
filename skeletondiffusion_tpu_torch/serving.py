"""Serving export: the prediction function captured as ``torch.export``
programs on disk that load and run without the model-construction code.

Port of ``skeletondiffusion_tpu/serving.py`` (``export_predictor``,
``ServingModel``).  The JAX package serializes one StableHLO module a batch
bucket plus a msgpack of the weights; here each bucket is one
``torch.export`` program (``predict_b{N}.pt2``) of the whole prediction —
past embedding → S-sample sampler → decode — with every weight inside it,
and ``manifest.json`` beside them.  Every kernel on the path is a node of
the program: the hand-written kernels are ``torch.library`` custom ops
(``skd::…``, ``ops/kernels/build.kernel_op``), so a loaded program launches
the same kernels, through the same wrappers and launch counters, as the
live predictor.

Each program maps ``(obs [B,T,N,3], start_noise [B·S,N,D], step_noise
[B·S,K,N,D]) → pred [B,S,T',N,3]``, all in input space.  The noise is an
input: ``torch.export`` captures no ``torch.Generator``.  ``ServingModel``
draws it from the caller's generator in the live sampler's order
(``sampler_noise.draw``), so one generator state gives the live predictor's
samples.  The same kernels run in the same order on the same values, so on
the card the served prediction equals the live one bit for bit (chip_smoke's
``serving`` phase); where BLAS picks another algorithm for another batch
size (a request padded to a larger bucket) it may differ in the last bits.

Loading imports only ``torch`` and the modules that register the ops (the
kernel wrappers; never ``models``, ``diffusion`` or ``eval_pipeline``).
Requests of any batch up to the largest bucket go to the smallest bucket
that fits; pad rows repeat the last observation (and the last row's noise)
and are sliced off.

Weight provenance: every tensor the path reads is a constant of each
program, and only those.  The fused bf16 path holds the denoiser's banks as
``prep_fused_denoiser`` cast them (``weights_baked_in_program`` in the
manifest, as JAX records it); there is no separate weights file, so any
weight change needs a new export.

With a data axis (``mesh``, ``parallel/mesh.py``) each bucket is exported at
its rows a rank, and each rank serves its rows of a request: it draws the
whole request's noise (the same generator state on every rank) and keeps its
rows, so the ranks' rows together are the single-process prediction.
"""
from __future__ import annotations

import json
import os
import time
from typing import Dict, List, Optional, Sequence, Union

import torch

from . import sampler_noise
from .device import DeviceLike, resolve_device
from .parallel.mesh import refuse_model_axis
# importing the kernel wrappers registers the skd:: ops the programs call
from .ops.kernels import (  # noqa: F401
    attention_proj, graph_linear_fused, gru_rollout, joint_attention, layer_fused,
    posterior_step, resnet_block,
)

MANIFEST_FILE = "manifest.json"
FORMAT_VERSION = 1


def program_file(batch: int) -> str:
    return f"predict_b{batch}.pt2"


class _Prediction(torch.nn.Module):
    """The predictor's call with injected noise as a module to export.  The
    predictor is a plain attribute, not a submodule: every tensor the path
    reads (weights, process tables, the fused operands) becomes a constant
    of the program, and those it does not read (the fp32 denoiser banks the
    bf16 chain replaces) stay out of the artifact."""

    def __init__(self, predictor, num_samples: int, pred_length: int):
        super().__init__()
        self.predict = predictor
        self.num_samples, self.pred_length = num_samples, pred_length

    def forward(self, obs, start_noise, step_noise):
        pred, _ = self.predict(None, obs, num_samples=self.num_samples,
                               pred_length=self.pred_length, start_noise=start_noise,
                               step_noise=step_noise)
        return pred


def _path(predictor) -> str:
    dtype = predictor.diffusion.denoiser.compute_dtype
    if not predictor.use_fused_denoiser:
        return "fp32" if dtype is None else f"{str(dtype).removeprefix('torch.')} plain"
    if os.environ.get("SKELDIFF_LAYER_FUSED", "0") == "1":
        return "bf16 layer-fused"
    return "bf16 chain"


def _buckets(batch_size: Union[int, Sequence[int]]) -> List[int]:
    sizes = sorted({int(b) for b in ((batch_size,) if isinstance(batch_size, int)
                                     else tuple(batch_size))})
    if not sizes or sizes[0] <= 0:
        raise ValueError(f"batch buckets must be positive, got {batch_size}")
    return sizes


def export_predictor(predictor, out_dir: str, batch_size: Union[int, Sequence[int]], *,
                     num_samples: Optional[int] = None, pred_length: Optional[int] = None,
                     mesh=None) -> str:
    """Export ``predictor`` (``eval_pipeline.SkeletonDiffusionPredictor``) to
    ``out_dir`` at each batch bucket of ``batch_size``; returns ``out_dir``.

    The programs are traced on the predictor's device with the environment
    as it stands (``SKELDIFF_LAYER_FUSED`` picks the kernel chain, recorded
    as ``path``).  ``mesh``: a data axis (``parallel.create_mesh``); every
    bucket must split evenly over it, and each program takes a rank's rows."""
    refuse_model_axis(mesh, "export_predictor")
    sizes = _buckets(batch_size)
    S = num_samples or predictor.num_samples
    ph = pred_length or predictor.pred_length
    sk, engine = predictor.skeleton, predictor.diffusion
    n, latent, draws = sk.num_nodes, engine.seq_length, engine.noise_draws
    ranks = 1 if mesh is None else mesh.size
    for b in sizes:
        if b % ranks:
            raise ValueError(f"bucket {b} does not split over the data axis of {ranks}")
    device = predictor.device
    module = _Prediction(predictor, S, ph).eval()
    os.makedirs(out_dir, exist_ok=True)
    seconds = {}
    for b in sizes:
        rows = b // ranks
        args = (torch.zeros((rows, sk.obs_length, n, 3), device=device),
                torch.zeros((rows * S, n, latent), device=device),
                torch.zeros((rows * S, draws, n, latent), device=device))
        t0 = time.perf_counter()
        # traced under no_grad, the predictor's own no_grad leaves no
        # grad-mode region in the program (such a region does not reload)
        with torch.no_grad():
            program = torch.export.export(module, args, strict=False)
        program.example_inputs = None  # the all-zero noise would go into the file
        torch.export.save(program, os.path.join(out_dir, program_file(b)))
        seconds[b] = time.perf_counter() - t0
    manifest = {
        "format_version": FORMAT_VERSION,
        "torch_version": torch.__version__,
        "device": device.type,
        "nodes": n,
        "batch_sizes": sizes,
        "num_samples": S,
        "pred_length": ph,
        "obs_tail_shape": [sk.obs_length, n, 3],
        "latent": latent,
        "noise_draws": draws,
        "dtype": str(engine.denoiser.compute_dtype or torch.float32).removeprefix("torch."),
        "path": _path(predictor),
        "fused_denoiser": bool(predictor.use_fused_denoiser),
        "fused_decode": bool(predictor.use_fused_decode),
        "layer_fused": os.environ.get("SKELDIFF_LAYER_FUSED", "0") == "1",
        # every weight is a constant of each program (module docstring)
        "weights_baked_in_program": True,
        "mesh": None if mesh is None else {"data": ranks},
        "export_seconds": seconds,
    }
    with open(os.path.join(out_dir, MANIFEST_FILE), "w") as f:
        json.dump(manifest, f, indent=2)
    return out_dir


class ServingModel:
    """A loaded serving artifact: ``model(generator, obs) → pred``.

    Needs torch and the kernel wrappers only.  ``device`` must be the one the
    artifact was exported for (``"cuda"`` by default; asking for CUDA without
    a GPU raises), ``nodes`` (if given) its node count, and ``mesh`` its data
    axis."""

    def __init__(self, artifact_dir: str, device: DeviceLike = "cuda", mesh=None,
                 nodes: Optional[int] = None):
        with open(os.path.join(artifact_dir, MANIFEST_FILE)) as f:
            self.manifest: Dict = json.load(f)
        if self.manifest.get("format_version") != FORMAT_VERSION:
            raise ValueError(f"unsupported artifact format: {self.manifest.get('format_version')}")
        self.device = resolve_device(device)
        if self.manifest["device"] != self.device.type:
            raise ValueError(f"the artifact was exported for {self.manifest['device']}, not "
                             f"{self.device.type}: export it on the device that serves it")
        if nodes is not None and nodes != self.manifest["nodes"]:
            raise ValueError(f"the artifact was exported for {self.manifest['nodes']} nodes, "
                             f"not {nodes}")
        refuse_model_axis(mesh, "ServingModel")
        exported = self.manifest.get("mesh")
        if (exported is None) != (mesh is None) or (
                mesh is not None and exported["data"] != mesh.size):
            raise ValueError(f"the artifact was exported for data axis {exported}; got "
                             f"{None if mesh is None else {'data': mesh.size}}: re-export with "
                             "export_predictor(..., mesh=mesh)")
        self.mesh = mesh
        self.batch_sizes: List[int] = list(self.manifest["batch_sizes"])
        self._programs = {
            b: torch.export.load(os.path.join(artifact_dir, program_file(b))).module()
            for b in self.batch_sizes}

    @property
    def batch_size(self) -> int:
        """The largest bucket."""
        return self.batch_sizes[-1]

    @property
    def num_samples(self) -> int:
        return self.manifest["num_samples"]

    def draw_noise(self, generator: torch.Generator, batch: int) -> Dict[str, torch.Tensor]:
        """The noise a live predictor call on ``batch`` observations draws
        from ``generator`` (``sampler_noise.draw``)."""
        m = self.manifest
        return sampler_noise.draw(generator, m["nodes"], batch * m["num_samples"], m["latent"],
                                  m["noise_draws"], self.device)

    def __call__(self, generator: Optional[torch.Generator], obs: torch.Tensor,
                 start_noise: Optional[torch.Tensor] = None,
                 step_noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """obs [B,T,N,3] in input space → pred [B,S,T',N,3] in input space
        (with a data axis: this rank's rows of it).  The noise is drawn from
        ``generator`` (on the artifact's device) unless both tensors are
        injected, as the live predictor takes them.  Requests that do not
        fit raise ValueError (not assert: serving hosts may run python -O)."""
        obs = torch.as_tensor(obs, dtype=torch.float32, device=self.device)
        tail = tuple(self.manifest["obs_tail_shape"])
        if tuple(obs.shape[1:]) != tail:
            raise ValueError(f"obs tail {tuple(obs.shape[1:])} != exported {tail}")
        B = obs.shape[0]
        if B == 0:
            raise ValueError("empty request: obs batch must be >= 1")
        fits = [b for b in self.batch_sizes if b >= B]
        if not fits:
            raise ValueError(f"batch {B} exceeds largest exported bucket {self.batch_size}")
        if (start_noise is None) != (step_noise is None):
            raise ValueError("inject both start_noise and step_noise, or neither")
        if start_noise is None:
            if generator is None:
                raise ValueError("pass a torch.Generator or inject the noise")
            noise = self.draw_noise(generator, B)
        else:
            noise = {"start_noise": start_noise.to(self.device),
                     "step_noise": step_noise.to(self.device)}
            m = self.manifest
            rows, n, d = B * m["num_samples"], m["nodes"], m["latent"]
            for key, want in (("start_noise", (rows, n, d)),
                              ("step_noise", (rows, m["noise_draws"], n, d))):
                if tuple(noise[key].shape) != want:
                    raise ValueError(f"{key} of shape {tuple(noise[key].shape)}, expected {want}")
        bucket, S = fits[0], self.num_samples
        if bucket != B:
            pad = bucket - B
            obs = torch.cat([obs, obs[-1:].expand(pad, *obs.shape[1:])])
            noise = {k: torch.cat([v, v[-1:].expand(pad * S, *v.shape[1:])])
                     for k, v in noise.items()}
        lo, hi = 0, bucket
        if self.mesh is not None:
            lo, hi = self.mesh.rows(bucket)
            obs = obs[lo:hi]
            noise = sampler_noise.rows_of(noise, lo * S, hi * S)
        with torch.no_grad():
            pred = self._programs[bucket](obs.contiguous(), noise["start_noise"].contiguous(),
                                          noise["step_noise"].contiguous())
        return pred[: max(0, min(hi, B) - lo)]
