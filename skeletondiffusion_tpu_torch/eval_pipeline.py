"""The evaluation path: observation → 50 sampled futures → metric space →
metric suite.

Port of ``skeletondiffusion_tpu/eval_pipeline.py`` (reference `eval.py:28-120`,
`src/eval_prepare_model.py:89-134`, `src/eval_utils.py:44-99`):

- ``SkeletonDiffusionPredictor`` (`:29-180`): past embedding (graph-GRU
  encoder) → S-fold fan-out → the engine's sampler (ancestral on the
  posterior-step kernel, or DDIM) → graph-GRU decode rollout (rollout
  kernel, or the plain decode).  With a bf16 denoiser that the kernel chain
  takes, the sampler runs the denoiser as its chain of kernels
  (``ops/kernels/denoiser_fused.py``) on operands prepared once here;
- ``ZeroVelocityPredictor`` (`:193`), the algorithmic baseline;
- ``process_evaluation_pair`` (`:212`) and the two long-term helpers
  (`:223`, `:281`);
- ``compute_metrics`` (`:315`), the eval loop over a dataset.
"""
from __future__ import annotations

import math
import os
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from . import sampler_noise
from .data.batch import DataLoader, prefetch_iterator, preprocess_batch
from .device import DeviceLike, resolve_device
from .diffusion.engine import GaussianDiffusion
from .metrics.multimodal import best_sample_index
from .metrics.suite import MetricSuite
from .models.autoencoder import AutoEncoder
from .ops.kernels.build import without_grad
from .ops.kernels.denoiser_fused import prep_fused_denoiser
from .parallel.mesh import DataMesh, all_gather_host, refuse_model_axis, shard_batch


class SkeletonDiffusionPredictor:
    """The trained model pair (AE + diffusion) as a prediction function.

    The sampler runs the fused kernel chain when the denoiser's
    ``compute_dtype`` is bfloat16 and the JAX predictor's conditions hold
    (`eval_pipeline.py:72-87`: attention, no self-conditioning, the
    conditioning hoisted), minus the TPU's shape limits; its weight operands
    are prepared once, at construction (re-preparing per call cost the JAX
    package 42 ms).  The chain serves every sampler of the engine (any
    process, objective and activation, DDIM), as the JAX predictor rebinds
    its denoiser for any process (`eval_pipeline.py:94-108`).
    ``use_fused_denoiser`` says whether it was prepared; otherwise the plain
    denoiser runs, in its dtype.

    Whether the sampler is conditioned on the past embedding is the
    engine's (``diffusion.condition``; the JAX predictor's
    ``diffusion_conditioning``, `eval_pipeline.py:43,154-157`): without it
    the sampler draws one latent per sample.  ``use_fused_decode``
    (`:44,54-66,164-177`): None decodes a GRU decoder on the float32
    rollout kernel and an LSTM one as the plain step loop, as the JAX
    predictor takes its fused rollout for a GRU decoder only; True asks for
    the kernel (an LSTM decoder raises); False runs the plain decode in the
    Decoder's compute dtype (``AutoEncoder.decode_plain``).

    On the GPU the float32 products must run in full fp32: set
    ``torch.backends.cuda.matmul.allow_tf32 = False`` and
    ``torch.backends.cudnn.allow_tf32 = False`` (PyTorch's defaults for
    matmuls, not for cuDNN) — TF32 keeps about three decimal digits.

    ``device`` (default ``"cuda"``) is where the modules are moved and the
    prediction runs; asking for CUDA without a GPU raises.  On the CPU the
    kernels run their plain PyTorch versions.
    """

    def __init__(
        self,
        skeleton,
        autoencoder: AutoEncoder,
        diffusion: GaussianDiffusion,
        num_samples: int = 50,
        pred_length: int = 100,
        use_fused_decode: Optional[bool] = None,
        device: DeviceLike = "cuda",
    ):
        self.device = resolve_device(device)
        self.skeleton = skeleton
        self.autoencoder = autoencoder.to(self.device).eval()
        self.diffusion = diffusion.to(self.device)
        den = diffusion.denoiser
        self.use_fused_denoiser = (den.compute_dtype == torch.bfloat16 and den.use_attention
                                   and not den.self_condition and diffusion.condition)
        if self.use_fused_denoiser:
            self.diffusion.fused = prep_fused_denoiser(den)
        self.diffusion_conditioning = diffusion.condition
        if use_fused_decode and not autoencoder.decodes_on_kernel:
            raise ValueError("use_fused_decode=True: the rollout kernel runs a graph-GRU "
                             "decoder, and this AutoEncoder's decoder is an LSTM")
        self.use_fused_decode = use_fused_decode is not False and autoencoder.decodes_on_kernel
        self.num_samples = num_samples
        self.pred_length = pred_length

    def draw_noise(self, generator: torch.Generator, batch: int,
                   num_samples: Optional[int] = None) -> Dict[str, torch.Tensor]:
        """The sampler noise of ``batch`` observations × ``num_samples``
        drawn from ``generator`` as a call would draw it, to inject
        (``GaussianDiffusion.draw_noise``)."""
        return self.diffusion.draw_noise(generator, batch * (num_samples or self.num_samples))

    @without_grad
    def __call__(
        self,
        generator: Optional[torch.Generator],
        obs: torch.Tensor,
        num_samples: Optional[int] = None,
        pred_length: Optional[int] = None,
        start_noise: Optional[torch.Tensor] = None,
        step_noise: Optional[torch.Tensor] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """obs [B,T,N,3] (input space) → (pred [B,S,T',N,3] input space,
        latents [B,S,N,D]).

        ``generator`` draws the sampler noise (a ``torch.Generator`` on the
        predictor's device); ``start_noise`` [B·S,N,D] and ``step_noise``
        [B·S,T-1,N,D] (DDIM: [B·S,S'-1,N,D] for S' sampling steps) inject it
        instead, as the JAX predictor's ``_predict`` takes them.
        """
        S = num_samples or self.num_samples
        ph = pred_length or self.pred_length
        obs = obs.to(self.device)
        B = obs.shape[0]
        x_cond = (self.autoencoder.get_past_embedding(obs).repeat_interleave(S, dim=0)
                  if self.diffusion_conditioning else None)
        latents, _ = self.diffusion.sample(x_cond, generator, start_noise, step_noise,
                                           batch_size=B * S)
        decode = self.autoencoder.decode if self.use_fused_decode else self.autoencoder.decode_plain
        pred = decode(obs[:, -2:].repeat_interleave(S, dim=0), latents, ph)
        pred = pred.reshape(B, S, ph, *pred.shape[2:])
        return pred, latents.reshape(B, S, *latents.shape[1:])


class ZeroVelocityPredictor:
    """Algorithmic baseline: repeat the last observed frame; reference
    `src/eval_prepare_algorithmic_baseline.py:5-13`.  ``device`` as the
    model predictor's."""

    def __init__(self, skeleton, num_samples: int = 50, pred_length: int = 100,
                 device: DeviceLike = "cuda"):
        self.device = resolve_device(device)
        self.skeleton = skeleton
        self.num_samples = num_samples
        self.pred_length = pred_length

    def draw_noise(self, generator, batch: int, num_samples: Optional[int] = None) -> Dict:
        """The baseline draws nothing."""
        return {}

    def __call__(self, generator: Optional[torch.Generator], obs: torch.Tensor,
                 num_samples: Optional[int] = None, pred_length: Optional[int] = None):
        S = num_samples or self.num_samples
        T = pred_length or self.pred_length
        last = obs.to(self.device)[:, None, -1:, :, :]
        return last.expand(obs.shape[0], S, T, *obs.shape[2:]), None


def process_evaluation_pair(skeleton, target: torch.Tensor, pred: torch.Tensor,
                            obs: torch.Tensor, mm_gt: Optional[torch.Tensor] = None):
    """Everything → metric space; reference `eval_prepare_model.py:124-134`."""
    target = skeleton.transform_to_metric_space(target)
    pred = skeleton.transform_to_metric_space(pred)
    obs = skeleton.transform_to_metric_space(obs)
    if mm_gt is not None:
        mm_gt = skeleton.transform_to_metric_space(mm_gt)
    return target, pred, obs, mm_gt


def _take_sample(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x[b, idx[b]] for every item b of [B, S, ...]."""
    return x[torch.arange(x.shape[0], device=x.device), idx]


def long_term_prediction_best_every50(
    predictor, skeleton, generator, obs, target_raw, num_samples: int,
    pred_length: int, long_term_factor: float, refeed_space: str = "input",
):
    """Recursive long-term prediction: predict S futures, keep the
    closest-to-GT, re-feed its tail; reference `eval_utils.py:44-68`.

    ``target_raw`` is input-space with at least
    ``int(long_term_factor · pred_length)`` frames.  The best sample is
    chosen by the reference's per-joint norm (``best_sample_index``).
    ``refeed_space``: ``"input"`` (default) re-feeds the input-space
    prediction — the JAX package's fix of the reference, which under
    RescalePose inflates each round's observation by pose_box_size;
    ``"metric"`` re-feeds the metric-space one, as the reference does
    (`eval_utils.py:63`).  ``generator`` draws every round's noise in turn.
    """
    if refeed_space not in ("input", "metric"):
        raise ValueError(f"refeed_space={refeed_space!r}")
    n_past = obs.shape[1]
    steps = math.ceil(long_term_factor)
    preds, targets = [], []
    new_obs = obs
    for idx in range(steps):
        pred, _ = predictor(generator, new_obs, num_samples=num_samples, pred_length=pred_length)
        if idx == steps - 1 and int(long_term_factor) != long_term_factor:
            keep = int(long_term_factor * pred_length) % pred_length
            pred = pred[..., :keep, :, :]
        tgt = target_raw[:, idx * pred_length : idx * pred_length + pred.shape[2]]
        tgt_m = skeleton.transform_to_metric_space(tgt)
        pred_m = skeleton.transform_to_metric_space(pred)
        best = best_sample_index(pred_m, tgt_m)
        best_pred_m = _take_sample(pred_m, best)
        best_pred = best_pred_m if refeed_space == "metric" else _take_sample(pred, best)
        preds.append(best_pred_m)
        targets.append(tgt_m)
        new_obs = best_pred[:, -n_past:]
    pred_m = torch.cat(preds, dim=1)[:, None].repeat(1, num_samples, 1, 1, 1)
    return torch.cat(targets, dim=1), pred_m


def long_term_prediction_best_first50(
    predictor, skeleton, generator, obs, target_raw, num_samples: int,
    pred_length: int, long_term_factor: float, refeed_space: str = "input",
):
    """Second long-term strategy: S futures once, then EVERY sample
    propagated autoregressively (one continuation each); reference
    `eval_utils.py:70-99`.  ``refeed_space`` as in
    :func:`long_term_prediction_best_every50` (the reference re-feeds the
    metric-space tensor here too, `eval_utils.py:95`)."""
    if refeed_space not in ("input", "metric"):
        raise ValueError(f"refeed_space={refeed_space!r}")
    n_past = obs.shape[1]
    steps = math.ceil(long_term_factor)
    preds, targets = [], []
    current = None  # [B,S,T,N,3] in the refeed space
    for idx in range(steps):
        if idx == 0:
            pred, _ = predictor(generator, obs, num_samples=num_samples, pred_length=pred_length)
        else:
            B, S = current.shape[:2]
            flat = current[:, :, -n_past:].reshape(B * S, n_past, *current.shape[3:])
            pred, _ = predictor(generator, flat, num_samples=1, pred_length=pred_length)
            pred = pred.reshape(B, S, pred_length, *pred.shape[3:])
        if idx == steps - 1 and int(long_term_factor) != long_term_factor:
            keep = int(long_term_factor * pred_length) % pred_length
            pred = pred[..., :keep, :, :]
        tgt = target_raw[:, idx * pred_length : idx * pred_length + pred.shape[2]]
        pred_m = skeleton.transform_to_metric_space(pred)
        preds.append(pred_m)
        targets.append(skeleton.transform_to_metric_space(tgt))
        current = pred_m if refeed_space == "metric" else pred
    return torch.cat(targets, dim=1), torch.cat(preds, dim=2)


def _to_host(values: Dict[str, torch.Tensor]):
    """Start copying ``values`` to the host: into pinned buffers with
    ``non_blocking`` copies and an event recorded after them on a CUDA
    device (read them after ``event.synchronize()``), as they are on the
    CPU.  Returns (host tensors, event or None)."""
    first = next(iter(values.values()))
    if first.device.type != "cuda":
        return values, None
    host = {}
    for k, v in values.items():
        host[k] = torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
        host[k].copy_(v, non_blocking=True)
    event = torch.cuda.Event()
    event.record()
    return host, event


def compute_metrics(
    predictor,
    dataset,
    skeleton,
    *,
    batch_size: int = 512,
    num_samples: int = 50,
    stats_mode: str = "probabilistic",
    seed: int = 0,
    if_compute_cmd: bool = False,
    if_compute_apde: bool = False,
    mmapd_gt_path: Optional[str] = None,
    if_long_term_test: bool = False,
    long_term_factor: float = 2.5,
    long_term_strategy: str = "best_every50",
    long_term_refeed_space: str = "input",
    pred_length: Optional[int] = None,
    if_noisy_obs: bool = False,
    noise_level: float = 0.25,
    noise_std: float = 0.02,
    store: Optional[Any] = None,
    timer: Optional[Any] = None,
    silent: bool = False,
    ndebug: bool = False,
    fid_classifier: Optional[torch.nn.Module] = None,
    mesh: Optional[DataMesh] = None,
    **config,
) -> Dict[str, float]:
    """The eval loop; reference `eval.py:28-120` (``compute_metrics``), as the
    JAX package's `eval_pipeline.py:315-572` runs it.

    Runs on the predictor's ``device``.  One ``torch.Generator`` there,
    seeded with ``seed``, draws the sampler's
    noise batch after batch; the noisy observation (``if_noisy_obs``: a
    share ``noise_level`` of the non-root joints perturbed with N(0, σ²),
    fresh per batch) draws from a second one seeded with ``seed + 1``, and
    FID's random GRU h0 from a third, ``seed + 2``.

    ``fid_classifier``: a ``metrics.fid.ClassifierForFID`` with the
    pretrained H36M weights (``port_classifier``) enables FID, as the
    reference attaches it for dataset=h36m (`config_metrics.py:83-87`).

    The final partial batch is padded to the full batch size (repeated
    items) and the pad rows are masked out of every accumulator.  The host
    stays one batch behind the device: batch i's values are copied into
    pinned memory behind an event while batch i + 1 is dispatched, and read
    after the event; ``SKELDIFF_EVAL_PIPELINE=0`` drains every batch before
    the next.

    ``mesh``: a data axis (``parallel.create_mesh``; the JAX package's
    ``mesh``).  Every rank loads and preprocesses each whole batch, draws its
    sampler noise (and FID's h0) for the whole batch from the generators
    above and keeps its rows; the predictor and the metrics run on the
    rank's rows, whose per-item values are gathered on the host
    (``parallel.all_gather_host``) into every rank's accumulators in
    dataset order.  So the result is the single-process one, on every rank.
    The batch size must split evenly over the axis; the long-term test and
    ``store`` are refused on it.
    """
    refuse_model_axis(mesh, "compute_metrics")
    if mesh is not None and (if_long_term_test or store is not None):
        raise NotImplementedError("compute_metrics over a data axis: the long-term test and "
                                  "store run in one process")
    if mesh is not None:
        mesh.rows(batch_size)
    if config and not silent:
        print(f"compute_metrics: ignoring unconsumed config keys: {sorted(config)}")
    device = predictor.device
    suite = MetricSuite(
        stats_mode=stats_mode,
        skeleton=skeleton,
        if_compute_cmd=if_compute_cmd,
        mean_motion_per_class=getattr(dataset, "mean_motion_per_class", None),
        if_compute_apde=if_compute_apde,
        mmapd_gt_path=mmapd_gt_path,
        if_consider_hip=skeleton.if_consider_hip,
    )
    fid_acc = None
    if fid_classifier is not None:
        from .metrics.accumulators import FIDAccumulator

        clf = fid_classifier.to(device).eval()
        fid_acc = FIDAccumulator()
        gen_fid = torch.Generator(device=device).manual_seed(seed + 2)

        @torch.no_grad()
        def fid_feats(pred_m, target_m):
            # [B,S,T,J,3] → [B·S, J·3, T]; [B,T,J,3] → [B, J·3, T]
            # (reference `fid.py:108-119`); a fresh random GRU h0 per batch,
            # as the reference protocol draws it (`fid_classifier.py:56-57`)
            B, S, T = pred_m.shape[:3]
            p = pred_m.reshape(B * S, T, -1).transpose(1, 2)
            g = target_m.reshape(target_m.shape[0], T, -1).transpose(1, 2)
            ranks = 1 if mesh is None else mesh.size  # the whole batch's h0, this rank's rows
            h0p, h0g = (torch.randn((clf.hidden_layer, n * ranks, clf.hidden_size),
                                    generator=gen_fid, device=device)
                        for n in (p.shape[0], g.shape[0]))
            if mesh is not None:
                h0p, h0g = (h[:, mesh.rank * n:(mesh.rank + 1) * n]
                            for h, n in ((h0p, p.shape[0]), (h0g, g.shape[0])))
            return {"fp": clf.get_fid_features(p, h0p), "fg": clf.get_fid_features(g, h0g)}
    # dedup_mm: the loader ships UNIQUE mm-GT futures + a gather table; the
    # dense [B,M,T,J,3] form only ever exists on the device.  mm_lazy: items
    # carry neighbor ids only and collate pulls each unique future once
    dataset.mm_lazy = True
    loader = DataLoader(dataset, batch_size=batch_size, shuffle=False, drop_last=False,
                        pad_last=True, dedup_mm=True)
    gen = torch.Generator(device=device).manual_seed(seed)
    gen_pre = torch.Generator(device=device).manual_seed(seed + 1) if if_noisy_obs else None
    ph = pred_length or dataset.pred_length
    # on the standard path the predictor rolls out its OWN pred_length; a
    # conflicting override would silently mismatch the target length (the
    # long-term branch below is the only consumer of ph)
    if (not if_long_term_test and pred_length is not None
            and getattr(predictor, "pred_length", None) not in (None, pred_length)):
        raise ValueError(
            f"pred_length={pred_length} conflicts with the predictor's "
            f"pred_length={predictor.pred_length}; rebuild the predictor "
            "or drop the override"
        )
    lt_fn = (long_term_prediction_best_first50 if long_term_strategy == "best_first50"
             else long_term_prediction_best_every50)

    def drain(pending):
        """Host-side accumulator updates of an already-dispatched batch."""
        if pending is None:
            return
        if pending["event"] is not None:
            pending["event"].synchronize()
        host = {k: v.numpy() for k, v in pending["host"].items()}
        if mesh is not None:  # every rank's rows, in dataset order
            parts = all_gather_host(mesh, host)
            host = {k: np.concatenate([part[k] for part in parts]) for k in host}
        c = pending["count"]
        suite.update({k: v for k, v in host.items() if k not in ("fp", "fg")},
                     class_idxs=pending["class_idxs"], count=c)
        if fid_acc is not None:
            # fp is [B·S, feat]: pad rows are the trailing (B-count)·S
            fid_acc.update(host["fp"][: c * num_samples], host["fg"][:c])

    pipelined = os.environ.get("SKELDIFF_EVAL_PIPELINE", "1") == "1"
    pending = None
    with torch.no_grad():
        for batch in prefetch_iterator(loader, device=device):
            if timer is not None:
                timer.start()
            count = int(batch["_count"])
            mm = batch.get("mm_gt")
            if mm is not None and batch.get("mm_idx") is not None:
                mm = mm[batch["mm_idx"].long()]  # unique rows → dense [B,M,T,J,3]
            obs, target, mm_gt = preprocess_batch(
                skeleton, gen_pre, batch["obs"], batch["pred"], mm, train=False,
                if_noisy_obs=if_noisy_obs, noise_level=noise_level, noise_std=noise_std,
            )
            if if_long_term_test:
                # the reference hard-codes best_every50 (`eval.py:21`);
                # best_first50 is selectable here by config
                target_m, pred_m = lt_fn(
                    predictor, skeleton, gen, obs, target, num_samples,
                    ph, long_term_factor, refeed_space=long_term_refeed_space,
                )
                mm_m = skeleton.transform_to_metric_space(mm_gt) if mm_gt is not None else None
                obs_m = skeleton.transform_to_metric_space(obs)
            elif mesh is not None:
                noise = predictor.draw_noise(gen, obs.shape[0], num_samples)
                lo, hi = mesh.rows(obs.shape[0])
                obs, target, mm_gt, mm_mask = shard_batch(
                    mesh, (obs, target, mm_gt, batch.get("mm_mask")))
                pred, _ = predictor(None, obs, num_samples=num_samples,
                                    **sampler_noise.rows_of(noise, lo * num_samples,
                                                            hi * num_samples))
                target_m, pred_m, obs_m, mm_m = process_evaluation_pair(
                    skeleton, target, pred, obs, mm_gt)
            else:
                pred, _ = predictor(gen, obs, num_samples=num_samples)
                target_m, pred_m, obs_m, mm_m = process_evaluation_pair(
                    skeleton, target, pred, obs, mm_gt)
            if mesh is None:
                mm_mask = batch.get("mm_mask")
            vals = suite.compute_batch(pred_m, target_m, mm_gt=mm_m, mm_mask=mm_mask)
            if fid_acc is not None:
                vals.update(fid_feats(pred_m, target_m))
            class_idxs = None
            if if_compute_cmd:
                class_idxs = np.asarray(
                    [dataset.class_to_idx[m[dataset.metadata_class_idx]]
                     for m in batch["metadata"]]
                )[:count]
            host, event = _to_host(vals)
            this = {"host": host, "event": event, "class_idxs": class_idxs, "count": count}
            if store is not None:
                # copied at once: holding the device tensors across the
                # pipelined iteration would keep two generations of the
                # largest tensors (pred_m) in device memory
                store.append(pred_m[:count].cpu().numpy(), obs=obs_m[:count].cpu().numpy(),
                             target=target_m[:count].cpu().numpy())
            if pipelined:
                drain(pending)
                pending = this
            else:
                drain(this)
            if timer is not None:
                timer.stop()
            if ndebug:
                break
    # time the trailing drain as its own interval: the interval sum then
    # equals the loop's wall time for any batch count
    if timer is not None and pending is not None:
        timer.start()
        drain(pending)
        timer.stop()
    else:
        drain(pending)
    results = suite.compute()
    if fid_acc is not None:
        results["FID"] = fid_acc.compute()
    return results
